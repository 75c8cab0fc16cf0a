"""The port's wide-feature warp (``accel_tpu_torch/ops/warp_onehot.py``)
against the one-hot Pallas kernel it replaces, run in interpret mode as the
JAX package's own tests run it. The CUDA kernel runs only on the card
(``chip_smoke.py`` holds it against the plain version there).

Tolerance: max|diff| <= 1e-5 * (1 + max|ref|) for f32 outputs, one bf16
ulp at max|ref| for bf16 outputs (the f32 sums may round to the other
neighbour)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nchw, nhwc

from accel_tpu.ops.warp_onehot import warp_onehot_fwd
from accel_tpu_torch.ops import warp_cuda as twc
from accel_tpu_torch.ops import warp_onehot as two
from accel_tpu_torch.ops.warp import bilinear_warp

torch.set_num_threads(2)
D = 4
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(shape, seed, flow_x=12.0, flow_y=6.0):
    """feat (N,H,W,C), flow with |dx| up to flow_x (past the image edge) and
    |dy| up to flow_y (past D), scale in [0.5, 1.5], gain (N,)."""
    rng = np.random.default_rng(seed)
    N, H, W, C = shape
    feat = rng.standard_normal(shape).astype(np.float32)
    flow = np.stack([rng.uniform(-flow_x, flow_x, (N, H, W)),
                     rng.uniform(-flow_y, flow_y, (N, H, W))], axis=-1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    gain = rng.uniform(0.5, 2.0, (N,)).astype(np.float32)
    return feat, flow, scale, gain


def _assert_matches(got: torch.Tensor, want, out_dtype: str) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = nhwc(got.float())
    peak = float(np.abs(want).max())
    bound = 1e-5 * (1 + peak) if out_dtype == "f32" else 2.0 ** (math.floor(math.log2(peak)) - 7)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"max|diff| {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("shape,feat_dt,w_dt,with_scale,with_gain", [
    ((1, 16, 32, 8), "f32", "f32", False, False),
    ((1, 16, 32, 8), "f32", "bf16", True, False),
    ((2, 16, 16, 4), "bf16", "bf16", True, False),
    ((2, 16, 16, 4), "bf16", "f32", False, False),
    ((4, 16, 16, 128), "f32", "bf16", True, True),
    ((4, 16, 16, 128), "bf16", "bf16", True, True),
])
def test_plain_matches_pallas_kernel(shape, feat_dt, w_dt, with_scale, with_gain):
    """|flow_y| up to 6 > D (clamped), |flow_x| up to 12 (not clamped, and
    past the image edge, where taps read 0)."""
    feat, flow, scale, gain = _case(shape, seed=sum(shape))
    (jf, tf), (jw, tw) = DTYPES[feat_dt], DTYPES[w_dt]
    s = scale if with_scale else None
    g = gain if with_gain else None
    want = warp_onehot_fwd(jnp.asarray(feat, jf), jnp.asarray(flow),
                           None if s is None else jnp.asarray(s, jf), max_disp=D,
                           weights_dtype=jw, interpret=True,
                           gain=None if g is None else jnp.asarray(g))
    got = two.warp_onehot_plain(nchw(feat).to(tf), nchw(flow),
                                None if s is None else nchw(s).to(tf), D,
                                None if g is None else torch.from_numpy(g), tw)
    assert got.dtype == tf and tuple(got.shape) == (shape[0], shape[3], *shape[1:3])
    _assert_matches(got, want, feat_dt)


def test_out_of_image_taps_read_zero():
    """dy = +3 everywhere: the last 3 rows sample below the image."""
    feat = np.ones((1, 16, 32, 4), np.float32)
    flow = np.zeros((1, 16, 32, 2), np.float32)
    flow[..., 1] = 3.0
    want = warp_onehot_fwd(jnp.asarray(feat), jnp.asarray(flow), max_disp=D,
                           weights_dtype=jnp.float32, interpret=True)
    got = two.warp_onehot_plain(nchw(feat), nchw(flow), None, D, None, torch.float32)
    _assert_matches(got, want, "f32")
    assert not got[0, :, -3:].any() and (got[0, :, :-3] == 1).all()


def test_dispatch_takes_onehot_before_width():
    """gather='onehot' goes to the one-hot warp at any width (19 channels
    here), not to the bounded warp that C <= 64 otherwise takes: the two
    differ where |flow_x| > D, which only the bounded warp clamps."""
    feat, flow, _, _ = _case((2, 16, 24, 19), seed=3)
    x, f = nchw(feat), nchw(flow)
    got = bilinear_warp(x, f, max_disp=D, gather="onehot")
    torch.testing.assert_close(got, two.warp_onehot_plain(x, f, None, D), rtol=0, atol=0)
    taps = bilinear_warp(x, f, max_disp=D)
    torch.testing.assert_close(taps, twc.warp_plain(x, f, D), rtol=0, atol=0)
    assert (got - taps).abs().max() > 0.5
    with pytest.raises(NotImplementedError, match="stacked"):
        bilinear_warp(x, f, max_disp=D, gather="stacked")


def test_cpu_tensors_take_the_plain_version():
    feat, flow, scale, gain = _case((2, 8, 16, 8), seed=4)
    x, f, s, g = nchw(feat), nchw(flow), nchw(scale), torch.from_numpy(gain)
    before = two.warp_onehot_cuda.launches
    out = two.warp_onehot(x, f, s, D, g)
    torch.testing.assert_close(out, two.warp_onehot_plain(x, f, s, D, g), rtol=0, atol=0)
    assert two.warp_onehot_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        two.warp_onehot_cuda(x, f, s, D, g)
    with pytest.raises(ValueError, match="gain requires scale"):
        two.warp_onehot_plain(x, f, None, D, g)
