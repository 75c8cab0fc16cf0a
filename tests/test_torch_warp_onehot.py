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
    # 'stacked' names the unbounded form only: a narrow map still takes the
    # bounded warp, as on a TPU
    stacked = bilinear_warp(x, f, max_disp=D, gather="stacked")
    torch.testing.assert_close(stacked, taps, rtol=0, atol=0)
    with pytest.raises(ValueError, match="gather"):
        bilinear_warp(x, f, max_disp=D, gather="scattered")


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


def staged_warp(feat, flow, scale, max_disp, gain, weights_dtype, rows, chunk):
    """``kernels/warp_onehot.cu``'s computation, in its order: per frame, a
    band of ``rows`` output rows and a chunk of ``chunk`` channels at a
    time, the source window (the band's rows and ``halo`` rows on each side,
    16 bytes of zero columns on each side, zero rows outside the image) is
    staged; each pixel's tap column is clamped into [-2, W], where only zero
    columns are read, and its four taps are summed in f32 in the order 00,
    01, 10, 11, then scaled by ``f32(scale) * gain[n]``."""
    N, C, H, W = feat.shape
    f32 = torch.float32
    d = float(max_disp)
    halo, pad = math.ceil(d), 16 // feat.element_size()
    width, win_rows = W + 2 * pad, rows + 2 * halo + 1
    src = feat.to(weights_dtype).to(f32)
    out = torch.empty_like(feat)
    for n in range(N):
        for r0 in range(0, H, rows):
            ys = torch.arange(r0, min(r0 + rows, H))
            sy = ys.to(f32)[:, None] + flow[n, 1, ys].to(f32).clamp(-d, d)
            sx = torch.arange(W, dtype=f32)[None] + flow[n, 0, ys].to(f32)
            y0, x0 = torch.floor(sy), torch.floor(sx)
            wy, wx = sy - y0, sx - x0
            off = ((y0.to(torch.int64) - (r0 - halo)) * width
                   + x0.clamp(-2, W).to(torch.int64) + pad).flatten()
            taps = [(0, (1 - wy) * (1 - wx)), (1, (1 - wy) * wx),
                    (width, wy * (1 - wx)), (width + 1, wy * wx)]
            lo, hi = max(0, r0 - halo), min(H, r0 - halo + win_rows)
            for c0 in range(0, C, chunk):
                cn = min(chunk, C - c0)
                window = torch.zeros((chunk, win_rows, width), dtype=f32)
                window[:cn, lo - (r0 - halo):hi - (r0 - halo), pad:pad + W] = \
                    src[n, c0:c0 + cn, lo:hi]
                flat = window.reshape(chunk, -1)[:cn]
                acc = torch.zeros((cn, off.numel()), dtype=f32)
                for dt, w in taps:
                    acc = acc + flat[:, off + dt] * w.to(weights_dtype).to(f32).flatten()
                acc = acc.reshape(cn, len(ys), W)
                if scale is not None:
                    s = scale[n, c0:c0 + cn, ys].to(f32)
                    if gain is not None:
                        s = s * gain[n].to(f32)
                    acc = acc * s
                out[n, c0:c0 + cn, ys] = acc.to(feat.dtype)
    return out


@pytest.mark.parametrize("shape,feat_dt,w_dt,with_scale,with_gain,cut", [
    ((2, 13, 20, 11), "bf16", "bf16", True, False, None),   # plain-load staging
    ((2, 13, 32, 11), "bf16", "bf16", True, True, None),    # TMA staging
    ((1, 13, 20, 11), "f32", "bf16", True, True, (4, 4)),
    ((2, 9, 17, 5), "f32", "f32", False, False, (2, 2)),
    ((1, 13, 20, 11), "bf16", "f32", False, False, (1, 8)),
])
def test_staged_window_matches_plain_and_pallas_kernel(shape, feat_dt, w_dt, with_scale,
                                                       with_gain, cut):
    """Ragged sizes (H off the band, W off the 8-pixel vectors, C off the
    chunk), |flow_y| up to 6 > D and |flow_x| up to 12, past the edge: the
    staged formulation equals the plain version bit for bit and matches the
    Pallas kernel at this file's tolerance."""
    feat, flow, scale, gain = _case(shape, seed=sum(shape) + 7)
    (jf, tf), (jw, tw) = DTYPES[feat_dt], DTYPES[w_dt]
    x, f = nchw(feat).to(tf), nchw(flow)
    s = nchw(scale).to(tf) if with_scale else None
    g = torch.from_numpy(gain) if with_gain else None
    N, H, W, C = shape
    if cut is None:
        p = two.plan(N, C, H, W, float(D), x.element_size())
        assert p.tma == (W * x.element_size() % 16 == 0)
        cut = (p.rows, p.chunk)
    assert (H % cut[0] or cut[0] == 1) and C % cut[1]
    got = staged_warp(x, f, s, D, g, tw, *cut)
    plain = two.warp_onehot_plain(x, f, s, D, g, tw)
    assert got.dtype == plain.dtype and torch.equal(got, plain)
    want = warp_onehot_fwd(jnp.asarray(feat, jf), jnp.asarray(flow),
                           None if s is None else jnp.asarray(scale, jf), max_disp=D,
                           weights_dtype=jw, interpret=True,
                           gain=None if g is None else jnp.asarray(gain))
    _assert_matches(got, want, feat_dt)


def test_plan_fits_the_card():
    """The DFF shapes get 16-row bands of 4 channels in three TMA stages,
    with two blocks to an SM and the card filled at N=1 too;
    CamVid's 45x60 takes the plain-load staging; a window that cannot fit
    raises."""
    for N in (4, 1):
        p = two.plan(N, 1024, 64, 128, 4.0, 2)
        assert (p.tma, p.rows, p.chunk, p.stages, p.win_rows, p.width) == (
            True, 16, 4, 3, 25, 144)
        assert 2 * (p.smem + 1024) <= two.SMEM_PER_SM
        assert 2 * two.SMS >= p.grid[0] * p.grid[1] * p.grid[2] >= 2 * two.SMS * 0.9
        assert p.runs * p.run >= 1024 // 4 > (p.runs - 1) * p.run
    assert two.plan(4, 1024, 64, 128, 4.0, 4)[:4] == (True, 8, 4, 3)  # 256 threads a band
    assert not two.plan(4, 1024, 64, 128, 4.0, 2, aligned=False).tma
    assert not two.plan(2, 1024, 45, 60, 4.0, 2).tma
    with pytest.raises(ValueError, match="fits"):
        two.plan(1, 8, 64, 20000, 4.0, 4)


def test_plan_cuts_the_new_shapes():
    """The shapes composed propagation adds: DFF's final feature warp at
    D=4*(k-1)=16 (a 49-row window for a 16-row band) and the 2-channel f32
    flow fields it composes, at D=4 (DFF) and D=8."""
    p = two.plan(4, 1024, 64, 128, 16.0, 2)
    assert (p.tma, p.rows, p.win_rows) == (True, 16, 49) and p.chunk < 4
    assert 2 * (p.smem + 1024) <= two.SMEM_PER_SM
    assert p.runs * p.run * p.chunk >= 1024
    for d in (4.0, 8.0):
        q = two.plan(1, 2, 64, 128, d, 4)
        assert q.tma and q.win_rows == q.rows + 2 * int(d) + 1
        assert q.runs * q.run * q.chunk >= 2


@pytest.mark.parametrize("shape,feat_dt,with_scale", [
    ((1, 21, 32, 6), "bf16", True),    # the composed feature warp's bound
    ((2, 13, 20, 2), "f32", False),    # a composed flow field
])
def test_staged_window_at_the_composed_bound(shape, feat_dt, with_scale):
    """D=16 with |flow_y| up to 20 (clamped) and |flow_x| up to 24: the
    staged formulation equals the plain version bit for bit."""
    d = 16
    feat, flow, scale, _ = _case(shape, seed=sum(shape) + 11, flow_x=24.0, flow_y=20.0)
    tf = DTYPES[feat_dt][1]
    x, f = nchw(feat).to(tf), nchw(flow)
    s = nchw(scale).to(tf) if with_scale else None
    N, H, W, C = shape
    p = two.plan(N, C, H, W, float(d), x.element_size())
    got = staged_warp(x, f, s, d, None, torch.bfloat16, p.rows, p.chunk)
    assert torch.equal(got, two.warp_onehot_plain(x, f, s, d))
