"""The serving tail's two-pass formulation (``kernels/upsample_argmax.cu``)
on the CPU.

The kernel forms the horizontal lerps of an input row once at output width
and shares them with every output row whose vertical taps name that row,
then takes the vertical lerp and a running strict '>' over the classes. The
same computation, in the same float order, is built here from
``upscale_taps`` and held against the plain version (F.interpolate +
argmax) and against the TPU kernel (``accel_tpu``'s ``upsample_argmax`` in
interpret mode).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_argmax_agrees, nchw

from accel_tpu.ops.upsample import resize_bilinear as j_resize
from accel_tpu.ops.upsample_argmax import upsample_argmax as j_upsample_argmax
from accel_tpu.ops.upsample_argmax import upsample_argmax_or_oracle
from accel_tpu_torch.ops import upsample_argmax as tua

torch.set_num_threads(2)


def two_pass_argmax(logits: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """The kernel's computation: (N,C,h,w) f32 -> (N,H,W) uint8."""
    N, C, h, w = logits.shape
    H, W = out_hw
    i0x, i1x, l1x = tua.upscale_taps(w, W)
    # row pass: every input row's horizontal lerps at output width (N,C,h,W)
    rows = (1.0 - l1x) * logits[..., i0x] + l1x * logits[..., i1x]
    i0y, i1y, l1y = tua.upscale_taps(h, H)
    l0y, l1y = (1.0 - l1y)[:, None], l1y[:, None]
    best = torch.full((N, H, W), -torch.inf)
    arg = torch.zeros((N, H, W), dtype=torch.uint8)
    for c in range(C):
        # column pass: the vertical lerp of the two rows each output row names
        v = l0y * rows[:, c, i0y] + l1y * rows[:, c, i1y]
        take = v > best  # strict: the first maximal class wins
        best = torch.where(take, v, best)
        arg = torch.where(take, c, arg)
    return arg


CASES = [
    # (N, h, w, C), out_hw, the TPU kernel's row block
    ((2, 8, 16, 19), (128, 256), 64),    # x16, the serving ratio
    ((1, 45, 60, 19), (720, 960), 80),   # CamVid-sized map at stride 16
    ((3, 12, 20, 11), (128, 256), 128),  # non-integer ratio: bands change mid-run
    ((2, 1, 3, 5), (16, 24), 16),        # h=1: the clamped top and bottom rows share one band
    ((2, 2, 5, 7), (8, 40), 8),          # h=2: the clamped top rows share the interior band
]


@pytest.mark.parametrize("shape,out_hw,rb", CASES)
def test_two_pass_matches_plain(shape, out_hw, rb):
    logits = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    x = nchw(logits)
    got = two_pass_argmax(x, out_hw)
    want = tua.upsample_argmax_plain(x, out_hw)
    up = torch.nn.functional.interpolate(x, size=out_hw, mode="bilinear", align_corners=False)
    assert got.dtype == want.dtype and got.shape == want.shape
    # equal but at near-ties of the plain version's logits
    assert_argmax_agrees(got.numpy(), want.numpy(), up.movedim(1, -1).numpy(),
                         min_agree=0.9999)


@pytest.mark.parametrize("shape,out_hw,rb", CASES)
def test_two_pass_matches_pallas_kernel(shape, out_hw, rb):
    logits = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
    want = np.asarray(j_upsample_argmax(jnp.asarray(logits), out_hw, row_block=rb,
                                        interpret=True))
    got = two_pass_argmax(nchw(logits), out_hw)
    full = np.asarray(j_resize(jnp.asarray(logits), out_hw))
    assert_argmax_agrees(got.numpy(), want, full, min_agree=0.999)


def test_two_pass_shares_rows_within_a_band():
    """At x16 an input-row pair (a band) serves 16 consecutive output rows;
    the clamped top rows join the first band and the clamped bottom rows
    form one of 8. So the row pass the kernel keeps in registers is formed
    64 times per output column at 64 -> 1024, not 1024 times."""
    i0, i1, _ = tua.upscale_taps(64, 1024)
    pairs = torch.stack([i0, i1], dim=1)
    bands, runs = torch.unique_consecutive(pairs, dim=0, return_counts=True)
    assert len(bands) == 64
    assert runs[0] == 24 and runs[-1] == 8 and (runs[1:-1] == 16).all()
    # each band's i0 is the previous band's i1: one new input row per band
    assert (bands[1:, 0] == bands[:-1, 1]).all()


@pytest.mark.parametrize("out_hw", [(16, 24), (20, 30)], ids=["half", "non-integer"])
def test_plain_downscale_matches_the_oracle(out_hw):
    """On a downscale the plain version resizes as ``resize_bilinear`` does
    (antialiased, like ``jax.image.resize``), so its class map is the JAX
    oracle's but at near-ties."""
    logits = np.random.default_rng(13).standard_normal((2, 32, 48, 19)).astype(np.float32)
    want = np.asarray(upsample_argmax_or_oracle(jnp.asarray(logits), out_hw))
    got = tua.upsample_argmax_plain(nchw(logits), out_hw)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, *out_hw)
    full = np.asarray(j_resize(jnp.asarray(logits), out_hw))
    assert_argmax_agrees(got.numpy(), want, full, min_agree=0.999)


@pytest.mark.parametrize("shape,out_hw", [((2, 19, 8, 16), (128, 256)),
                                          ((1, 19, 45, 60), (720, 960))])
def test_plain_upscale_is_interpolate_then_argmax(shape, out_hw):
    """Upscales are unchanged: exactly F.interpolate's bilinear + argmax."""
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(shape).astype(np.float32))
    up = torch.nn.functional.interpolate(x, size=out_hw, mode="bilinear", align_corners=False)
    assert torch.equal(tua.upsample_argmax_plain(x, out_hw), up.argmax(dim=1).to(torch.uint8))
