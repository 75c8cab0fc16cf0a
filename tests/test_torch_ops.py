"""PyTorch port ops vs the JAX package: resize, warp, upsample+argmax and
the fused stem. The CUDA kernels run only on the card (``chip_smoke.py``
holds each against its plain version there); here the plain versions are
held against the JAX functions, and the Pallas kernels run in interpret
mode as the JAX package's own tests run them."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_argmax_agrees, assert_close, nchw, nhwc

from accel_tpu.ops import fused_stem as jfs
from accel_tpu.ops.upsample import resize_bilinear as j_resize
from accel_tpu.ops.upsample_argmax import resize_matrix as j_resize_matrix
from accel_tpu.ops.upsample_argmax import upsample_argmax as j_upsample_argmax
from accel_tpu.ops.warp import bilinear_warp_xla, flow_to_feature_res as j_flow_to_feature_res
from accel_tpu.ops.warp_pallas import warp_pallas_fwd
from accel_tpu_torch.models.resnet import DilatedResNet
from accel_tpu_torch.ops import fused_stem as tfs
from accel_tpu_torch.ops import upsample_argmax as tua
from accel_tpu_torch.ops import warp_cuda as twc
from accel_tpu_torch.ops.upsample import resize_bilinear
from accel_tpu_torch.ops.warp import bilinear_warp, bilinear_warp_plain, flow_to_feature_res

torch.set_num_threads(2)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((8, 12), (16, 24)),      # x2 up
    ((4, 8), (64, 128)),      # x16 up (the serving tail's ratio)
    ((32, 48), (16, 24)),     # /2 down (downscale_for_flow)
    ((32, 64), (8, 16)),      # /4 down
    ((16, 32), (5, 11)),      # non-integer down
])
def test_resize_bilinear_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(0).standard_normal((2, *in_hw, 3)).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), out_hw))
    got = nhwc(resize_bilinear(nchw(x), out_hw))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("out_hw", [(16, 32), (13, 27)], ids=["half", "non-integer"])
def test_resize_bilinear_downscales_bf16_on_the_cpu(out_hw):
    """A bf16 CPU downscale (the DFF scale field under ``warp_dtype:
    native``) resizes in f32 and rounds once, within one bf16 ulp at max|ref|
    of the JAX resize of the same bf16 input (which rounds at other points
    inside the resize)."""
    x = np.random.default_rng(5).standard_normal((1, 32, 64, 32)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(j_resize(xb, out_hw).astype(jnp.float32))
    got = resize_bilinear(nchw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16), out_hw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1, 32, *out_hw)
    peak = float(np.abs(want).max())
    err = float(np.abs(nhwc(got.float()) - want).max())
    assert err <= 2.0 ** (math.floor(math.log2(peak)) - 7), (err, peak)


def test_flow_to_feature_res_matches_jax():
    # FlowNet's H/8 output onto the H/16 feature grid, units 2/16
    flow = np.random.default_rng(1).standard_normal((2, 16, 32, 2)).astype(np.float32) * 5
    want = np.asarray(j_flow_to_feature_res(jnp.asarray(flow), (8, 16), 2 / 16))
    got = nhwc(flow_to_feature_res(nchw(flow), (8, 16), 2 / 16))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("n_in,n_out", [(8, 64), (16, 256), (45, 720), (12, 128)])
def test_resize_matrix_matches_jax(n_in, n_out):
    """The kernel's tap rule (upscale_taps) is jax.image.resize's."""
    np.testing.assert_allclose(tua.resize_matrix(n_in, n_out).numpy(),
                               np.asarray(j_resize_matrix(n_in, n_out)), atol=1e-6)


def test_upscale_taps_match_interpolate():
    """The same tap rule reproduces the plain version's F.interpolate."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 45, 60)).astype(np.float32))
    a, b = tua.resize_matrix(45, 720), tua.resize_matrix(60, 960)
    via_taps = a @ x @ b.T
    via_interp = torch.nn.functional.interpolate(x[None], size=(720, 960), mode="bilinear",
                                                 align_corners=False)[0]
    np.testing.assert_allclose(via_taps.numpy(), via_interp.numpy(), atol=1e-5)


def _warp_case(seed, flow_amp):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((2, 16, 24, 19)).astype(np.float32)
    flow = rng.uniform(-flow_amp, flow_amp, (2, 16, 24, 2)).astype(np.float32)
    return feat, flow


def test_warp_plain_matches_xla_oracle():
    feat, flow = _warp_case(3, 7.5)  # |flow| < D: the clamp is inactive
    want = np.asarray(bilinear_warp_xla(jnp.asarray(feat), jnp.asarray(flow)))
    np.testing.assert_allclose(nhwc(bilinear_warp_plain(nchw(feat), nchw(flow))), want,
                               atol=1e-5)
    np.testing.assert_allclose(nhwc(twc.warp_plain(nchw(feat), nchw(flow), 8)), want,
                               atol=1e-5)


def test_warp_clamp_matches_pallas_kernel():
    """|flow| up to 2D: the ±D clamp on both axes, as the TPU kernel does."""
    feat, flow = _warp_case(4, 16.0)
    want = np.asarray(warp_pallas_fwd(jnp.asarray(feat), jnp.asarray(flow), max_disp=8,
                                      interpret=True))
    got = nhwc(twc.warp_plain(nchw(feat), nchw(flow), 8))
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the unclamped oracle differs there: the clamp is what is being pinned
    oracle = np.asarray(bilinear_warp_xla(jnp.asarray(feat), jnp.asarray(flow)))
    assert np.abs(oracle - want).max() > 0.5


@pytest.mark.parametrize("shape", [(1, 15, 19, 9), (2, 7, 33, 19)])
def test_warp_clamp_matches_pallas_kernel_ragged(shape):
    """Sizes off every tile (the kernel's 32-wide x strips and 4-channel
    chunks, the TPU kernel's blocks), |flow| up to 2D on both axes."""
    rng = np.random.default_rng(13)
    feat = rng.standard_normal(shape).astype(np.float32)
    flow = rng.uniform(-16.0, 16.0, (*shape[:3], 2)).astype(np.float32)
    want = np.asarray(warp_pallas_fwd(jnp.asarray(feat), jnp.asarray(flow), max_disp=8,
                                      interpret=True))
    got = nhwc(twc.warp_plain(nchw(feat), nchw(flow), 8))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_warp_dispatch_by_width():
    """C <= 64 takes the bounded warp; wider maps the unbounded gather."""
    feat, flow = _warp_case(5, 16.0)
    x, f = nchw(feat), nchw(flow)
    torch.testing.assert_close(bilinear_warp(x, f, max_disp=8), twc.warp_plain(x, f, 8))
    torch.testing.assert_close(bilinear_warp(x, f, use_pallas=False, max_disp=8),
                               bilinear_warp_plain(x, f))
    wide = x.repeat(1, 4, 1, 1)  # 76 channels
    torch.testing.assert_close(bilinear_warp(wide, f, max_disp=8),
                               bilinear_warp_plain(wide, f))


def test_warp_plain_bf16_accumulates_f32():
    feat, flow = _warp_case(6, 7.5)
    out = twc.warp_plain(nchw(feat).to(torch.bfloat16), nchw(flow), 8)
    assert out.dtype == torch.bfloat16
    ref = twc.warp_plain(nchw(feat).to(torch.bfloat16).float(), nchw(flow), 8)
    torch.testing.assert_close(out.float(), ref.to(torch.bfloat16).float())


@pytest.mark.parametrize("shape,out_hw,rb", [
    ((2, 8, 16, 19), (128, 256), 64),    # x16 (the serving ratio)
    ((1, 12, 20, 11), (128, 256), 128),  # non-integer ratio, CamVid classes
])
def test_upsample_argmax_plain_matches_pallas_kernel(shape, out_hw, rb):
    logits = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    want = np.asarray(j_upsample_argmax(jnp.asarray(logits), out_hw, row_block=rb,
                                        interpret=True))
    got = tua.upsample_argmax_plain(nchw(logits), out_hw)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (shape[0], *out_hw)
    full = np.asarray(j_resize(jnp.asarray(logits), out_hw))
    assert_argmax_agrees(got.numpy(), want, full, min_agree=0.999)


def test_upsample_argmax_first_max_wins():
    plane = torch.ones((1, 1, 8, 16))
    logits = torch.cat([plane * 0.5, plane, plane, plane * 0.2], dim=1)
    assert (tua.upsample_argmax(logits, (64, 128)) == 1).all()


def _stem_case(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((7, 7, 3, 64)) * 0.1).astype(np.float32)
    inv = rng.uniform(0.5, 1.5, (64,)).astype(np.float32)
    shift = (rng.standard_normal((64,)) * 0.1).astype(np.float32)
    return x, k, inv, shift


@pytest.mark.parametrize("shape", [(2, 32, 64, 3), (1, 30, 34, 3)])
def test_fused_stem_plain_matches_pallas_kernel(shape):
    x, k, inv, shift = _stem_case(8, shape)
    jargs = [jnp.asarray(a) for a in (x, k, inv, shift)]
    ours = nhwc(tfs.fused_stem_plain(nchw(x), torch.from_numpy(k).permute(3, 2, 0, 1),
                                     torch.from_numpy(inv), torch.from_numpy(shift)))
    kern = np.asarray(jfs.fused_stem_fwd(*jargs, row_block=4, interpret=True))
    np.testing.assert_allclose(ours, kern, atol=1e-4)
    np.testing.assert_allclose(ours, np.asarray(jfs._oracle(*jargs)), atol=1e-4)


def test_fused_stem_rounds_weights_to_input_dtype():
    """bf16 x with f32 weights: the reference kernel rounds the weights to
    x's dtype before the conv, and so does the plain version. The outputs
    then differ only by the f32 sum order: >= 99.9% equal, none by more
    than one bf16 ulp at max|ref|."""
    x, k, inv, shift = _stem_case(10, (1, 32, 32, 3))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jfs.fused_stem_fwd(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                                         jnp.asarray(k), jnp.asarray(inv), jnp.asarray(shift),
                                         row_block=4, interpret=True).astype(jnp.float32))
    got = nhwc(tfs.fused_stem_plain(xb.movedim(-1, 1), torch.from_numpy(k).permute(3, 2, 0, 1),
                                    torch.from_numpy(inv), torch.from_numpy(shift)).float())
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert (got == want).mean() >= 0.999
    assert np.abs(got - want).max() <= ulp


def _stem_im2col(x: torch.Tensor) -> torch.Tensor:
    """(N,3,H,W) -> (N*Ho*Wo, STEM_K) patches in the bf16 kernel's K order:
    column (c*7 + ky)*8 + kx' holds x[c, 2oy - 3 + ky, 2ox - 4 + kx'] (the
    kernel's staged input columns), zero outside the image; the last 8
    columns are zero."""
    N, _, H, W = x.shape
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    xp = torch.nn.functional.pad(x, (4, 4, 3, 3))
    cols = [xp[:, c, ky:ky + 2 * Ho:2, kx:kx + 2 * Wo:2]
            for c in range(3) for ky in range(7) for kx in range(8)]
    cols += [torch.zeros_like(cols[0])] * (tfs.STEM_K - len(cols))
    return torch.stack(cols, dim=-1).reshape(N * Ho * Wo, tfs.STEM_K), (N, Ho, Wo)


@pytest.mark.parametrize("shape", [(2, 32, 64, 3), (1, 30, 34, 3), (1, 17, 23, 3)])
def test_pack_stem_weight_order(shape):
    """The packed (K, 64) operand times the kernel's im2col is the stem:
    pins the K order (c, ky, kx + 1), the zero tap kx' = 0 and the zero
    pad rows the tensor-core kernel relies on."""
    x, k, inv, shift = _stem_case(11, shape)
    w = torch.from_numpy(k).permute(3, 2, 0, 1)
    packed = tfs.pack_stem_weight(w)
    assert packed.shape == (tfs.STEM_K, 64) and packed.is_contiguous()
    rows = packed.view(-1, 64)[:168].view(3, 7, 8, 64)
    assert not rows[:, :, 0].any() and not packed[168:].any()
    patches, (N, Ho, Wo) = _stem_im2col(nchw(x))
    y = (patches @ packed).view(N, Ho, Wo, 64) * torch.from_numpy(inv) + torch.from_numpy(shift)
    got = torch.relu(y).numpy()
    ref = nhwc(tfs.fused_stem_plain(nchw(x), w, torch.from_numpy(inv), torch.from_numpy(shift)))
    assert_close(got, ref, rel=1e-5)
    if shape[1] % 2 == 0 and shape[2] % 2 == 0:  # the Pallas kernel takes even H, W
        jargs = [jnp.asarray(a) for a in (x, k, inv, shift)]
        assert_close(got, np.asarray(jfs.fused_stem_fwd(*jargs, row_block=4, interpret=True)),
                     rel=1e-5)


def test_stem_kernel_weight_is_packed_once_per_version():
    """The model keeps the stem kernel's packed weights and packs again
    only after the weight is written in place (or for another dtype)."""
    net = DilatedResNet(18, stem="fused7", device="cpu", dtype=torch.float32)
    w = net.conv1.weight
    first = net._stem_packed(w, torch.bfloat16)
    assert first.dtype == torch.bfloat16 and first.shape == (tfs.STEM_K, 64)
    torch.testing.assert_close(first, tfs.pack_stem_weight(w.detach().to(torch.bfloat16)))
    assert net._stem_packed(w, torch.bfloat16) is first
    with torch.no_grad():
        w.mul_(2.0)
    torch.testing.assert_close(net._stem_packed(w, torch.bfloat16),
                               tfs.pack_stem_weight(w.detach().to(torch.bfloat16)))
    torch.testing.assert_close(net._stem_packed(w, torch.float32), w.detach().permute(1, 2, 3, 0))


def test_cpu_tensors_take_the_plain_versions():
    """Dispatch is by device: CPU tensors never reach a launcher, and the
    launchers refuse CPU tensors instead of substituting anything."""
    feat, flow = _warp_case(9, 4.0)
    x, k, inv, shift = _stem_case(9, (1, 16, 16, 3))
    w = torch.from_numpy(k).permute(3, 2, 0, 1)
    before = (twc.warp_cuda.launches, tua.upsample_argmax_cuda.launches,
              tfs.fused_stem_cuda.launches)
    twc.warp(nchw(feat), nchw(flow), 8)
    tua.upsample_argmax(nchw(feat), (32, 48))
    tfs.fused_stem(nchw(x), w, torch.from_numpy(inv), torch.from_numpy(shift))
    assert (twc.warp_cuda.launches, tua.upsample_argmax_cuda.launches,
            tfs.fused_stem_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        twc.warp_cuda(nchw(feat), nchw(flow), 8)
    with pytest.raises(ValueError, match="CUDA"):
        tua.upsample_argmax_cuda(nchw(feat), (32, 48))
    with pytest.raises(ValueError, match="CUDA"):
        tfs.fused_stem_cuda(nchw(x), w, torch.from_numpy(inv), torch.from_numpy(shift))
