"""The port's dilated 3x3 conv (``accel_tpu_torch/ops/dilated_cuda.py``)
and the ``dilated_conv`` routing of its ResNet blocks and DeepLab against
the fused-tap Pallas kernel it replaces, run in interpret mode as the JAX
package's own tests run it, and against the flax modules with the same
bridged weights. The CUDA kernel runs only on the card (``chip_smoke.py``
holds it against ``F.conv2d`` there). f32 on both sides; tolerance 2e-4 as
in ``tests/test_dilated_pallas.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, nchw, nhwc, seeded_variables

from accel_tpu.models import deeplab as jdeeplab
from accel_tpu.models import resnet as jresnet
from accel_tpu.ops.dilated_pallas import _eligible, pallas_conv_general_dilated
from accel_tpu_torch.convert import load_flax_variables
from accel_tpu_torch.models.deeplab import DeepLab
from accel_tpu_torch.models.resnet import BasicBlock, Bottleneck, DilatedConv3x3
from accel_tpu_torch.ops import dilated_cuda as tdc

torch.set_num_threads(2)
F32 = dict(device="cpu", dtype=torch.float32)


def _conv_case(shape, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3, 3, shape[-1], cout)) / np.sqrt(9 * shape[-1])).astype(np.float32)
    return x, k


def _oihw(k: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


# the shapes of tests/test_dilated_pallas.py, including d == 8 (the kernel's
# row block): all reach the Pallas kernel, not the lax fallback
@pytest.mark.parametrize("b,h,w_,ci,co,d", [
    (1, 16, 32, 128, 128, 2),
    (2, 16, 32, 256, 128, 4),
    (1, 24, 32, 128, 256, 6),
    (1, 16, 16, 128, 128, 8),
])
def test_plain_matches_pallas_kernel(b, h, w_, ci, co, d):
    x, k = _conv_case((b, h, w_, ci), co, seed=d)
    assert _eligible(jnp.asarray(x), jnp.asarray(k), d)
    want = np.asarray(pallas_conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), [(d, d), (d, d)], rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = nhwc(tdc.conv3x3_dilated_plain(nchw(x), _oihw(k), d))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def _routed(model) -> list[str]:
    return [name for name, m in model.named_modules() if isinstance(m, DilatedConv3x3)]


@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
def test_block_routing_matches_flax(kind):
    """A dilated stage's block under dilated_conv='pallas': its 3x3 convs
    are routed (1x1s are not), and it matches the flax block, whose hook
    sends the same convs to the Pallas kernel."""
    if kind == "basic":
        jm = jresnet.BasicBlock(width=128, dilation=2, dtype=jnp.float32, dilated_conv="pallas")
        tm = BasicBlock(128, 128, 1, 2, dilated_conv="pallas", **F32)
        x = np.random.default_rng(4).standard_normal((1, 16, 32, 128)).astype(np.float32)
        routed = ["conv1", "conv2"]
    else:
        jm = jresnet.Bottleneck(width=128, dilation=2, dtype=jnp.float32, dilated_conv="pallas")
        tm = Bottleneck(512, 128, 1, 2, dilated_conv="pallas", **F32)
        x = np.random.default_rng(5).standard_normal((1, 16, 32, 512)).astype(np.float32)
        routed = ["conv2"]
    v = seeded_variables(jm, jnp.asarray(x), seed=6)
    load_flax_variables(tm, v)
    assert _routed(tm) == routed
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert_close(got, want, rel=2e-4)


@pytest.fixture(scope="module")
def deeplab_vars():
    """R18 DeepLab at 256x256 (16x16 features), head 128: fc6 (512 -> 128,
    d=6) and layer4's d=2 convs are all shapes the Pallas kernel takes."""
    jm = jdeeplab.DeepLab(depth=18, head_channels=128, dtype=jnp.float32)
    x = (np.random.default_rng(7).standard_normal((1, 256, 256, 3)) * 0.5).astype(np.float32)
    return x, seeded_variables(jm, jnp.asarray(x), seed=7)


@pytest.mark.parametrize("mode,routed", [
    ("pallas", ["backbone.layer4_block0.conv1", "backbone.layer4_block0.conv2",
                "backbone.layer4_block1.conv1", "backbone.layer4_block1.conv2", "head.fc6"]),
    ("pallas_fc6", ["head.fc6"]),
])
def test_deeplab_routing_matches_flax(deeplab_vars, mode, routed):
    x, v = deeplab_vars
    jm = jdeeplab.DeepLab(depth=18, head_channels=128, dtype=jnp.float32, dilated_conv=mode)
    tm = DeepLab(18, head_channels=128, dilated_conv=mode, **F32)
    load_flax_variables(tm, v)  # routing keeps every state_dict key
    assert _routed(tm) == routed
    fc6 = jax.eval_shape(lambda: jm.apply(v, jnp.asarray(x), mode="features"))
    assert fc6.shape == (1, 16, 16, 128)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert_close(got, want, rel=2e-4)


def test_cpu_tensors_take_the_plain_version():
    x, k = _conv_case((1, 8, 16, 16), 8, seed=9)
    tx, tw = nchw(x), _oihw(k)
    before = tdc.conv3x3_dilated_cuda.launches
    torch.testing.assert_close(tdc.conv3x3_dilated(tx, tw, 3),
                               tdc.conv3x3_dilated_plain(tx, tw, 3), rtol=0, atol=0)
    conv = DilatedConv3x3(16, 8, 3, bias=True, **F32)
    with torch.no_grad():
        conv.weight.copy_(tw)
        conv.bias.uniform_(-1, 1)
        torch.testing.assert_close(conv(tx), torch.nn.functional.conv2d(
            tx, tw, conv.bias, padding=3, dilation=3))
    assert tdc.conv3x3_dilated_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tdc.conv3x3_dilated_cuda(tx, tw, 3)


def _per_tap_gemms(x: torch.Tensor, packed: torch.Tensor, d: int) -> torch.Tensor:
    """The conv as the kernel computes it: per tap 3i+j, the (Cout x Cin)
    slab of the packed weights times x shifted by ((i-1)d, (j-1)d) with
    zeros outside the image, summed over the nine taps."""
    N, Cin, H, W = x.shape
    xp = torch.nn.functional.pad(x, (d, d, d, d))
    out = 0
    for tap in range(9):
        i, j = divmod(tap, 3)
        shifted = xp[:, :, i * d:i * d + H, j * d:j * d + W].reshape(N, Cin, H * W)
        out = out + packed[tap] @ shifted
    return out.reshape(N, -1, H, W)


@pytest.mark.parametrize("b,h,w_,ci,co,d", [
    (1, 16, 32, 128, 128, 2),
    (1, 24, 32, 128, 256, 6),
])
def test_pack_dilated_weight_layout(b, h, w_, ci, co, d):
    """pack_dilated_weight's (9, Cout, Cin) slabs in nine shifted GEMMs
    are the conv: against the plain version and the Pallas kernel."""
    x, k = _conv_case((b, h, w_, ci), co, seed=20 + d)
    packed = tdc.pack_dilated_weight(_oihw(k))
    assert packed.shape == (9, co, ci) and packed.is_contiguous()
    got = nhwc(_per_tap_gemms(nchw(x), packed, d))
    np.testing.assert_allclose(got, nhwc(tdc.conv3x3_dilated_plain(nchw(x), _oihw(k), d)),
                               atol=2e-4, rtol=2e-4)
    want = np.asarray(pallas_conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), [(d, d), (d, d)], rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_packed_weight_follows_the_weight():
    """DilatedConv3x3 packs its weights once per weight version: the same
    tensor while the weight is unchanged, a fresh packing after an
    in-place copy_ or a load_state_dict."""
    conv = DilatedConv3x3(16, 8, 2, **F32)
    first = conv.packed_weight()
    torch.testing.assert_close(first, tdc.pack_dilated_weight(conv.weight.detach()))
    assert conv.packed_weight() is first
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=torch.Generator().manual_seed(1)))
    second = conv.packed_weight()
    assert second is not first
    torch.testing.assert_close(second, tdc.pack_dilated_weight(conv.weight.detach()))
    state = {"weight": torch.randn(conv.weight.shape, generator=torch.Generator().manual_seed(2))}
    conv.load_state_dict(state)
    torch.testing.assert_close(conv.packed_weight(), tdc.pack_dilated_weight(state["weight"]))
    assert set(conv.state_dict()) == {"weight"}

