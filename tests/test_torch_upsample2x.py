"""The exact 2x bilinear upsample (``ops/upsample.py::upsample2x``, kernel
``kernels/upsample2x.cu``) on the CPU, where its plain version
(``F.interpolate``) runs.

The kernel's arithmetic, spelled out here in its taps and order
(``kernel_order``: each input row's horizontal lerp, then the vertical
lerp of two rows, each weighted pair as ``fma(l0, u, l1 * v)``), equals
``F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)``
bit for bit. The CPU computes that function with two kernels: a generic
one, and for outputs with H + W <= 128 (a contiguous NCHW input) a
separable one whose f32 roundings are its own (a few ulps apart). Every
case is held to the generic kernel, reached on the input replicate-padded
on the right and bottom (the padded taps repeat the clamped edge's), and,
where ``F.interpolate`` runs the generic kernel on the tensor itself or the
dtype is bf16, to ``F.interpolate`` directly. Then the routing (by device,
shape, dtype, layout and ``plain``), the gradient, the ``torch.library``
op and FlowNet-S against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_parity import assert_close, nchw, nhwc, seeded_variables

from accel_tpu.models import flownet as jflownet
from accel_tpu_torch.convert import load_flax_variables
from accel_tpu_torch.models.accel import AccelNet
from accel_tpu_torch.models.flownet import FlowNetS
from accel_tpu_torch.ops import upsample as tup

torch.set_num_threads(2)


def _interpolate(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def upscale2x_taps(n):
    """Per-output-sample taps ``(i0, i1, l0, l1)`` of the half-pixel 2x
    upscale of an axis of ``n`` samples, as the kernel forms them:
    ``s = max(0.5 * (o + 0.5) - 0.5, 0)``, ``i0 = floor(s)``,
    ``i1 = min(i0 + 1, n - 1)``, ``l1 = s - i0``, ``l0 = 1 - l1``."""
    o = torch.arange(2 * n, dtype=torch.float32)
    s = (0.5 * (o + 0.5) - 0.5).clamp(min=0.0)
    i0 = s.to(torch.int64)
    i1 = (i0 + 1).clamp(max=n - 1)
    l1 = s - i0.to(torch.float32)
    return i0, i1, 1.0 - l1, l1


def _lerp2(l0, u, l1, v):
    """``fma(l0, u, l1 * v)`` in f32: the weights hold at most two
    significant bits, so ``l0 * u`` and the sum are exact in f64 here."""
    return torch.addcmul((l1 * v).double(), l0.double(), u.double()).float()


def kernel_order(x):
    """The kernel's arithmetic on NCHW ``x``, in x's dtype."""
    h, w = x.shape[-2:]
    r0, r1, h0, h1 = upscale2x_taps(h)
    c0, c1, w0, w1 = upscale2x_taps(w)
    xf = x.to(torch.float32)
    rows = _lerp2(w0, xf.index_select(-1, c0), w1, xf.index_select(-1, c1))
    out = _lerp2(h0[:, None], rows.index_select(-2, r0), h1[:, None], rows.index_select(-2, r1))
    return out.to(x.dtype)


def _generic_interpolate(x):
    """``F.interpolate``'s 2x upscale of ``x`` through the CPU's generic
    kernel: ``x`` padded by replicating its last row and column (output
    H + W > 128), cropped back."""
    h, w = x.shape[-2:]
    pad = F.pad(x.float(), (0, 64, 0, 64), mode="replicate").to(x.dtype)
    return _interpolate(pad)[..., :2 * h, :2 * w]


SHAPES = {
    # FlowNet-S's four feature resizes, channels cut (386, 770, 1026, 1024)
    "deconv2": (2, 6, 64, 128),
    "deconv3": (2, 6, 32, 64),
    "deconv4": (2, 6, 16, 32),
    "deconv5": (2, 6, 8, 16),
    # its flow resizes (upflow): two channels
    "flow6": (4, 2, 8, 16),
    "flow3": (4, 2, 64, 128),
    "h1": (2, 3, 1, 9),
    "w1": (2, 3, 9, 1),
    "h1w1": (2, 3, 1, 1),
    "h2w2": (2, 3, 2, 2),
    "h2": (1, 3, 2, 24),
    "ragged": (2, 3, 7, 13),
    "ragged_wide": (1, 2, 5, 70),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_order_equals_f_interpolate(name, dtype):
    shape = SHAPES[name]
    g = torch.Generator().manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g) * 3).to(dtype)
    got = kernel_order(x)
    assert got.dtype == dtype and tuple(got.shape) == (*shape[:2], 2 * shape[2], 2 * shape[3])
    assert torch.equal(got, _generic_interpolate(x))
    if dtype == torch.bfloat16 or 2 * (shape[2] + shape[3]) > 128:
        assert torch.equal(got, _interpolate(x))


def test_taps_are_the_half_pixel_ones():
    i0, i1, l0, l1 = upscale2x_taps(3)
    assert i0.tolist() == [0, 0, 0, 1, 1, 2] and i1.tolist() == [1, 1, 1, 2, 2, 2]
    assert l0.tolist() == [1.0, 0.75, 0.25, 0.75, 0.25, 0.75]
    assert l1.tolist() == [0.0, 0.25, 0.75, 0.25, 0.75, 0.25]


@pytest.fixture
def launched(monkeypatch):
    """The tensors the dispatcher hands to the CUDA wrapper, which records
    them and returns an empty output (the tests give meta tensors, which
    are not on the CPU and so are routed as a CUDA tensor is)."""
    calls = []

    def recording(x):
        calls.append(x)
        return x.new_empty((*x.shape[:2], 2 * x.shape[2], 2 * x.shape[3]))

    monkeypatch.setattr(tup, "upsample2x_cuda", recording)
    return calls


def test_routing_takes_the_kernel_only_for_an_exact_2x_of_a_contiguous_bf16_or_f32(launched):
    meta = dict(device="meta")
    tup.resize_bilinear(torch.empty(2, 3, 8, 16, **meta), (16, 32))
    tup.bilinear_upsample(torch.empty(2, 3, 8, 16, dtype=torch.bfloat16, **meta), 2)
    assert len(launched) == 2
    tup.resize_bilinear(torch.empty(2, 3, 8, 16, **meta), (16, 32), plain=True)
    tup.bilinear_upsample(torch.empty(2, 3, 8, 16, **meta), 3)  # not 2x
    tup.resize_bilinear(torch.empty(2, 3, 8, 16, **meta), (16, 16))  # one axis only
    tup.resize_bilinear(torch.empty(2, 3, 8, 16, **meta), (4, 8))  # a downscale
    tup.bilinear_upsample(torch.empty(2, 3, 8, 16, dtype=torch.float16, **meta), 2)
    tup.bilinear_upsample(torch.empty(2, 3, 16, 8, **meta).transpose(-1, -2), 2)
    assert len(launched) == 2


def test_a_cpu_tensor_takes_the_plain_version():
    x = torch.randn(2, 3, 8, 16)
    before = tup.upsample2x_cuda.launches
    assert torch.equal(tup.bilinear_upsample(x, 2), tup.upsample2x_plain(x))
    assert torch.equal(tup.upsample2x(x), tup.upsample2x_plain(x))
    assert tup.upsample2x_cuda.launches == before


def test_the_cuda_wrapper_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="CUDA"):
        tup.upsample2x_cuda(torch.randn(1, 2, 4, 4))
    with pytest.raises(ValueError, match="bf16 or f32"):
        tup.upsample2x_cuda(torch.empty(1, 2, 4, 4, dtype=torch.float16, device="meta"))
    with pytest.raises(ValueError, match="contiguous NCHW"):
        tup.upsample2x_cuda(torch.empty(1, 2, 4, 4, device="meta").transpose(-1, -2))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_flownet_routes_by_use_kernels(launched, use_kernels):
    net = FlowNetS(19, 0.25, use_kernels=use_kernels, device="meta", dtype=torch.bfloat16)
    net(torch.empty(2, 6, 64, 128, device="meta"))
    # four feature resizes (bf16) and four flow resizes (f32) a pass
    assert [x.dtype for x in launched] == (
        [torch.bfloat16, torch.float32] * 4 if use_kernels else [])
    model = AccelNet(ref_depth=18, update_depth=18, head_channels=32, flow_width_mult=0.25,
                     use_kernels=use_kernels, device="meta")
    assert model.flownet.use_kernels is use_kernels


@pytest.mark.parametrize("shape", [(2, 3, 6, 10), (1, 2, 1, 5), (1, 2, 7, 1)])
def test_adjoint_is_the_gradient_of_f_interpolate(shape):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(shape, generator=g, dtype=torch.float64, requires_grad=True)
    grad = torch.randn(*shape[:2], 2 * shape[2], 2 * shape[3], generator=g)
    _interpolate(x).backward(grad.double())
    torch.testing.assert_close(tup.upsample2x_adjoint(grad).double(), x.grad, rtol=1e-6,
                               atol=1e-6)


def test_gradients_route_through_the_function_or_the_library(launched):
    on_card = torch.empty(2, 3, 8, 16, device="meta", requires_grad=True)
    assert isinstance(tup.bilinear_upsample(on_card, 2).grad_fn,
                      tup.Upsample2xFunction._backward_cls)
    assert len(launched) == 1
    cpu = torch.randn(2, 3, 8, 16, requires_grad=True)
    out = tup.bilinear_upsample(cpu, 2)
    assert "UpsampleBilinear2D" in type(out.grad_fn).__name__
    out.sum().backward()
    assert cpu.grad.shape == cpu.shape and len(launched) == 1


def test_op_fake_gives_the_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        out = tup.upsample2x_op(torch.empty(2, 5, 7, 13, dtype=torch.bfloat16))
    assert tuple(out.shape) == (2, 5, 14, 26) and out.dtype == torch.bfloat16


def test_exported_flownet_carries_the_op():
    net = FlowNetS(19, 0.25, device="cpu", dtype=torch.float32).eval()
    pair = torch.randn(1, 6, 64, 64, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want = net(pair)
        exported = torch.export.export(net, (pair,))
    ops = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert ops.count("accel_tpu_torch.upsample2x.default") == 8
    got = exported.module()(pair)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flownet_plain_and_kernel_routes_match_jax():
    jm = jflownet.FlowNetS(scale_channels=19, width_mult=0.5, dtype=jnp.float32)
    pair = (np.random.default_rng(7).standard_normal((2, 64, 64, 6)) * 0.5).astype(np.float32)
    v = seeded_variables(jm, jnp.asarray(pair), seed=7)
    jflow, jscale = jm.apply(v, jnp.asarray(pair))
    outs = []
    for use_kernels in (True, False):
        tm = FlowNetS(19, 0.5, use_kernels=use_kernels, device="cpu", dtype=torch.float32)
        load_flax_variables(tm, v)
        with torch.no_grad():
            outs.append(tm(nchw(pair)))
    (flow, scale), (plain_flow, plain_scale) = outs
    assert torch.equal(flow, plain_flow) and torch.equal(scale, plain_scale)
    assert_close(nhwc(flow), np.asarray(jflow))
    assert_close(nhwc(scale), np.asarray(jscale))
