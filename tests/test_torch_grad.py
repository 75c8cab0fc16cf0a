"""Gradients through the port's kernels against ``accel_tpu``'s custom VJPs.

On the card each kernel runs inside a ``torch.autograd.Function``; here,
where no kernel runs, the gradients that Function returns are checked in two
ways. Its backward's arithmetic (autograd through the plain version, for
#5 the dx conv on rotated weights) against ``jax.vjp`` of the JAX
package's differentiable function, Pallas kernels in interpret mode, at
rel 1e-4 (f32 sums in another order). And its plumbing on CPU tensors, with
the kernel launch replaced by the plain version: the gradients the
Function hands autograd equal autograd through the plain version, and the
launch counters count forward and backward launches.

Also: ``upsample_argmax``'s kernel refuses logits that need a gradient; the
cross entropy keeps its gradient with OHEM's top-k in the graph; the pair
forward (``AccelNet.forward``) of each family equals the JAX module's
``__call__``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, bridged_models, nchw, nhwc

import accel_tpu.ops.fused_stem as jstem
import accel_tpu.ops.warp_onehot as jwo
from accel_tpu.core.metrics import softmax_cross_entropy as j_ce
from accel_tpu.ops.dilated_pallas import _eligible, pallas_conv_general_dilated
from accel_tpu.ops.warp import bilinear_warp_pallas
from accel_tpu_torch.core.metrics import softmax_cross_entropy
from accel_tpu_torch.models.resnet import DilatedConv3x3
from accel_tpu_torch.ops import dilated_cuda as tdc
from accel_tpu_torch.ops import fused_stem as tstem
from accel_tpu_torch.ops import upsample_argmax as tua
from accel_tpu_torch.ops import warp_cuda as twc
from accel_tpu_torch.ops import warp_onehot as two
from accel_tpu_torch.ops.autograd import plain_vjp

torch.set_num_threads(2)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def hwio(w_oihw: torch.Tensor) -> jnp.ndarray:
    return jnp.asarray(w_oihw.permute(2, 3, 1, 0).numpy())


def function_grads(fn, inputs, grad):
    """Gradients of ``fn(*inputs)`` by autograd, for the inputs that need one."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    fn(*leaves).backward(grad)
    return [t.grad for t in leaves]


# ---- #1: the score-map warp -----------------------------------------------------


@pytest.fixture
def warp_case():
    """(2,19,12,20) features, D=2, flow up to 2D, so the clamp is active on
    about half the pixels."""
    rng = np.random.default_rng(1)
    feat, flow = _rand(rng, (2, 12, 20, 19)), _rand(rng, (2, 12, 20, 2))
    flow = np.clip(flow, -1, 1) * 4.0
    return feat, flow, _rand(rng, (2, 12, 20, 19)), 2


def test_warp_vjp_matches_jax(warp_case):
    """``accel_tpu``'s ``bilinear_warp_pallas`` (the Pallas forward, the
    clamped oracle's VJP) against the backward of ``WarpFunction``."""
    feat, flow, g, d = warp_case
    _, vjp = jax.vjp(lambda f, fl: bilinear_warp_pallas(f, fl, d), jnp.asarray(feat),
                     jnp.asarray(flow))
    want = vjp(jnp.asarray(g))
    got = plain_vjp(lambda f, fl: twc.warp_plain(f, fl, d), (nchw(feat), nchw(flow)),
                    (True, True), nchw(g))
    for ours, ref in zip(got, want):
        assert_close(nhwc(ours), np.asarray(ref))
    # where the clamp is active the flow gets no gradient
    clamped = np.abs(flow) > d
    assert clamped.mean() > 0.3 and not nhwc(got[1])[clamped].any()


def test_warp_function_carries_the_gradient(warp_case, monkeypatch):
    feat, flow, g, d = warp_case
    monkeypatch.setattr(twc, "warp_cuda", lambda f, fl, dd: twc.warp_plain(f, fl, dd))
    got = function_grads(lambda f, fl: twc.WarpFunction.apply(f, fl, d), (nchw(feat), nchw(flow)),
                         nchw(g))
    want = function_grads(lambda f, fl: twc.warp_plain(f, fl, d), (nchw(feat), nchw(flow)),
                          nchw(g))
    for ours, ref in zip(got, want):
        torch.testing.assert_close(ours, ref, rtol=0, atol=0)


# ---- #5: the dilated conv --------------------------------------------------------


def test_dilated_dx_and_dw_match_jax():
    """dx as the dilated conv of the output gradient with the rotated,
    channel-swapped weights (the kernel's own computation in the backward)
    and dw by ``conv2d_weight``, against ``jax.vjp`` of
    ``pallas_conv_general_dilated`` (its custom VJP: dx on the Pallas
    kernel in interpret mode), Cin = Cout = 128, 8x16, d=2."""
    rng = np.random.default_rng(2)
    d = 2
    x = _rand(rng, (1, 8, 16, 128))
    w = torch.from_numpy(_rand(rng, (128, 128, 3, 3), 1 / np.sqrt(9 * 128)))
    g = _rand(rng, (1, 8, 16, 128))
    assert _eligible(jnp.asarray(g), hwio(w), d)
    _, vjp = jax.vjp(lambda a, b: pallas_conv_general_dilated(
        a, b, (1, 1), [(d, d), (d, d)], rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC")), jnp.asarray(x), hwio(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    dx = tdc.conv3x3_dilated_dx_plain(nchw(g), w, d)
    dw = torch.nn.grad.conv2d_weight(nchw(x), w.shape, nchw(g), padding=d, dilation=d)
    assert_close(nhwc(dx), np.asarray(want_dx))
    assert_close(dw.permute(2, 3, 1, 0).numpy(), np.asarray(want_dw))
    # the rotated packing is the packing of the rotated weights
    torch.testing.assert_close(tdc.pack_dilated_weight_dx(w),
                               tdc.pack_dilated_weight(w.flip(2, 3).transpose(0, 1)))


def test_dilated_function_runs_dx_on_the_kernel(monkeypatch):
    """``DilatedConvFunction``: the forward and dx launches of the kernel
    (counted apart), dx on the module's cached rotated packing, dw by
    ``conv2d_weight``; gradients as autograd through ``F.conv2d``."""
    rng = np.random.default_rng(3)
    d = 2
    conv = DilatedConv3x3(16, 24, d, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(_rand(rng, (24, 16, 3, 3), 0.1)))
    seen = []

    def launch(x, w, dd, packed):
        assert packed is None or torch.equal(packed, tdc.pack_dilated_weight(w))
        seen.append(tuple(w.shape))
        return tdc.conv3x3_dilated_plain(x, w, dd)

    monkeypatch.setattr(tdc, "_launch", launch)
    monkeypatch.setattr(tdc.conv3x3_dilated_cuda, "launches", 0)
    monkeypatch.setattr(tdc.conv3x3_dilated_cuda, "backward_launches", 0)
    x = torch.from_numpy(_rand(rng, (2, 16, 8, 12)))
    g = torch.from_numpy(_rand(rng, (2, 24, 8, 12)))
    got = function_grads(lambda a, w: tdc.DilatedConvFunction.apply(
        a, w, d, conv.packed_weight(), conv.packed_weight_dx), (x, conv.weight), g)
    want = function_grads(lambda a, w: tdc.conv3x3_dilated_plain(a, w, d), (x, conv.weight), g)
    for ours, ref in zip(got, want):
        torch.testing.assert_close(ours, ref, rtol=1e-5, atol=1e-6)
    assert seen == [(24, 16, 3, 3), (16, 24, 3, 3)]
    assert (tdc.conv3x3_dilated_cuda.launches, tdc.conv3x3_dilated_cuda.backward_launches) == (1, 1)
    # an input that needs no gradient gets no dx launch
    w = conv.weight.detach().clone().requires_grad_()
    tdc.DilatedConvFunction.apply(x, w, d, None, None).backward(g)
    assert (tdc.conv3x3_dilated_cuda.launches, tdc.conv3x3_dilated_cuda.backward_launches) == (2, 1)
    torch.testing.assert_close(w.grad, want[1], rtol=1e-5, atol=1e-6)


# ---- #3: the fused stem ----------------------------------------------------------


@pytest.fixture
def stem_case():
    rng = np.random.default_rng(4)
    return (_rand(rng, (2, 18, 26, 3)), torch.from_numpy(_rand(rng, (64, 3, 7, 7), 0.1)),
            rng.uniform(0.5, 1.5, 64).astype(np.float32), _rand(rng, (64,), 0.1),
            _rand(rng, (2, 9, 13, 64)))


def test_fused_stem_vjp_matches_jax(stem_case):
    x, w, inv, shift, g = stem_case
    _, vjp = jax.vjp(jstem._oracle, jnp.asarray(x), hwio(w), jnp.asarray(inv), jnp.asarray(shift))
    want = vjp(jnp.asarray(g))
    got = plain_vjp(tstem.fused_stem_plain, (nchw(x), w, torch.from_numpy(inv),
                                             torch.from_numpy(shift)), (True,) * 4, nchw(g))
    assert_close(nhwc(got[0]), np.asarray(want[0]))
    assert_close(got[1].permute(2, 3, 1, 0).numpy(), np.asarray(want[1]))
    assert_close(got[2].numpy(), np.asarray(want[2]))
    assert_close(got[3].numpy(), np.asarray(want[3]))


def test_fused_stem_function_carries_the_gradient(stem_case, monkeypatch):
    x, w, inv, shift, g = stem_case
    monkeypatch.setattr(tstem, "fused_stem_cuda",
                        lambda a, b, c, e, packed: tstem.fused_stem_plain(a, b, c, e))
    inputs = (nchw(x), w, torch.from_numpy(inv), torch.from_numpy(shift))
    got = function_grads(lambda *a: tstem.FusedStemFunction.apply(*a, None), inputs, nchw(g))
    want = function_grads(tstem.fused_stem_plain, inputs, nchw(g))
    for ours, ref in zip(got, want):
        torch.testing.assert_close(ours, ref, rtol=0, atol=0)


# ---- #4: the one-hot feature warp ------------------------------------------------


@pytest.fixture
def onehot_case():
    """(2,24,10,16) features, D=2: flow_y up to 2D (clamped), flow_x up to
    3D (not clamped), a scale field and a per-sample gain."""
    rng = np.random.default_rng(5)
    flow = np.clip(_rand(rng, (2, 10, 16, 2)), -1, 1) * np.float32([6.0, 4.0])
    return (_rand(rng, (2, 10, 16, 24)), flow, rng.uniform(0.5, 1.5, (2, 10, 16, 24)).astype(
        np.float32), rng.uniform(0.5, 1.5, 2).astype(np.float32), _rand(rng, (2, 10, 16, 24)), 2)


def test_warp_onehot_vjp_matches_jax(onehot_case):
    """Against the VJP of ``accel_tpu``'s gained gather oracle (its custom
    VJP's backward), with f32 tap weights as that oracle has."""
    feat, flow, scale, gain, g, d = onehot_case
    _, vjp = jax.vjp(lambda f, fl, s, gn: jwo._gained_oracle(f, fl, s, gn, d),
                     *map(jnp.asarray, (feat, flow, scale, gain)))
    want = vjp(jnp.asarray(g))
    got = plain_vjp(lambda f, fl, s, gn: two.warp_onehot_plain(f, fl, s, d, gn, torch.float32),
                    (nchw(feat), nchw(flow), nchw(scale), torch.from_numpy(gain)), (True,) * 4,
                    nchw(g))
    for i in range(3):
        assert_close(nhwc(got[i]), np.asarray(want[i]))
    assert_close(got[3].numpy(), np.asarray(want[3]))


def test_warp_onehot_function_carries_the_gradient(onehot_case, monkeypatch):
    feat, flow, scale, gain, g, d = onehot_case
    monkeypatch.setattr(two, "warp_onehot_cuda", lambda f, fl, s, dd, gn, wd: (
        two.warp_onehot_plain(f, fl, s, dd, gn, wd)))
    inputs = (nchw(feat), nchw(flow), nchw(scale), torch.from_numpy(gain))
    got = function_grads(lambda *a: two.WarpOnehotFunction.apply(*a, d, torch.bfloat16),
                         inputs, nchw(g))
    want = function_grads(lambda *a: two.warp_onehot_plain(*a[:3], d, a[3]), inputs, nchw(g))
    for ours, ref in zip(got, want):
        torch.testing.assert_close(ours, ref, rtol=0, atol=0)


# ---- #2, the cross entropy and the pair forward ---------------------------------


def test_upsample_argmax_kernel_refuses_a_gradient():
    logits = torch.zeros((1, 3, 4, 4), requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        tua.upsample_argmax_cuda(logits, (8, 8))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        tua.upsample_argmax_cuda(logits, (8, 8))


@pytest.mark.parametrize("ohem", [None, 0.3])
def test_cross_entropy_gradient_matches_jax(ohem):
    """With OHEM the loss is a top-k of the per-pixel losses; its gradient
    reaches only the kept pixels, as JAX's does."""
    rng = np.random.default_rng(6)
    logits = _rand(rng, (2, 10, 12, 19), 2.0)
    label = rng.integers(0, 19, (2, 10, 12)).astype(np.int32)
    label[:, :3] = 255
    want, want_g = jax.value_and_grad(lambda lg: j_ce(lg, jnp.asarray(label), 19, 1.5, ohem))(
        jnp.asarray(logits))
    lg = nchw(logits).requires_grad_()
    loss = softmax_cross_entropy(lg, torch.from_numpy(label), 19, 1.5, ohem)
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    assert_close(nhwc(lg.grad), np.asarray(want_g))
    if ohem:
        assert (nhwc(lg.grad) == 0).all(axis=-1).mean() > 0.5


@pytest.mark.parametrize("family", ["accel", "dff", "deeplab"])
def test_pair_forward_matches_jax(family):
    """``AccelNet.forward(cur, key, eq_flag)``: eq_flag [1, 0] takes the
    keyframe's tensor for the first example and the warped one for the
    second (mixed in f32)."""
    knobs = dict(family=family, ref_depth=18, update_depth=18, head_channels=32,
                 use_pallas_warp=False)
    jm, v, tm = bridged_models(knobs, 128, seed=31)
    rng = np.random.default_rng(7)
    cur = _rand(rng, (2, 128, 128, 3), 0.5)
    key = np.roll(cur, 3, axis=2)
    eq = np.asarray([1.0, 0.0], np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(cur), jnp.asarray(key), jnp.asarray(eq)))
    with torch.no_grad():
        got = tm(nchw(cur), nchw(key), torch.from_numpy(eq))
    assert_close(nhwc(got), want)
