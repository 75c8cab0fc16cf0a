"""The port's int8 serving convs (``accel_tpu_torch/ops/quant.py``) and a
quantized ``AccelNet`` against ``accel_tpu``'s int8 path.

Convs: the same seeded numpy input and weights through JAX's
``quantize_symmetric`` and ``int8_conv_general_dilated`` and the port's
``quantize_symmetric`` and ``int8_conv2d``: the int8 values and scales are
equal, the int32 accumulators are equal (the plain float64 product and the
im2col + ``torch._int_mm`` product the card runs, here on the CPU), and
the output is within 1 ulp of its dtype (f32 and bf16). 1x1, strided 1x1,
strided 3x3, dilated 3x3 and a biased (fc6-like) conv, whose bias both
sides add after the int8 conv in the activation dtype.

Model: a tiny Accel model (R18/R18, head 32, f32, 128x128) with
``quantize_ref`` and ``quantize_update`` and the same seeded weights on
both sides, incremental and direct. Within a group the port runs its int8
convs on the JAX group step's batches, in its order (one activation scale
covers a whole call, so a call over other frames would quantize
differently), and every one of them equals JAX's int8 conv on the same
activation within an ulp. End to end, quantization makes the two sides'
last-ulp f32 differences visible; the tolerances are stated at the test.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import nchw, nhwc, seeded_variables

from accel_tpu.core import pipeline as jpipe
from accel_tpu.models.accel import AccelNet as JAccelNet
from accel_tpu.ops import quant as jq
from accel_tpu_torch.convert import load_flax_variables
from accel_tpu_torch.core import pipeline as tpipe
from accel_tpu_torch.models.accel import AccelNet, build_model
from accel_tpu_torch.models.resnet import Int8Conv2d
from accel_tpu_torch.ops import quant as tq

torch.set_num_threads(2)
DN = ("NHWC", "HWIO", "NHWC")
# (kernel, stride, dilation, cin, cout)
CONVS = {"1x1": (1, 1, 1, 16, 32), "1x1_stride2": (1, 2, 1, 16, 32),
         "3x3_stride2": (3, 2, 1, 16, 24), "3x3_dilated2": (3, 1, 2, 24, 32),
         "3x3_dilated6": (3, 1, 6, 16, 8)}
TINY = dict(ref_depth=18, update_depth=18, num_classes=19, feat_stride=16, head_channels=32,
            quantize_ref=True, quantize_update=True)


def _ulp(a: np.ndarray, dtype) -> np.ndarray:
    """The spacing of ``dtype`` at each |value| of ``a`` (f32 numpy)."""
    t = torch.from_numpy(np.abs(a).astype(np.float32)).to(dtype)
    return (torch.nextafter(t, torch.full_like(t, float("inf"))) - t).float().numpy()


def _arrays(name: str, seed: int = 0):
    k, s, d, cin, cout = CONVS[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 12, 20, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    return x, w, s, d * (k // 2), d


@pytest.mark.parametrize("name", list(CONVS))
def test_int8_accumulators_equal_jax(name):
    x, w, s, pad, d = _arrays(name)
    jxq, jxs = jq.quantize_symmetric(jnp.asarray(x))
    jwq, jws = jq.quantize_symmetric(jnp.asarray(w), axis=(3,))
    acc = jax.lax.conv_general_dilated(jxq, jwq, (s, s), [(pad, pad)] * 2, rhs_dilation=(d, d),
                                       dimension_numbers=DN, preferred_element_type=jnp.int32)
    want = torch.from_numpy(np.array(acc)).permute(0, 3, 1, 2)

    xq, xs = tq.quantize_symmetric(nchw(x))
    qw = tq.QuantizedWeight(torch.from_numpy(w).permute(3, 2, 0, 1).contiguous())
    assert xq.dtype == torch.int8 and float(xs) == float(jxs)
    assert torch.equal(xq, nchw(np.asarray(jxq)).to(torch.int8))
    assert torch.equal(qw.q, torch.from_numpy(np.array(jwq)).permute(3, 2, 0, 1))
    assert torch.equal(qw.scale, torch.from_numpy(np.array(jws)).reshape(-1))
    assert torch.equal(tq.int8_conv_acc_plain(xq, qw.q, s, pad, d), want)
    launches = tq.int_mm.launches
    assert torch.equal(tq.int8_conv_acc_gemm(xq, qw, s, pad, d), want)
    assert tq.int_mm.launches == launches + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONVS))
def test_int8_conv_matches_jax_within_an_ulp(name, dtype):
    x, w, s, pad, d = _arrays(name, seed=1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jq.int8_conv_general_dilated(jnp.asarray(x, jdt), jnp.asarray(w, jdt), (s, s),
                                        [(pad, pad)] * 2, rhs_dilation=(d, d),
                                        dimension_numbers=DN)
    want = np.asarray(want.astype(jnp.float32))
    got = tq.int8_conv2d(nchw(x).to(tdt), torch.from_numpy(w).permute(3, 2, 0, 1).to(tdt),
                         s, pad, d)
    assert got.dtype == tdt
    err = np.abs(nhwc(got.float()) - want)
    assert (err <= _ulp(want, tdt)).all(), float(err.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_biased_int8_conv_matches_flax(dtype):
    """fc6's form: flax ``nn.Conv`` with the int8 hook and a bias, against
    the port's ``Int8Conv2d`` (the bias added after the conv)."""
    x, w, _, _, _ = _arrays("3x3_dilated6", seed=2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    conv = fnn.Conv(8, (3, 3), kernel_dilation=(6, 6), padding=[(6, 6), (6, 6)], dtype=jdt,
                    conv_general_dilated=jq.int8_conv_general_dilated)
    bias = np.random.default_rng(3).standard_normal(8).astype(np.float32)
    want = conv.apply({"params": {"kernel": w, "bias": bias}}, jnp.asarray(x))
    want = np.asarray(want.astype(jnp.float32))
    tconv = Int8Conv2d(16, 8, 3, padding=6, dilation=6, bias=True, dtype=tdt)
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        tconv.bias.copy_(torch.from_numpy(bias))
    got = tconv(nchw(x).to(tdt))
    err = np.abs(nhwc(got.float()) - want)
    assert (err <= _ulp(want, tdt)).all(), float(err.max())


# (N, Cin, H, W, Cout, kernel, stride, dilation): shapes CUDA's int8 GEMM refuses
# unpadded: m = N*Ho*Wo <= 16 (layer4 of a 64x64 frame at stride 16), k =
# Cin*kh*kw and n = Cout not multiples of 8
SMALL_GEMMS = {"m16": (1, 64, 4, 4, 128, 3, 1, 1), "cout19": (2, 32, 6, 10, 19, 1, 1, 1),
               "k_odd_m6": (1, 13, 5, 7, 19, 3, 2, 1)}


@pytest.mark.parametrize("name", list(SMALL_GEMMS))
def test_int8_gemm_pads_every_shape_exactly(name):
    """``int8_conv_acc_gemm`` zero-pads the rows to 17 and k, n to multiples
    of 8, then slices: its int32 accumulators equal the int8 conv of
    ``accel_tpu`` (``lax.conv_general_dilated`` on the int8 values, int32
    out, as ``int8_conv_general_dilated`` computes it) exactly."""
    N, cin, h, w, cout, k, s, d = SMALL_GEMMS[name]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((N, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    pad = d * (k // 2)
    jxq, _ = jq.quantize_symmetric(jnp.asarray(x))
    jwq, _ = jq.quantize_symmetric(jnp.asarray(wt), axis=(3,))
    acc = jax.lax.conv_general_dilated(jxq, jwq, (s, s), [(pad, pad)] * 2, rhs_dilation=(d, d),
                                       dimension_numbers=DN, preferred_element_type=jnp.int32)
    want = torch.from_numpy(np.array(acc)).permute(0, 3, 1, 2)
    xq, _ = tq.quantize_symmetric(nchw(x))
    qw = tq.QuantizedWeight(torch.from_numpy(wt).permute(3, 2, 0, 1).contiguous())
    assert qw.mat.shape[0] % 8 == 0 and qw.mat.shape[1] % 8 == 0
    launches = tq.int_mm.launches
    got = tq.int8_conv_acc_gemm(xq, qw, s, pad, d)
    assert tq.int_mm.launches == launches + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_int_mm_checks_the_gemm_shape():
    """The int8 GEMM takes m > 16 and k, n multiples of 8, exactly, and
    refuses what CUDA's would."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (24, 16), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (16, 16), generator=g, dtype=torch.int8)
    assert torch.equal(tq.int_mm(a, b[:, :8]), a.int() @ b[:, :8].int())
    for m, k, n in ((16, 16, 8), (24, 12, 8), (24, 16, 12)):
        with pytest.raises(ValueError, match="multiples of 8"):
            tq.int_mm(a[:m, :k], b[:k, :n])


def test_quantized_weights_follow_the_weight_version():
    conv = Int8Conv2d(8, 8, 1, bias=False)
    x = torch.randn(1, 8, 4, 4, generator=torch.Generator().manual_seed(1))
    y0 = conv(x)
    with torch.no_grad():
        conv.weight.mul_(2.0)
    assert not torch.equal(conv(x), y0)


@pytest.fixture(scope="module")
def tiny_quant():
    jm = JAccelNet(family="accel", dtype=jnp.float32, use_pallas_warp=True, **TINY)
    cur = jnp.zeros((1, 128, 128, 3))
    v = seeded_variables(jm, cur, cur, jnp.ones((1,)), train=False, seed=31)
    tm = AccelNet(**TINY, device="cpu", dtype=torch.float32)
    load_flax_variables(tm, v)
    clip = (np.random.default_rng(32).standard_normal((1, 10, 128, 128, 3)) * 0.5
            ).astype(np.float32)
    return jm, v, tm, clip


def test_quantized_model_routes_every_block_conv(tiny_quant):
    _, _, tm, _ = tiny_quant
    for branch in (tm.ref_net, tm.update_net):
        int8 = [n for n, m in branch.named_modules() if isinstance(m, Int8Conv2d)]
        # 8 blocks x 2 convs + 3 downsamples + fc6; the stem stays float
        assert len(int8) == 20 and "head.fc6" in int8
        assert type(branch.backbone.conv1) is torch.nn.Conv2d
        assert type(branch.head.score) is torch.nn.Conv2d


@pytest.fixture(scope="module")
def jax_runs(tiny_quant):
    """The JAX model's two groups, once per propagation mode for the tests
    of this module: the activation shape (NHWC) of every int8 conv it
    traces, in call order (one group's: ``lax.scan`` traces its body once;
    ``_pick_conv_fn`` returns the module's global), the logits, and the
    class maps of ``clip_predictions`` (its upsample + argmax tail on those
    logits)."""
    import accel_tpu.models.resnet as jresnet
    from accel_tpu.ops.upsample_argmax import upsample_argmax_or_oracle

    jm, v, _, clip = tiny_quant
    runs = {}
    for propagate in ("incremental", "direct"):
        calls = []

        def recorded(lhs, rhs, *args, **kwargs):
            calls.append(tuple(lhs.shape))
            return jq.int8_conv_general_dilated(lhs, rhs, *args, **kwargs)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jresnet, "int8_conv_general_dilated", recorded)
            logits = jpipe.clip_logits(jm, v, jnp.asarray(clip), 5, propagate)
        B, F = logits.shape[:2]
        preds = upsample_argmax_or_oracle(logits.reshape(B * F, *logits.shape[2:]),
                                          clip.shape[2:4]).reshape(B, F, *clip.shape[2:4])
        runs[propagate] = (calls, np.asarray(logits), np.asarray(preds))
    return runs


def _port_int8_calls(model):
    """Forward hooks on every ``Int8Conv2d``: a list of (module, input,
    output) per call, and the hook handles."""
    calls = []
    handles = [m.register_forward_hook(lambda mod, i, o: calls.append((mod, i[0], o)))
               for m in model.modules() if isinstance(m, Int8Conv2d)]
    return calls, handles


@pytest.mark.parametrize("propagate", ["incremental", "direct"])
def test_quantized_group_batches_and_convs_as_jax(tiny_quant, jax_runs, propagate):
    """One group (k=5): the port runs its int8 convs on activation batches
    of the JAX group step's shapes, in its order (the key frame alone, the
    update branch on the group's 5 frames at once), so each conv quantizes
    the same frames with one scale; and each of the port's int8 convs,
    given the port's own activation, equals JAX's int8 conv (with the
    bias) on that activation within an ulp."""
    _, _, tm, clip = tiny_quant
    jax_int8_calls = jax_runs[propagate][0]
    calls, handles = _port_int8_calls(tm)
    try:
        tpipe.clip_logits(tm, nchw(clip[:, :5]), 5, propagate)
    finally:
        for h in handles:
            h.remove()
    assert [tuple(x.permute(0, 2, 3, 1).shape) for _, x, _ in calls] == jax_int8_calls
    assert {x.shape[0] for _, x, _ in calls} == {1, 5}
    for mod, x, y in calls:
        d, p, s = mod.dilation[0], mod.padding[0], mod.stride[0]
        want = jq.int8_conv_general_dilated(
            jnp.asarray(nhwc(x)), jnp.asarray(mod.weight.detach().permute(2, 3, 1, 0).numpy()),
            (s, s), [(p, p)] * 2, rhs_dilation=(d, d), dimension_numbers=DN)
        if mod.bias is not None:
            want = want + jnp.asarray(mod.bias.detach().numpy())
        want = np.asarray(want)
        err = np.abs(nhwc(y) - want)
        assert (err <= _ulp(want, torch.float32)).all(), float(err.max())


@pytest.mark.parametrize("propagate", ["incremental", "direct"])
def test_quantized_clip_logits_match_jax(tiny_quant, jax_runs, propagate):
    """Two groups end to end. The two sides' f32 activations differ in the
    last ulps (conv summation order), so a value that sits on a rounding
    boundary of its quantizer rounds to neighbouring int8 values on the two
    sides, and the one-step difference grows through the later quantized
    layers (each conv's own outputs are held to an ulp above). The logits
    agree within a relative L2 error of 5e-2 (measured 1.3e-2 to 2.5e-2;
    int8 against float differs by 3e-2 here) and the stride-level class
    maps on >= 0.95 of the pixels (measured 0.97-0.99)."""
    _, _, tm, clip = tiny_quant
    _, want, jpred = jax_runs[propagate]
    got = nhwc(tpipe.clip_logits(tm, nchw(clip), 5, propagate))
    assert got.shape == want.shape == (1, 10, 8, 8, 19)
    assert np.linalg.norm(got - want) <= 5e-2 * np.linalg.norm(want)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.95
    pred = tpipe.clip_predictions(tm, torch.from_numpy(clip), 5, propagate)
    assert pred.dtype == torch.uint8 and (pred.numpy() == jpred).mean() >= 0.95


def test_build_model_takes_the_quantize_knobs():
    gen = torch.Generator().manual_seed(0)
    m = build_model(dict(ref_depth=18, head_channels=32, dtype="float32", quantize_ref=True,
                         dilated_conv="pallas"), device="meta", generator=gen)
    # int8 takes precedence over the dilated kernel in the quantized branch
    assert isinstance(m.ref_net.head.fc6, Int8Conv2d)
    assert type(m.update_net.head.fc6).__name__ == "DilatedConv3x3"
