"""The rest of the port's clip inference against ``accel_tpu.core.pipeline``:
``input_scale``, the ``nearest_pred`` and ``bilinear_logits_xla`` tails,
``propagate: composed`` (accel and dff), the ``mean1``/``clamp`` cascades
and the ``stacked`` gather, each on the same seeded numpy inputs.

Models are tiny and f32 (R18, head 32, 128x128; the accel one with an R18
update branch, the dff one with FlowNet at half width and the bench's
one-hot warp) with the same seeded weights on both sides and live flow
heads. Logits within 1e-4 * (1 + max|ref|); class maps agree on >= 0.999
of the pixels, every disagreement at a near-tie of the JAX logits. The
dff cases run both one-hot warps with f32 tap weights, as
``test_torch_dff.py`` explains."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (assert_argmax_agrees, assert_close, bridged_models,  # noqa: F401
                          f32_tap_weights, nchw, nhwc)

from accel_tpu.core import pipeline as jpipe
from accel_tpu.ops.upsample import resize_bilinear as j_resize
from accel_tpu.ops.warp import bilinear_warp_xla, bilinear_warp_xla_stacked
from accel_tpu_torch.core import pipeline as tpipe
from accel_tpu_torch.models.accel import build_model
from accel_tpu_torch.ops.warp import bilinear_warp, bilinear_warp_plain

torch.set_num_threads(2)
HW, K = 128, 4
ACCEL = dict(family="accel", ref_depth=18, update_depth=18, head_channels=32)
DFF = dict(family="dff", ref_depth=18, head_channels=32, flow_width_mult=0.5, warp_max_disp=4,
           warp_dtype="native", warp_gather="onehot")


def _pair(knobs: dict, seed: int, batch: int = 1):
    clip = (np.random.default_rng(seed + 1).standard_normal((batch, K, HW, HW, 3)) * 0.5
            ).astype(np.float32)
    return (*bridged_models(knobs, HW, seed), clip)


@pytest.fixture(scope="module")
def accel():
    return _pair(ACCEL, seed=101, batch=2)


@pytest.fixture(scope="module")
def dff():
    return _pair(DFF, seed=111)


def _knobs(jm, tm, **knobs):
    for key, value in knobs.items():
        setattr(tm, key, value)
    return jm.clone(**knobs)


def _check_logits(jm, v, tm, clip, propagate, **kw):
    want = np.asarray(jpipe.clip_logits(jm, v, jnp.asarray(clip), K, propagate, **kw))
    got = tpipe.clip_logits(tm, nchw(clip), K, propagate, **kw)
    assert tuple(got.shape) == (clip.shape[0], K, 19, 8, 8)
    assert_close(nhwc(got), want)
    return want


def test_flows_are_live_and_inside_the_bounds(accel, dff):
    """The seeded flow heads move content by more than half a feature pixel
    and stay under D (accel 8, dff 4) per step, where the port's clamped
    warps equal the JAX CPU path's unclamped oracle; composed flows stay
    under (k-1) x D."""
    for (jm, v, _, clip), bound in ((accel, 8.0), (dff, 4.0)):
        flow, _ = jm.apply(v, jnp.asarray(clip[:, 1]), jnp.asarray(clip[:, 0]), method="flow")
        m = float(np.abs(np.asarray(flow)).max())
        assert 0.5 < m < bound, m


# ---- input_scale ----------------------------------------------------------------


@pytest.mark.parametrize("propagate", ["direct", "incremental", "composed"])
def test_input_scale_matches_jax(accel, monkeypatch, propagate):
    """clip_logits(clip, input_scale=s) matches the JAX package's, and equals
    the port on clip * s, also when the frames run in chunks (mirrors
    ``tests/test_pipeline.py::test_input_scale_matches_premultiplied_clip``)."""
    jm, v, tm, clip = accel
    jm = _knobs(jm, tm, scale_cascade="last")
    s = 1.37
    _check_logits(jm, v, tm, clip, propagate, input_scale=s)
    got = tpipe.clip_logits(tm, nchw(clip), K, propagate, input_scale=s)
    premultiplied = tpipe.clip_logits(tm, nchw(clip) * s, K, propagate)
    torch.testing.assert_close(got, premultiplied, rtol=0, atol=2e-5)
    monkeypatch.setattr(tpipe, "MAX_FULLRES_FRAMES_PER_DISPATCH", 2)
    chunked = tpipe.clip_logits(tm, nchw(clip), K, propagate, input_scale=s)
    torch.testing.assert_close(chunked, got, rtol=0, atol=2e-5)


def test_input_scale_reaches_clip_predictions(accel):
    jm, v, tm, clip = accel
    s = 0.8
    got = tpipe.clip_predictions(tm, torch.from_numpy(clip), K, "direct", input_scale=s)
    want = tpipe.clip_predictions(tm, torch.from_numpy(clip) * s, K, "direct")
    assert torch.equal(got, want)


# ---- the upsample tails ---------------------------------------------------------


@pytest.mark.parametrize("upsample", ["nearest_pred", "bilinear_logits_xla"])
def test_upsample_modes_match_jax(accel, upsample):
    """Mirrors ``tests/test_pipeline.py::test_nearest_pred_upsample_mode``,
    held against the JAX tail of the same name."""
    jm, v, tm, clip = accel
    clip = clip[:1]
    got = tpipe.clip_predictions(tm, torch.from_numpy(clip), K, "direct", upsample=upsample)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (1, K, HW, HW)
    jpred = np.asarray(jpipe.clip_predictions(jm, v, jnp.asarray(clip), K, "direct",
                                              upsample=upsample))
    logits = np.asarray(jpipe.clip_logits(jm, v, jnp.asarray(clip), K, "direct"))[0]
    if upsample == "nearest_pred":
        full = logits.repeat(HW // 8, axis=1).repeat(HW // 8, axis=2)[None]
        small = tpipe.clip_predictions(tm, torch.from_numpy(clip), K, "direct", full_res=False)
        assert torch.equal(got, small.repeat_interleave(16, dim=2).repeat_interleave(16, dim=3))
    else:
        full = np.asarray(j_resize(jnp.asarray(logits), (HW, HW)))[None]
        # on the CPU the fused tail runs its plain version, which is this
        assert torch.equal(got, tpipe.clip_predictions(tm, torch.from_numpy(clip), K, "direct"))
    assert_argmax_agrees(got.numpy(), jpred, full, min_agree=0.999)
    with pytest.raises(ValueError, match="upsample"):
        tpipe.clip_predictions(tm, torch.from_numpy(clip), K, "direct", upsample="cubic")


# ---- composed propagation and the cascades --------------------------------------


@pytest.mark.parametrize("cascade", ["last", "product", "mean1", "clamp"])
def test_composed_accel_matches_jax(accel, cascade):
    """Mirrors ``tests/test_pipeline.py``'s composed tests at k=4 (the flow
    and scale field warps through the bounded warp, the final one at
    D=8*(k-1))."""
    jm, v, tm, clip = accel
    jm = _knobs(jm, tm, scale_cascade=cascade)
    want = _check_logits(jm, v, tm, clip, "composed")
    pred = tpipe.clip_predictions(tm, torch.from_numpy(clip), K, "composed")
    jpred = np.asarray(jpipe.clip_predictions(jm, v, jnp.asarray(clip), K, "composed"))
    full = np.stack([np.asarray(j_resize(jnp.asarray(w), (HW, HW))) for w in want])
    assert_argmax_agrees(pred.numpy(), jpred, full, min_agree=0.999)


@pytest.mark.parametrize("cascade", ["last", "product", "clamp"])
def test_composed_dff_matches_jax(dff, f32_tap_weights, cascade):
    """DFF composes its fields through the one-hot warp (flow C=2, scale
    C=32, f32) and warps its features once at D=4*(k-1)."""
    jm, v, tm, clip = dff
    _check_logits(_knobs(jm, tm, scale_cascade=cascade), v, tm, clip, "composed")


def test_composed_equals_direct_at_k2(accel):
    """One non-key frame: nothing to compose, composed == direct (mirrors
    ``tests/test_pipeline.py::test_composed_equals_direct_at_k2``)."""
    _, _, tm, clip = accel
    frames = nchw(clip[:1, :2])
    torch.testing.assert_close(tpipe.clip_logits(tm, frames, 2, "composed"),
                               tpipe.clip_logits(tm, frames, 2, "direct"), rtol=0, atol=1e-5)


def test_composed_static_clip_consistency():
    """Static frames under flax's init (zero flow heads): the composition
    of zero flows is zero, so every frame's logits are the keyframe's
    (mirrors ``tests/test_pipeline.py::test_composed_static_clip_consistency``)."""
    tm = build_model(dict(ACCEL, name="accel", head_channels=32, dtype="float32"),
                     device="cpu", generator=torch.Generator().manual_seed(5))
    img = torch.from_numpy((np.random.default_rng(8).standard_normal((1, 3, HW, HW)) * 0.1)
                           .astype(np.float32))
    lg = tpipe.clip_logits(tm, img[:, None].repeat(1, K, 1, 1, 1), K, "composed")
    for f in range(1, K):
        torch.testing.assert_close(lg[:, f], lg[:, 0], rtol=0, atol=1e-4)


@pytest.mark.parametrize("cascade", ["mean1", "clamp"])
def test_incremental_cascades_match_jax(accel, cascade):
    """The incremental group step carries the cumulative scale product,
    field-warped along and renormalized or clamped after every step."""
    jm, v, tm, clip = accel
    _check_logits(_knobs(jm, tm, scale_cascade=cascade), v, tm, clip, "incremental")


def test_cascade_post_matches_jax():
    """Mirrors ``tests/test_pipeline.py::test_cascade_post_semantics``."""
    x = np.random.default_rng(0).uniform(0.1, 5.0, (2, 4, 4, 3)).astype(np.float32)
    assert tpipe._CASCADE_CLAMP == jpipe._CASCADE_CLAMP
    for mode in ("mean1", "clamp", "product", "last"):
        got = tpipe._cascade_post(nchw(x), mode)
        want = np.asarray(jpipe._cascade_post(jnp.asarray(x), mode))
        np.testing.assert_allclose(nhwc(got), want, rtol=1e-6, atol=1e-6)
    m1 = tpipe._cascade_post(nchw(x), "mean1")
    np.testing.assert_allclose(m1.mean(dim=(1, 2, 3)).numpy(), 1.0, atol=1e-5)
    cl = tpipe._cascade_post(nchw(x), "clamp")
    assert cl.min() >= 0.5 and cl.max() <= 2.0


def test_compose_fields_match_jax(accel):
    """Synthetic non-uniform fields (mirrors
    ``tests/test_pipeline.py::test_scale_cascade_modes_differ_beyond_k2``):
    each mode's composed fields match the JAX package's, the modes differ
    at k-1 = 3, and mean1/clamp hold their invariants."""
    jm, v, tm, _ = accel
    rng = np.random.default_rng(5)
    flow = rng.uniform(-0.5, 0.5, (1, 3, 8, 8, 2)).astype(np.float32)
    scale = np.exp(rng.normal(0, 0.6, (1, 3, 8, 8, 19))).astype(np.float32)
    outs = {}
    for mode in ("product", "mean1", "clamp", "last"):
        jf, js = jpipe._compose_fields(_knobs(jm, tm, scale_cascade=mode), v,
                                       jnp.asarray(flow), jnp.asarray(scale))
        cf, cs = tpipe._compose_fields(tm, nchw(flow), nchw(scale))
        assert_close(nhwc(cf), np.asarray(jf), rel=1e-5)
        assert_close(nhwc(cs), np.asarray(js), rel=1e-5)
        outs[mode] = nhwc(cs)
    for mode in ("mean1", "clamp", "last"):
        assert np.abs(outs[mode][:, -1] - outs["product"][:, -1]).max() > 1e-4, mode
    np.testing.assert_allclose(outs["mean1"][:, -1].mean(), 1.0, atol=1e-3)
    assert 0.5 - 1e-5 <= outs["clamp"][:, -1].min() and outs["clamp"][:, -1].max() <= 2.0 + 1e-5


def test_compose_fields_translation_math(accel):
    """Constant integer translations sum: k-1 steps of dx=1 compose to
    dx=i+1 inside the frame (mirrors
    ``tests/test_pipeline.py::test_compose_fields_translation_math``)."""
    _, _, tm, _ = accel
    tm.scale_cascade = "product"
    flow = torch.zeros((1, 3, 2, 8, 8))
    flow[:, :, 0] = 1.0
    cflow, _ = tpipe._compose_fields(tm, flow, torch.ones((1, 3, 19, 8, 8)))
    for i in range(3):
        torch.testing.assert_close(cflow[0, i, 0, :, :7 - i],
                                   torch.full((8, 7 - i), float(i + 1)), rtol=0, atol=1e-5)
    assert not cflow[:, :, 1].any()


# ---- the stacked gather ---------------------------------------------------------


def _warp_case(shape, seed):
    rng = np.random.default_rng(seed)
    N, H, W, C = shape
    feat = rng.standard_normal(shape).astype(np.float32)
    flow = rng.uniform(-3.0, 3.0, (N, H, W, 2)).astype(np.float32)
    return feat, flow


def test_stacked_gather_matches_jax():
    """Mirrors ``tests/test_warp.py::test_stacked_gather_matches_oracle``:
    the port's plain warp, one gather of all four taps, is f32 within 1e-6
    of the JAX stacked gather and of the JAX 4-gather oracle, taps past the
    image read 0; bf16 keeps its dtype and is within one bf16 ulp of the
    JAX bf16 gather."""
    feat, flow = _warp_case((2, 12, 20, 5), seed=7)
    got = bilinear_warp_plain(nchw(feat), nchw(flow))
    want = np.asarray(bilinear_warp_xla_stacked(jnp.asarray(feat), jnp.asarray(flow)))
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-6)
    oracle = np.asarray(bilinear_warp_xla(jnp.asarray(feat), jnp.asarray(flow)))
    np.testing.assert_allclose(nhwc(got), oracle, rtol=0, atol=1e-6)
    big = torch.full((2, 2, 12, 20), 1e4)
    assert not bilinear_warp_plain(nchw(feat), big).any()

    got16 = bilinear_warp_plain(nchw(feat).to(torch.bfloat16), nchw(flow))
    assert got16.dtype == torch.bfloat16
    want16 = np.asarray(bilinear_warp_xla_stacked(jnp.asarray(feat, jnp.bfloat16),
                                                  jnp.asarray(flow)), np.float32)
    np.testing.assert_allclose(nhwc(got16.float()), want16, rtol=2.0 ** -8, atol=1e-6)


def test_stacked_dispatch():
    """``gather='stacked'`` names the unbounded plain form, as 'taps' does:
    it runs where the plain form would (``use_pallas=False``, or C > 64)."""
    feat, flow = _warp_case((1, 8, 16, 70), seed=9)
    x, f = nchw(feat), nchw(flow)
    plain = bilinear_warp_plain(x, f)
    assert torch.equal(bilinear_warp(x, f, gather="stacked"), plain)
    assert torch.equal(bilinear_warp(x, f, gather="taps"), plain)
    assert torch.equal(bilinear_warp(x[:, :19], f, use_pallas=False, gather="stacked"),
                       bilinear_warp_plain(x[:, :19], f))


def test_stacked_model_matches_jax():
    """An accel model with ``warp_gather: stacked`` and the kernel off, so
    the score-map warps take the stacked gather on both sides."""
    jm, v, tm, clip = _pair(dict(ACCEL, warp_gather="stacked", use_pallas_warp=False), seed=121)
    for propagate in ("direct", "incremental"):
        _check_logits(jm, v, tm, clip, propagate)
