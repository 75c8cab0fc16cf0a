"""The port's DFF clip inference end to end vs ``accel_tpu.core.pipeline``:
a tiny dff model (R18, head 128, 256x256 so that FlowNet's input at
``flow_input_downscale=4`` divides by 64, FlowNet width 0.5, f32) with the
same seeded weights on both sides and live flow heads, F=10 at k=5 so two
keyframe groups run. On the JAX side every one-hot warp and, under
``pallas_fc6``, fc6 run their Pallas kernels in interpret mode.

Logits within 1e-4 * (1 + max|ref|); full-resolution class maps agree on
>= 0.999 of the pixels with the JAX serving tail applied to the JAX logits,
and every disagreement sits at a near-tie.

The one-hot warp rounds its tap weights and feature values to bf16 by
contract. The two packages' f32 convs differ by ~5e-6, and where a value
lies that close to a bf16 rounding midpoint the two sides round it to
neighbouring bf16 values: one ulp (2^-8 relative) on a few dozen of the
32 k warped values per frame. So the path is held at 1e-4 with the tap
weights in f32 on both sides (``f32_tap_weights``), where nothing rounds;
the bf16 rounding itself is pinned at identical inputs in
``test_torch_warp_onehot.py``; and the bf16 path end to end is held to one
bf16 ulp, 2^-8 * (1 + max|ref|), with its class maps agreeing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (assert_argmax_agrees, assert_close, f32_tap_weights, nchw, nhwc,  # noqa: F401
                          seeded_variables)

from accel_tpu.core import pipeline as jpipe
from accel_tpu.models.accel import AccelNet as JAccelNet
from accel_tpu.ops.upsample import resize_bilinear as j_resize
from accel_tpu.ops.upsample_argmax import upsample_argmax_or_oracle
from accel_tpu_torch.convert import load_flax_variables
from accel_tpu_torch.core import pipeline as tpipe
from accel_tpu_torch.core.serving import VideoSegmenter
from accel_tpu_torch.models.accel import AccelNet

torch.set_num_threads(2)
HW = 256
TINY = dict(ref_depth=18, num_classes=19, feat_stride=16, head_channels=128,
            flow_input_downscale=4, flow_width_mult=0.5, warp_max_disp=4)
# the bench's DFF serving knobs (bench.py's dff row)
SERVING = dict(warp_dtype="native", warp_gather="onehot")


@pytest.fixture(scope="module")
def dff():
    jm = JAccelNet(family="dff", dtype=jnp.float32, **TINY, **SERVING)
    cur = jnp.zeros((1, HW, HW, 3))
    v = seeded_variables(jm, cur, cur, jnp.ones((1,)), train=False, seed=31)
    clip = (np.random.default_rng(32).standard_normal((1, 10, HW, HW, 3)) * 0.5
            ).astype(np.float32)
    return jm, v, clip


def _torch_model(v, **knobs):
    tm = AccelNet(family="dff", **TINY, **knobs, device="cpu", dtype=torch.float32)
    load_flax_variables(tm, v)
    return tm


def test_flow_is_live_and_crosses_the_bound(dff):
    """The seeded flow heads move content by several feature pixels, and
    some |flow_y| exceed D=4, so the one-hot warp's clamp is exercised."""
    jm, v, clip = dff
    flow, scale = jm.apply(v, jnp.asarray(clip[:, 1]), jnp.asarray(clip[:, 0]), method="flow")
    assert flow.shape == (1, 16, 16, 2) and scale.shape == (1, 16, 16, 128)
    fy = np.abs(np.asarray(flow[..., 1]))
    assert 0.5 < float(np.abs(np.asarray(flow)).max()) < 16.0
    assert float(fy.max()) > 4.0 and float((fy < 4.0).mean()) > 0.5


@pytest.mark.parametrize("propagate,knobs", [
    ("direct", dict(SERVING)),                                        # fused epilogue
    ("incremental", dict(SERVING, scale_cascade="last")),             # unfused one-hot
    ("incremental", dict(SERVING, scale_cascade="product")),
    ("direct", dict(warp_dtype="native", warp_gather="taps")),        # C > 64 plain gather
    ("direct", dict(SERVING, scale_field_norm="mean1", warp_gain_fold=True)),
    ("direct", dict(SERVING, dilated_conv="pallas_fc6")),
], ids=["direct-onehot", "incremental-last", "incremental-product", "direct-taps",
        "direct-gain-fold", "direct-pallas-fc6"])
def test_dff_clip_matches_jax(dff, f32_tap_weights, propagate, knobs):
    _check_clip(dff, propagate, knobs, rel=1e-4, margin_rel=1e-5)


@pytest.mark.parametrize("propagate,knobs", [
    ("direct", dict(SERVING)),
    ("incremental", dict(SERVING, scale_cascade="last")),
], ids=["direct-onehot", "incremental-last"])
def test_dff_clip_bf16_tap_weights(dff, propagate, knobs):
    """The serving numerics (bf16 tap weights): within one bf16 ulp."""
    _check_clip(dff, propagate, knobs, rel=2.0 ** -8, margin_rel=2.0 ** -8)


def _check_clip(dff, propagate, knobs, rel, margin_rel):
    jm, v, clip = dff
    jm = jm.clone(**knobs)
    tm = _torch_model(v, **knobs)
    want = np.asarray(jpipe.clip_logits(jm, v, jnp.asarray(clip), 5, propagate))
    got = tpipe.clip_logits(tm, nchw(clip), 5, propagate)
    assert tuple(got.shape) == (1, 10, 19, 16, 16)
    assert_close(nhwc(got), want, rel=rel)

    pred = tpipe.clip_predictions(tm, torch.from_numpy(clip), 5, propagate)
    assert pred.dtype == torch.uint8 and tuple(pred.shape) == (1, 10, HW, HW)
    flat = jnp.asarray(want[0])
    jpred = np.asarray(upsample_argmax_or_oracle(flat, (HW, HW)))[None]
    assert_argmax_agrees(pred.numpy(), jpred, np.asarray(j_resize(flat, (HW, HW)))[None],
                         min_agree=0.999, margin_rel=margin_rel)


def test_push_group_serves_dff(dff):
    _, v, clip = dff
    tm = _torch_model(v, **SERVING)
    seg = VideoSegmenter(tm, interval=5, propagate="direct")
    frames = torch.from_numpy(clip)
    for g in range(2):
        got = seg.push_group(frames[:, 5 * g:5 * g + 5])
        want = tpipe.clip_predictions(tm, frames[:, 5 * g:5 * g + 5], 5, "direct")
        assert torch.equal(got, want)


def test_dff_has_only_its_modules(dff):
    _, v, _ = dff
    tm = _torch_model(v, **SERVING)
    assert not hasattr(tm, "update_net") and not hasattr(tm, "fusion")
    assert tm.flownet.scale_field.out_channels == 128
    assert tm.warp_tensor == "features"


@pytest.mark.parametrize("propagate,knobs", [
    ("direct", dict(SERVING)),
    ("incremental", dict(SERVING, scale_cascade="last")),
], ids=["direct-onehot", "incremental-last"])
def test_dff_serving_recipe_in_bf16(dff, propagate, knobs):
    """The bench's DFF recipe as served: a bf16 model, the one-hot warp in
    the native dtype (bf16 features, bf16 scale field resized on the CPU).
    The two packages' bf16 runs round at other points and differ about as
    much as JAX bf16 differs from JAX f32 (~1.5e-2 * max|logits|), so the
    logits are held within 2e-2 * (1 + max|ref|) and the class maps to
    >= 0.98; a misplaced cast moves either far past that."""
    jm, v, clip = dff
    jm = jm.clone(dtype=jnp.bfloat16, **knobs)
    tm = AccelNet(family="dff", **TINY, **knobs, device="cpu", dtype=torch.bfloat16)
    load_flax_variables(tm, v)
    want = np.asarray(jpipe.clip_logits(jm, v, jnp.asarray(clip), 5, propagate), np.float32)
    got = tpipe.clip_logits(tm, nchw(clip), 5, propagate)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 10, 19, 16, 16)
    assert_close(nhwc(got), want, rel=2e-2)
    pred = tpipe.clip_predictions(tm, torch.from_numpy(clip), 5, propagate)
    jpred = np.asarray(upsample_argmax_or_oracle(jnp.asarray(want[0]), (HW, HW)))[None]
    agree = float((pred.numpy() == jpred).mean())
    assert agree >= 0.98, agree
