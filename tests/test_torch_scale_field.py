"""``use_scale_field: false`` in the port against ``accel_tpu``: FlowNet
without its scale-field head (the scale is all ones), the warp modulating
nothing, incremental propagation on the product cascade whatever
``scale_cascade`` says, and DFF's one-hot warp taking no scale.

A tiny accel model (R18/R18, 128x128, head 32, f32) and a tiny DFF model
(R18, head 128, 256x256, FlowNet at 1/4 input and half width, one-hot
warp, native dtype, D=4), each with the knob off and the same seeded
weights on both sides (the bridge takes a flax tree without the head), one
keyframe group of four frames. Logits within 1e-4 * (1 + max|ref|); class
maps agree on >= 0.999 of the pixels, every disagreement at a near-tie of
the reference logits. DFF runs with f32 tap weights on both sides
(``test_torch_dff.py`` says why)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (assert_argmax_agrees, assert_close, bridged_models,  # noqa: F401
                          f32_tap_weights, nchw, nhwc)

import accel_tpu_torch.models.accel as taccel
import accel_tpu_torch.ops.warp as twarp
from accel_tpu.core import pipeline as jpipe
from accel_tpu.core.serving import VideoSegmenter as JVideoSegmenter
from accel_tpu.ops.upsample import resize_bilinear as j_resize
from accel_tpu_torch.core import pipeline as tpipe
from accel_tpu_torch.core.predictor import make_key_cur_predictors
from accel_tpu_torch.core.serving import VideoSegmenter

torch.set_num_threads(2)
K = 4
ACCEL = dict(family="accel", ref_depth=18, update_depth=18, head_channels=32,
             use_scale_field=False, scale_cascade="last")
DFF = dict(family="dff", ref_depth=18, head_channels=128, flow_input_downscale=4,
           flow_width_mult=0.5, warp_max_disp=4, warp_dtype="native", warp_gather="onehot",
           use_scale_field=False)


def _clip(hw: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((1, K, hw, hw, 3)) * 0.5
            ).astype(np.float32)


@pytest.fixture(scope="module")
def accel():
    return (*bridged_models(ACCEL, 128, seed=71), _clip(128, 72))


@pytest.fixture(scope="module")
def dff():
    return (*bridged_models(DFF, 256, seed=73), _clip(256, 74))


def _check_clip(jm, v, tm, clip, propagate):
    """Clip logits at 1e-4 and the full-resolution class maps (the JAX
    serving tail on the JAX logits) at >= 0.999."""
    want = np.asarray(jpipe.clip_logits(jm, v, jnp.asarray(clip), K, propagate))
    got = tpipe.clip_logits(tm, nchw(clip), K, propagate)
    assert_close(nhwc(got), want)
    hw = clip.shape[2]
    full = np.asarray(j_resize(jnp.asarray(want[0]), (hw, hw)))[None]
    pred = tpipe.clip_predictions(tm, torch.from_numpy(clip), K, propagate)
    assert_argmax_agrees(pred.numpy(), full.argmax(-1), full, min_agree=0.999)
    return full


def test_no_scale_field_head_and_a_scale_of_ones(accel):
    jm, v, tm, clip = accel
    assert "scale_field" not in v["params"]["flownet"]
    assert not hasattr(tm.flownet, "scale_field")
    with torch.no_grad():
        flow, scale = tm.flow(nchw(clip[:, 1]), nchw(clip[:, 0]))
    assert tuple(scale.shape) == (1, 19, 8, 8) and bool((scale == 1).all())
    # the flow moves content, inside the port's warp clamp (D=8), where the
    # JAX package's CPU warp (unclamped) computes the same
    assert 0.5 < float(flow.abs().max()) < 8.0


@pytest.mark.parametrize("propagate", ["direct", "incremental"])
def test_accel_clip_matches_jax(accel, propagate):
    _check_clip(*accel, propagate)


def test_push_frame_matches_jax(accel):
    """Per-frame serving under incremental propagation: the port's
    ``push_clip`` against the JAX ``VideoSegmenter``'s, and against the
    port's own ``push_group``. Without the scale field the key/cur protocol
    also takes 'mean1' and 'clamp' (the product cascade is served)."""
    jm, v, tm, clip = accel
    frames = torch.from_numpy(clip)
    loop = VideoSegmenter(tm, interval=K, propagate="incremental").push_clip(frames)
    group = VideoSegmenter(tm, interval=K, propagate="incremental").push_group(frames)
    jloop = np.asarray(JVideoSegmenter(jm, v, interval=K, propagate="incremental").push_clip(
        jnp.asarray(clip)))
    want = np.asarray(jpipe.clip_logits(jm, v, jnp.asarray(clip), K, "incremental"))
    full = np.asarray(j_resize(jnp.asarray(want[0]), (128, 128)))[None]
    assert_argmax_agrees(loop.numpy(), jloop, full, min_agree=0.999)
    assert_argmax_agrees(loop.numpy(), group.numpy(), full, min_agree=0.999)
    tm.scale_cascade = "mean1"
    try:
        make_key_cur_predictors(tm, propagate="incremental")
    finally:
        tm.scale_cascade = "last"


def test_dff_onehot_warps_without_a_scale(dff, f32_tap_weights, monkeypatch):
    """DFF direct with the one-hot warp: the warp goes through
    ``bilinear_warp``'s ``warp_onehot(feat, flow, None, D)``, never the
    modulated form."""
    jm, v, tm, clip = dff
    scales = []
    onehot = twarp.warp_onehot

    def recording(feat, flow, scale=None, *args, **kwargs):
        scales.append(scale)
        return onehot(feat, flow, scale, *args, **kwargs)

    monkeypatch.setattr(twarp, "warp_onehot", recording)
    monkeypatch.setattr(taccel, "warp_onehot", functools.partial(pytest.fail, "modulated warp"))
    _check_clip(jm, v, tm, clip, "direct")
    assert scales and all(s is None for s in scales)
