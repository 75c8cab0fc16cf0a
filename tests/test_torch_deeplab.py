"""The port's per-frame DeepLab family end to end vs
``accel_tpu.core.pipeline``: a tiny deeplab model (R18, head 128, 256x256,
f32) with ``dilated_conv: pallas``, so that on the JAX side layer4's
dilated convs and fc6 run the Pallas kernel in interpret mode; F=10 asked
at interval 5, which the family runs as ten keyframes.

Logits within 1e-4 * (1 + max|ref|); class maps agree on >= 0.999 of the
pixels with the JAX serving tail applied to the JAX logits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_argmax_agrees, assert_close, nchw, nhwc, seeded_variables

from accel_tpu.core import pipeline as jpipe
from accel_tpu.core.serving import VideoSegmenter as JVideoSegmenter
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
            dilated_conv="pallas")


@pytest.fixture(scope="module")
def deeplab():
    jm = JAccelNet(family="deeplab", dtype=jnp.float32, **TINY)
    cur = jnp.zeros((1, HW, HW, 3))
    v = seeded_variables(jm, cur, cur, jnp.ones((1,)), train=False, seed=41)
    tm = AccelNet(family="deeplab", **TINY, device="cpu", dtype=torch.float32)
    load_flax_variables(tm, v)
    clip = (np.random.default_rng(42).standard_normal((1, 10, HW, HW, 3)) * 0.5
            ).astype(np.float32)
    return jm, v, tm, clip


def test_deeplab_clip_matches_jax(deeplab):
    jm, v, tm, clip = deeplab
    want = np.asarray(jpipe.clip_logits(jm, v, jnp.asarray(clip), 5))
    got = tpipe.clip_logits(tm, nchw(clip), 5)
    assert tuple(got.shape) == (1, 10, 19, 16, 16)
    assert_close(nhwc(got), want)

    pred = tpipe.clip_predictions(tm, torch.from_numpy(clip), 5)
    flat = jnp.asarray(want[0])
    jpred = np.asarray(upsample_argmax_or_oracle(flat, (HW, HW)))[None]
    assert_argmax_agrees(pred.numpy(), jpred, np.asarray(j_resize(flat, (HW, HW)))[None],
                         min_agree=0.999)


def test_every_frame_is_a_keyframe(deeplab):
    """k is forced to 1: each frame's logits are the branch on that frame,
    and push_group serves a group of 5 as five keyframes."""
    _, _, tm, clip = deeplab
    frames = nchw(clip[:, :5])
    got = tpipe.clip_logits(tm, frames, 5)
    with torch.no_grad():
        for f in range(5):
            torch.testing.assert_close(got[:, f], tm.ref_net(frames[:, f]))
    seg = VideoSegmenter(tm, interval=5, propagate="incremental")
    pred = seg.push_group(torch.from_numpy(clip[:, :5]))
    assert torch.equal(pred, tpipe.clip_predictions(tm, torch.from_numpy(clip[:, :5]), 1))
    assert seg.is_keyframe_next


def test_deeplab_has_only_its_modules(deeplab):
    _, _, tm, _ = deeplab
    assert [name for name, _ in tm.named_children()] == ["ref_net"]
    assert tm.warp_tensor == "scores"


@pytest.fixture(scope="module")
def short_groups():
    """A tiny deeplab model (R18, head 32, 64x64, f32) and 6 frames."""
    knobs = dict(ref_depth=18, num_classes=19, feat_stride=16, head_channels=32)
    jm = JAccelNet(family="deeplab", dtype=jnp.float32, **knobs)
    cur = jnp.zeros((1, 64, 64, 3))
    v = seeded_variables(jm, cur, cur, jnp.ones((1,)), train=False, seed=43)
    tm = AccelNet(family="deeplab", **knobs, device="cpu", dtype=torch.float32)
    load_flax_variables(tm, v)
    clip = (np.random.default_rng(44).standard_normal((1, 6, 64, 64, 3)) * 0.5
            ).astype(np.float32)
    return jm, v, tm, clip


def test_push_group_serves_short_deeplab_groups(short_groups):
    """The family's k is 1, so a group of 3 at interval 5 is served, as by
    ``accel_tpu``'s ``VideoSegmenter``, and the next group is too: every
    group leaves the schedule at a keyframe."""
    jm, v, tm, clip = short_groups
    seg = VideoSegmenter(tm, interval=5)
    jseg = JVideoSegmenter(jm, v, interval=5)
    for g in range(2):
        assert seg.is_keyframe_next and jseg.is_keyframe_next
        frames = clip[:, 3 * g:3 * g + 3]
        got = seg.push_group(torch.from_numpy(frames))
        want = np.asarray(jseg.push_group(jnp.asarray(frames)))
        assert got.dtype == torch.uint8 and tuple(got.shape) == (1, 3, 64, 64)
        logits = np.asarray(jpipe.clip_logits(jm, v, jnp.asarray(frames), 5))[0]
        full = np.asarray(j_resize(jnp.asarray(logits), (64, 64)))[None]
        assert_argmax_agrees(got.numpy(), want, full, min_agree=0.999)
    assert seg.is_keyframe_next
    seg.reset()
    assert seg.is_keyframe_next
