"""The port's per-frame serving (``core/predictor.py``, ``VideoSegmenter.push_frame``
and ``push_clip``) against ``accel_tpu``'s on bridged weights, and against
the port's own batched ``push_group``.

Tiny f32 models of the three families (R18, head 32, 128x128; FlowNet at
half width for dff) with the same seeded weights on both sides and live
flow heads, 8 frames at interval 4, so the schedule crosses a group
boundary. Class maps agree on >= 0.999 of the pixels, every disagreement
at a near-tie of the port's clip logits (the logits themselves are held at
1e-4 by ``test_torch_pipeline.py``, ``test_torch_dff.py`` and
``test_torch_deeplab.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_parity import assert_argmax_agrees, bridged_models, nchw, nhwc

from accel_tpu.core import pipeline as jpipe
from accel_tpu.core.predictor import make_key_cur_predictors as j_make_key_cur_predictors
from accel_tpu.core.serving import VideoSegmenter as JVideoSegmenter
from accel_tpu_torch.core import pipeline as tpipe
from accel_tpu_torch.core.predictor import DataBatch, Predictor, make_key_cur_predictors
from accel_tpu_torch.core.serving import VideoSegmenter

torch.set_num_threads(2)
HW, K, FRAMES = 128, 4, 8
FAMILIES = {
    "accel": dict(family="accel", ref_depth=18, update_depth=18, head_channels=32),
    "dff": dict(family="dff", ref_depth=18, head_channels=32, flow_width_mult=0.5),
    "deeplab": dict(family="deeplab", ref_depth=18, head_channels=32),
}


def _pair(knobs: dict, seed: int):
    clip = (np.random.default_rng(seed + 1).standard_normal((1, FRAMES, HW, HW, 3)) * 0.5
            ).astype(np.float32)
    return (*bridged_models(knobs, HW, seed), clip)


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    jm, v, tm, clip = _pair(FAMILIES[request.param], seed=51 + 10 * len(request.param))
    if request.param != "deeplab":
        # the port clamps the narrow-map warp to +-8 as the TPU kernel does;
        # the JAX package's CPU warp does not, so the flow stays inside
        flow, _ = jm.apply(v, jnp.asarray(clip[:, 1]), jnp.asarray(clip[:, 0]), method="flow")
        m = float(np.abs(np.asarray(flow)).max())
        assert 0.5 < m < 8.0, m
    return request.param, jm, v, tm, clip


def _full_res_logits(tm, clip, propagate) -> np.ndarray:
    """The port's clip logits upsampled to the frames, channels last: the
    margins the class-map checks read."""
    logits = tpipe.clip_logits(tm, nchw(clip), K, propagate)[0]
    up = F.interpolate(logits, size=(HW, HW), mode="bilinear", align_corners=False)
    return nhwc(up)[None]


@pytest.mark.parametrize("propagate", ["direct", "incremental"])
def test_per_frame_loop_matches_push_group(family, propagate):
    """push_clip (one push_frame per frame) equals push_group on the same
    frames, and the JAX package's push_clip (mirrors
    ``tests/test_predictor.py::test_push_group_matches_per_frame_loop``)."""
    _, jm, v, tm, clip = family
    frames = torch.from_numpy(clip)
    seg = VideoSegmenter(tm, interval=K, propagate=propagate)
    loop = seg.push_clip(frames)
    assert loop.dtype == torch.uint8 and tuple(loop.shape) == (1, FRAMES, HW, HW)
    assert seg.is_keyframe_next  # t=8, a group boundary
    grouped = VideoSegmenter(tm, interval=K, propagate=propagate)
    group = torch.cat([grouped.push_group(frames[:, g:g + K]) for g in range(0, FRAMES, K)],
                      dim=1)
    full = _full_res_logits(tm, clip, propagate)
    assert_argmax_agrees(loop.numpy(), group.numpy(), full, min_agree=0.999)

    jseg = JVideoSegmenter(jm, v, interval=K, propagate=propagate)
    jloop = np.asarray(jseg.push_clip(jnp.asarray(clip)))
    assert_argmax_agrees(loop.numpy(), jloop, full, min_agree=0.999)


@pytest.mark.parametrize("cascade", ["last", "product"])
def test_streaming_incremental_matches_clip(cascade):
    """The key/cur predictors driven by hand under incremental propagation
    reproduce the clip pipeline's semantics for the cascade (mirrors
    ``tests/test_predictor.py::test_streaming_incremental_last_matches_clip_scan``)."""
    jm, v, tm, clip = _pair(FAMILIES["accel"], seed=61)
    jm = jm.clone(scale_cascade=cascade)
    tm.scale_cascade = cascade
    kp, cp = make_key_cur_predictors(tm, propagate="incremental")
    preds, prop, anchor = [], None, None
    for i in range(K):
        frame = torch.from_numpy(clip[:, i])
        out = (kp.predict(DataBatch([frame])) if i == 0
               else cp.predict(DataBatch([frame, anchor, prop])))[0]
        prop, anchor = out["prop"], out["anchor_small"]
        preds.append(out["pred"])
    loop = torch.stack(preds, dim=1).numpy()
    want = tpipe.clip_predictions(tm, torch.from_numpy(clip[:, :K]), K, "incremental").numpy()
    full = _full_res_logits(tm, clip[:, :K], "incremental")
    assert_argmax_agrees(loop, want, full, min_agree=0.999)
    jwant = np.asarray(jpipe.clip_predictions(jm, v, jnp.asarray(clip[:, :K]), K, "incremental"))
    assert_argmax_agrees(loop, jwant, full, min_agree=0.999)


def test_streaming_rejects_unrepresentable_cascade():
    """mean1/clamp need a cumulative-product stream the key/cur protocol
    does not carry: refused under incremental, as in the reference, and
    served under direct (mirrors
    ``tests/test_predictor.py::test_streaming_rejects_unrepresentable_cascade``)."""
    jm, v, tm, _ = _pair(FAMILIES["accel"], seed=71)
    for mode in ("mean1", "clamp"):
        tm.scale_cascade = mode
        with pytest.raises(ValueError, match="streaming"):
            make_key_cur_predictors(tm, propagate="incremental")
        with pytest.raises(ValueError, match="streaming"):
            VideoSegmenter(tm, interval=K, propagate="incremental")
        with pytest.raises(ValueError, match="streaming"):
            j_make_key_cur_predictors(jm.clone(scale_cascade=mode), v, propagate="incremental")
        make_key_cur_predictors(tm, propagate="direct")
    with pytest.raises(ValueError, match="propagate"):
        make_key_cur_predictors(tm, propagate="composed")


def test_predictor_signature_and_predict():
    """The reference's argument names (symbol, data_names, context);
    predict returns one dict and moves inputs to the predictor's device
    (mirrors
    ``tests/test_predictor.py::test_predictor_signature_and_predict``)."""
    _, _, tm, _ = _pair(FAMILIES["accel"], seed=81)

    def apply_fn(image):
        prop = tm.ref_propagated(image.permute(0, 3, 1, 2))
        return {"prop": prop, "pred": prop.argmax(dim=1).to(torch.uint8)}

    pred = Predictor(apply_fn, data_names=("data",), context="cpu")
    out = pred.predict(DataBatch([np.zeros((1, HW, HW, 3), np.float32)]))
    assert isinstance(out, list) and len(out) == 1
    assert tuple(out[0]["prop"].shape) == (1, 19, 8, 8)
    assert tuple(out[0]["pred"].shape) == (1, 8, 8) and out[0]["pred"].dtype == torch.uint8
    assert Predictor(lambda x: x * 2, ("data",)).predict(DataBatch([torch.ones(2)]))[0][
        "output"].tolist() == [2.0, 2.0]
    with pytest.raises(ValueError, match="inputs"):
        pred.predict(DataBatch([]))


def test_video_segmenter_schedule():
    """The keyframe schedule of push_frame (mirrors
    ``tests/test_predictor.py::test_video_segmenter_streaming``); a
    stride-level push_frame equals the stride-level clip pipeline."""
    _, _, tm, clip = _pair(FAMILIES["accel"], seed=91)
    seg = VideoSegmenter(tm, interval=3, full_res=False)
    frames = torch.from_numpy(clip)
    preds = [seg.push_frame(frames[:, i]) for i in range(7)]
    assert all(p.dtype == torch.uint8 and tuple(p.shape) == (1, 8, 8) for p in preds)
    assert seg.is_keyframe_next is False  # t=7, next key at 9
    want = tpipe.clip_predictions(tm, frames[:, :6], 3, "direct", full_res=False)
    assert_argmax_agrees(torch.stack(preds[:6], dim=1).numpy(), want.numpy(),
                         nhwc(tpipe.clip_logits(tm, nchw(clip[:, :6]), 3, "direct")),
                         min_agree=0.999)
    seg.reset()
    assert seg.is_keyframe_next
