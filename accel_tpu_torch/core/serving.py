"""Streaming video-segmentation API (counterpart of
``accel_tpu/core/serving.py``).

``VideoSegmenter`` owns the keyframe schedule and the propagation cache
(the propagated tensor and the FlowNet anchor, on the model's device):

    seg = VideoSegmenter(model, interval=5)
    for frame in camera:                # (1, H, W, 3) normalized
        pred = seg.push_frame(frame)    # (1, H, W) uint8 class map

``push_frame`` runs the key or the cur predictor of
``core/predictor.py`` on each frame (the span ``serve.key`` or
``serve.cur``); ``push_group`` serves a whole keyframe group per call
through the batched clip pipeline (``serve.group``; spans:
``utils/profiler.py``). On a CUDA device each of the three steps is served
from one CUDA graph an input signature (``core/graphs.py``), and the
segmenters of one model alive at once, called from one thread, share
those graphs: a segmenter per camera costs no graph of its own.
"""

from __future__ import annotations

import functools
import weakref

import torch

from accel_tpu_torch.core.graphs import CallGraphs
from accel_tpu_torch.core.pipeline import clip_predictions
from accel_tpu_torch.core.predictor import DataBatch, make_key_cur_predictors
from accel_tpu_torch.utils.profiler import span, spanned


class _Steps:
    """The serving steps of one model, each a ``CallGraphs`` over the
    model's parameters and buffers: ``key`` (frame) and ``cur`` (frame,
    anchor, propagated tensor) -> {'prop', 'anchor_small', 'pred'}, the
    predictors of ``make_key_cur_predictors``, and ``group`` (frames) ->
    class maps, ``clip_predictions``."""

    def __init__(self, model, interval: int, full_res: bool, propagate: str):
        key_p, cur_p = make_key_cur_predictors(model, full_res_pred=full_res,
                                               propagate=propagate)
        watched = [*model.parameters(), *model.buffers()]
        self.key = CallGraphs(lambda frame: key_p.predict(DataBatch([frame]))[0], watched)
        self.cur = CallGraphs(
            lambda frame, anchor_small, prop: cur_p.predict(
                DataBatch([frame, anchor_small, prop]))[0], watched)
        self.group = CallGraphs(
            functools.partial(clip_predictions, model, interval=interval, propagate=propagate,
                              full_res=full_res), watched)


# the steps of the segmenters alive, by model and serving settings, and
# by the model's scale cascade, which the predictors read when they are
# made; an entry lives as long as a segmenter holds it (and holds the model)
_shared: weakref.WeakValueDictionary = weakref.WeakValueDictionary()


def _steps(model, interval: int, full_res: bool, propagate: str) -> _Steps:
    key = (id(model), interval, full_res, propagate, model.scale_cascade)
    steps = _shared.get(key)
    if steps is None:
        steps = _shared[key] = _Steps(model, interval, full_res, propagate)
    return steps


class VideoSegmenter:
    def __init__(self, model, interval: int = 5, full_res: bool = True,
                 propagate: str = "direct"):
        """``propagate`` must match the training objective: 'direct'
        anchors every non-key frame at the keyframe; 'incremental'
        cascades frame to frame. Raises ``ValueError`` where the key/cur
        protocol cannot serve the model (``make_key_cur_predictors``).

        The segmenters of one model with the same settings (and the same
        ``model.scale_cascade``) alive at once share their steps' CUDA
        graphs (``core/graphs.py``), and are called from one thread on one
        stream: a step's first call of a signature, by any of them, runs
        eagerly, the second is captured, and every later one replays. Their
        graphs hold a memory pool of about one eager call's peak each (key,
        cur, group of each shape served) for as long as one of them lives.
        They read the model's parameters and buffers in place: an in-place
        write (``load_state_dict``) makes the next calls run eagerly and
        capture again; replacing a parameter tensor is not seen."""
        self.interval = int(interval)
        self.model = model
        self.propagate = propagate
        self._steps = _steps(model, self.interval, full_res, propagate)
        self.reset()

    def reset(self):
        """Drop the propagation state (e.g. on a scene cut or a new stream)."""
        self._t = 0
        self._prop = None
        self._anchor_small = None

    @property
    def is_keyframe_next(self) -> bool:
        return self._t % self.interval == 0 or self._prop is None

    def push_frame(self, frame) -> torch.Tensor:
        """frame (1, H, W, 3) normalized -> (1, H, W) uint8 prediction on
        the model's device. The ``deeplab`` family runs every frame as a
        keyframe.

        On a CUDA device a replayed frame copies the frame (and, for a
        non-key frame, the carried anchor and propagated tensor) into the
        step's static buffers, launches its graph once and keeps copies of
        the outputs; a direct non-key frame keeps the keyframe's tensors
        as they are."""
        if self.is_keyframe_next or self.model.family == "deeplab":
            with span("serve.key"):
                out = self._steps.key(frame)
        else:
            with span("serve.cur"):
                out = self._steps.cur(frame, self._anchor_small, self._prop)
        self._prop = out["prop"]
        self._anchor_small = out["anchor_small"]
        self._t += 1
        return out["pred"]

    def push_clip(self, clip) -> torch.Tensor:
        """clip (1, F, H, W, 3) -> (1, F, H, W) uint8, one ``push_frame``
        per frame (``push_group`` batches a group's frames)."""
        return torch.stack([self.push_frame(clip[:, i]) for i in range(clip.shape[1])], dim=1)

    @spanned("serve.group")
    def push_group(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, k, H, W, 3), keyframe first -> (B, k, H, W) uint8.

        One batched pipeline call per keyframe group; the schedule must be
        at a group boundary (``is_keyframe_next``). The ``deeplab`` family
        runs every frame as a keyframe and takes a group of any length.

        On a CUDA device the first group of a shape runs eagerly, the
        second is captured as a CUDA graph, and every later one replays it
        (one launch) and returns its own copy of the maps (``__init__``)."""
        if frames.shape[1] != self.interval and self.model.family != "deeplab":
            raise ValueError(f"group length {frames.shape[1]} != interval {self.interval}")
        if not self.is_keyframe_next:
            raise ValueError(
                "push_group mid-group: schedule is not at a keyframe "
                f"(t={self._t}, interval={self.interval}); reset() or finish the group "
                "with push_frame")
        pred = self._steps.group(frames)
        # groups are self-contained: the per-frame cache is dropped
        self._t += frames.shape[1]
        self._prop = None
        self._anchor_small = None
        return pred
