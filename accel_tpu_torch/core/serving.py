"""Streaming video-segmentation API (counterpart of
``accel_tpu/core/serving.py``).

``push_group`` serves one keyframe group per call through the batched clip
pipeline. The per-frame interface (``push_frame``, ``push_clip``) needs the
key/cur predictors of ``accel_tpu/core/predictor.py``, which are not ported
yet.
"""

from __future__ import annotations

import torch

from accel_tpu_torch.core.pipeline import clip_predictions


class VideoSegmenter:
    def __init__(self, model, interval: int = 5, full_res: bool = True,
                 propagate: str = "direct"):
        """``propagate`` must match the training objective: 'direct'
        anchors every non-key frame at the keyframe; 'incremental' cascades
        frame to frame."""
        self.interval = int(interval)
        self.model = model
        self.propagate = propagate
        self._full_res = full_res
        self.reset()

    def reset(self):
        """Drop the propagation state (e.g. on a scene cut or a new stream)."""
        self._t = 0
        # the per-frame propagation cache of the reference; push_group's
        # groups are self-contained, so it stays empty until push_frame is
        # ported
        self._prop = None

    @property
    def is_keyframe_next(self) -> bool:
        return self._t % self.interval == 0 or self._prop is None

    def push_frame(self, frame):
        raise NotImplementedError(
            "push_frame needs make_key_cur_predictors (accel_tpu/core/predictor.py), "
            "which is not ported yet; use push_group")

    def push_clip(self, clip):
        raise NotImplementedError(
            "push_clip needs make_key_cur_predictors (accel_tpu/core/predictor.py), "
            "which is not ported yet; use push_group")

    def push_group(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, k, H, W, 3), keyframe first -> (B, k, H, W) uint8.

        One batched pipeline call per keyframe group; the schedule must be
        at a group boundary (``is_keyframe_next``). The ``deeplab`` family
        runs every frame as a keyframe and takes a group of any length."""
        if frames.shape[1] != self.interval and self.model.family != "deeplab":
            raise ValueError(f"group length {frames.shape[1]} != interval {self.interval}")
        if not self.is_keyframe_next:
            raise ValueError(
                "push_group mid-group: schedule is not at a keyframe "
                f"(t={self._t}, interval={self.interval}); call reset()")
        pred = clip_predictions(self.model, frames, self.interval, self.propagate,
                                full_res=self._full_res)
        self._t += frames.shape[1]
        self._prop = None
        return pred
