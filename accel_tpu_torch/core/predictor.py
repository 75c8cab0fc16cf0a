"""The reference's per-frame inference API (counterpart of
``accel_tpu/core/predictor.py``: ``DataBatch``, ``Predictor``,
``make_key_cur_predictors``).

A keyframe runs the key predictor, which returns the tensor to propagate;
every other frame runs the cur predictor with that cached tensor fed back
as an input, the reference's two-executor protocol. The weights live in
the ``nn.Module``; a predictor runs its function under
``torch.inference_mode()`` on the model's device.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any

import torch

from accel_tpu_torch.ops.upsample_argmax import upsample_argmax


class DataBatch:
    """The ``mx.io.DataBatch`` shape: input arrays in ``data_names`` order."""

    def __init__(self, data: Sequence[Any]):
        self.data = list(data)


class Predictor:
    """``Predictor(symbol, data_names, context)`` with the reference's
    argument names. ``symbol(*data) -> dict`` runs on ``context`` (a torch
    device; each input is moved there, a tensor already on it is passed as
    it is). The reference's shape-binding and weight arguments have no
    counterpart: eager PyTorch binds no shapes, and the weights live in the
    module that ``symbol`` calls."""

    def __init__(self, symbol: Callable[..., Any], data_names: Sequence[str], context=None):
        self._apply = symbol
        self.data_names = tuple(data_names)
        self.context = None if context is None else torch.device(context)

    def predict(self, data_batch: DataBatch) -> list[dict]:
        """[{output name: tensor}]: one dict, the reference's single-context
        case."""
        if len(data_batch.data) != len(self.data_names):
            raise ValueError(f"expected {len(self.data_names)} inputs {self.data_names}, "
                             f"got {len(data_batch.data)}")
        data = [torch.as_tensor(d, device=self.context) for d in data_batch.data]
        with torch.inference_mode():
            out = self._apply(*data)
        return [out if isinstance(out, dict) else {"output": out}]


def make_key_cur_predictors(model, full_res_pred: bool = True,
                            propagate: str = "direct") -> tuple[Predictor, Predictor]:
    """The reference's key/cur predictor pair for ``model``.

    key predictor: data (1,H,W,3) -> {'prop', 'anchor_small', 'pred'}; cur
    predictor: (data, anchor_small, prop) -> the same. 'prop' is the
    propagated tensor (scores for accel, fc6 features for dff, the scores
    for deeplab), 'anchor_small' the next step's flow anchor (the frame
    downscaled for FlowNet; the frame itself for deeplab), 'pred' the
    class map: (1,H,W) uint8 with ``full_res_pred``, else at stride.

    ``propagate`` must match how the weights were trained: 'direct' keeps
    the keyframe's prop and anchor for the whole group; 'incremental'
    carries each frame's warped tensor and anchor to the next. Under
    'incremental' with ``scale_cascade='last'`` the carry is the
    UNMODULATED warped tensor and only the scored copy is modulated by the
    current step's scale field. 'mean1'/'clamp' would need the cumulative
    scale product carried as a third stream, which the protocol does not
    have: they raise under 'incremental'."""
    if propagate not in ("direct", "incremental"):
        raise ValueError(f"propagate must be direct|incremental, got {propagate!r}")
    if propagate == "incremental" and model.scale_cascade in ("mean1", "clamp"):
        raise ValueError(
            f"scale_cascade={model.scale_cascade!r} is not representable in the key/cur "
            "streaming protocol under incremental propagation; use 'last' or 'product', "
            "or run the clip through core.pipeline.clip_predictions")
    flows = model.family in ("dff", "accel")

    def scores_out(scores, image):
        if model.family == "accel":
            scores = model.fuse(scores, model.update_scores(image))
        if not full_res_pred:
            return scores.argmax(dim=1).to(torch.uint8)
        return upsample_argmax(scores, image.shape[-2:], plain=not model.use_kernels)

    def key_fn(frame):
        image = frame.permute(0, 3, 1, 2).contiguous()
        prop = model.ref_propagated(image)
        pred = scores_out(model.ref_scores_from_propagated(prop), image)
        small = model.downscale_for_flow(image) if flows else frame
        return {"prop": prop, "anchor_small": small, "pred": pred}

    def cur_fn(frame, anchor_small, prop):
        image = frame.permute(0, 3, 1, 2).contiguous()
        small = model.downscale_for_flow(image)
        flow, scale = model.flow_pair(small, anchor_small)
        if propagate == "incremental" and model.scale_cascade == "last":
            s = model.norm_scale(scale)
            warped = model.warp(prop, flow, s, normalize_scale=False, modulate=False)
            scored = warped * s.to(warped.dtype)
        else:
            warped = scored = model.warp(prop, flow, scale)
        pred = scores_out(model.ref_scores_from_propagated(scored), image)
        if propagate == "direct":
            return {"prop": prop, "anchor_small": anchor_small, "pred": pred}
        return {"prop": warped, "anchor_small": small, "pred": pred}

    device = next(model.parameters()).device
    return (Predictor(key_fn, ("data",), context=device),
            Predictor(cur_fn, ("data", "anchor_small", "prop"), context=device))
