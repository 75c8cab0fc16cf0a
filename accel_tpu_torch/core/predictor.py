"""The reference's per-frame inference API and its eval loops
(counterpart of ``accel_tpu/core/predictor.py``: ``DataBatch``,
``Predictor``, ``make_key_cur_predictors``, ``pred_eval``,
``pred_eval_clips``).

A keyframe runs the key predictor, which returns the tensor to propagate;
every other frame runs the cur predictor with that cached tensor fed back
as an input, the reference's two-executor protocol. The weights live in
the ``nn.Module``; a predictor runs its function under
``torch.inference_mode()`` on the model's device.
"""

from __future__ import annotations

import time
from collections.abc import Callable, Sequence
from typing import Any

import torch

from accel_tpu_torch.core.metrics import SegConfusionAccumulator
from accel_tpu_torch.core.pipeline import clip_predictions, propagate_step
from accel_tpu_torch.data.image import resize_to
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
    downscaled for FlowNet, or under ``fold_flow_downscale`` its conv1
    'anchor' partial; the frame itself for deeplab), 'pred' the class map:
    (1,H,W) uint8 with ``full_res_pred``, else at stride. Running-stat
    BatchNorm serves from its running statistics, which live in the model
    (the reference's ``aux_params``).

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
    # direct warps once from the keyframe: no cascade to intervene on
    cascade = model.scale_cascade if propagate == "incremental" else "product"

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
        if not flows:
            small = frame
        elif model.fold_flow_downscale:
            small = model.flow_stem_partials(image)[1]
        else:
            small = model.downscale_for_flow(image)
        return {"prop": prop, "anchor_small": small, "pred": pred}

    def cur_fn(frame, anchor_small, prop):
        image = frame.permute(0, 3, 1, 2).contiguous()
        if model.fold_flow_downscale:
            cur_part, small = model.flow_stem_partials(image)
            flow, scale = model.flow_pair_from_partials(cur_part, anchor_small)
        else:
            small = model.downscale_for_flow(image)
            flow, scale = model.flow_pair(small, anchor_small)
        warped, _, scored = propagate_step(model, prop, None, flow, scale, cascade)
        pred = scores_out(model.ref_scores_from_propagated(scored), image)
        if propagate == "direct":
            return {"prop": prop, "anchor_small": anchor_small, "pred": pred}
        return {"prop": warped, "anchor_small": small, "pred": pred}

    device = next(model.parameters()).device
    return (Predictor(key_fn, ("data",), context=device),
            Predictor(cur_fn, ("data", "anchor_small", "prop"), context=device))


def _sync(device: torch.device) -> None:
    """Wait for the card's queued work: a timing's end on CUDA."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pred_eval(key_predictor: Predictor, cur_predictor: Predictor, test_iter, num_classes: int,
              key_interval: int, logger=None):
    """The reference's per-frame eval loop.

    ``test_iter`` yields one dict per frame: {'data': (1,H,W,3) normalized
    frame, 'label': (1,H,W) or None, 'is_key': bool}. A keyframe (or the
    first frame) runs the key predictor; every other frame the cur
    predictor, with the cached 'prop' and 'anchor_small' fed back as
    inputs (the reference's feat_key protocol). ``key_interval`` is the
    schedule ``test_iter`` follows (its 'is_key' flags), kept for the
    reference's signature. Net time waits for the card after each frame.
    Returns (mIoU, per-class IoU, {'t_data', 't_net', 'frames', 'fps'})."""
    log = logger.info if logger else print
    acc = SegConfusionAccumulator(num_classes)
    device = key_predictor.context or torch.device("cpu")
    t_data = t_net = 0.0
    n_frames = 0
    prop = anchor_small = None
    t0 = time.perf_counter()
    for frame in test_iter:
        t_data += time.perf_counter() - t0
        t1 = time.perf_counter()
        if frame["is_key"] or prop is None:
            out = key_predictor.predict(DataBatch([frame["data"]]))[0]
        else:
            out = cur_predictor.predict(DataBatch([frame["data"], anchor_small, prop]))[0]
        prop, anchor_small, pred = out["prop"], out["anchor_small"], out["pred"]
        _sync(device)
        t_net += time.perf_counter() - t1
        if frame.get("label") is not None:
            acc.update(pred, torch.as_tensor(frame["label"], device=pred.device))
        n_frames += 1
        if n_frames % 100 == 0:
            log(f"testing {n_frames} frames data {t_data / n_frames:.4f}s "
                f"net {t_net / n_frames:.4f}s")
        t0 = time.perf_counter()
    miou, iou = acc.result()
    fps = n_frames / max(t_net, 1e-9)
    log(f"frames {n_frames}  net fps {fps:.2f}  mIoU {miou * 100:.2f}")
    return miou, iou, {"t_data": t_data, "t_net": t_net, "frames": n_frames, "fps": fps}


def pred_eval_clips(model, clip_iter, num_classes: int, interval: int,
                    propagate: str = "incremental", logger=None,
                    upsample: str = "bilinear_logits", on_preds=None):
    """Clip eval: each batch of clips through ``core.pipeline.clip_predictions``.

    ``clip_iter`` yields {'clip': (B,F,H,W,3) normalized, 'label': (B,F,H,W)
    int with 255 everywhere but the annotated frames (or None)}, numpy or
    tensors; a batch goes to the model's device where it is not there
    already. Where the batch holds 'label_native' (SCALES resized the
    frames), each clip's annotated frame is scored at its annotation's own
    resolution: the padding cropped, the class map nearest-resized to the
    annotation (the reference protocol). The weights live in ``model``;
    the reference's ``variables``, ``mesh`` and ``shard_spatial`` have no
    counterpart on one card. ``on_preds(item, preds)``, where given, is
    called with each batch and its (B, F, H, W) uint8 class maps.

    Net time runs from the batch in hand, its copy to the card included,
    to its class maps on the card (synchronized); the first batch, which pays the allocator's and
    cuDNN's first calls, is left out of fps. Data time is the wait for the
    iterator. Returns (mIoU, per-class IoU, {'t_net', 't_data', 'frames',
    'fps', 'confusion'}), 'confusion' the (C, C) float64 matrix."""
    log = logger.info if logger else print
    acc = SegConfusionAccumulator(num_classes)
    device = next(model.parameters()).device
    t_net = t_data = 0.0
    n_frames = n_timed = 0
    first = True
    t0 = time.perf_counter()
    for item in clip_iter:
        t_data += time.perf_counter() - t0
        t1 = time.perf_counter()
        clip = torch.as_tensor(item["clip"], device=device)
        preds = clip_predictions(model, clip, interval, propagate, upsample=upsample)
        _sync(device)
        if first:
            first = False
        else:
            t_net += time.perf_counter() - t1
            n_timed += clip.shape[0] * clip.shape[1]
        n_frames += clip.shape[0] * clip.shape[1]
        if on_preds is not None:
            on_preds(item, preds)
        label = item.get("label")
        natives = item.get("label_native")
        if natives is not None:
            ann_pos = int(item["ann_pos"])
            preds_host = preds.cpu().numpy()
            for b, nat in enumerate(natives):
                if nat is None:
                    # this clip's annotation had the frames' size already
                    if label is not None:
                        acc.update(preds[b:b + 1], torch.as_tensor(label[b:b + 1], device=device))
                    continue
                ann, scaled_hw = nat
                p = preds_host[b, ann_pos, : scaled_hw[0], : scaled_hw[1]]
                p = resize_to(p, *ann.shape[:2], interp="nearest")
                acc.update(torch.from_numpy(p)[None], torch.from_numpy(ann)[None])
        elif label is not None:
            acc.update(preds, torch.as_tensor(label, device=device))
        t0 = time.perf_counter()
    miou, iou = acc.result()
    fps = n_timed / max(t_net, 1e-9)
    log(f"frames {n_frames}  net fps {fps:.2f}  mIoU {miou * 100:.2f}")
    return miou, iou, {"t_net": t_net, "t_data": t_data, "frames": n_frames, "fps": fps,
                       "confusion": acc.cm.copy()}
