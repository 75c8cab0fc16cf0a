"""Non-max suppression and box overlaps (counterpart of ``accel_tpu/ops/nms.py``).

The detection heritage of the reference (its ``lib/nms`` and ``lib/bbox``),
off the segmentation path: nothing in the repo calls these functions. They
are plain tensor code, the mask formulation of the JAX package: an (N, N)
IoU matrix and a greedy pass over the score-sorted boxes that updates an
``alive`` mask with ``torch.where``, with no host sync per box.
"""

from __future__ import annotations

import torch


def bbox_overlaps(boxes: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """IoU matrix (N, K) of ``boxes`` (N, 4) against ``query`` (K, 4),
    [x1, y1, x2, y2] with inclusive pixel corners (the +1 widths)."""
    area_b = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    area_q = (query[:, 2] - query[:, 0] + 1) * (query[:, 3] - query[:, 1] + 1)
    ix1 = torch.maximum(boxes[:, None, 0], query[None, :, 0])
    iy1 = torch.maximum(boxes[:, None, 1], query[None, :, 1])
    ix2 = torch.minimum(boxes[:, None, 2], query[None, :, 2])
    iy2 = torch.minimum(boxes[:, None, 3], query[None, :, 3])
    iw = (ix2 - ix1 + 1).clamp(min=0)
    ih = (iy2 - iy1 + 1).clamp(min=0)
    inter = iw * ih
    return inter / (area_b[:, None] + area_q[None, :] - inter)


def nms(dets: torch.Tensor, thresh: float, max_out: int | None = None) -> torch.Tensor:
    """Greedy NMS of ``dets`` (N, 5) = [x1, y1, x2, y2, score] -> keep mask
    (N,) bool in the original order. The boxes are taken by score, highest
    first, equal scores in their original order (a stable sort, as
    ``jnp.argsort``); each box still alive suppresses the later ones whose
    IoU with it exceeds ``thresh``. ``max_out`` keeps only the first that
    many survivors by score."""
    n = dets.shape[0]
    order = torch.argsort(-dets[:, 4], stable=True)
    iou = bbox_overlaps(dets[order, :4], dets[order, :4])
    alive = torch.ones(n, dtype=torch.bool, device=dets.device)
    idx = torch.arange(n, device=dets.device)
    for i in range(n):
        suppress = (iou[i] > thresh) & alive[i]
        alive = torch.where(suppress, (idx == i) & alive[i], alive)
    if max_out is not None:
        alive = alive & (torch.cumsum(alive, 0) - 1 < max_out)
    keep = torch.zeros(n, dtype=torch.bool, device=dets.device)
    keep[order] = alive
    return keep
