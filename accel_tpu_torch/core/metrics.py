"""Segmentation metrics (counterpart of ``accel_tpu/core/metrics.py``).

The confusion matrix is counted on the class maps' own device with one
``torch.bincount`` of ``label * C + pred``: exact integer counts, and no
host round trip per frame. (The reference contracts one-hot matrices on
the TPU's matrix unit instead, which is that chip's idiom for a
histogram.)
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

IGNORE_LABEL = 255


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(C, C) int64 confusion matrix on ``pred``'s device; rows GT, columns
    prediction. Pixels whose label is ``IGNORE_LABEL`` or not below C are
    dropped, and so are predictions not below C (the reference's one-hot
    of such a prediction is all zero). The dropped pixels land in one
    extra bin, so no mask has to be counted on the host first."""
    C = num_classes
    pred = torch.as_tensor(pred).reshape(-1).long()
    label = torch.as_tensor(label, device=pred.device).reshape(-1).long()
    valid = (label >= 0) & (label < C) & (pred >= 0) & (pred < C)
    idx = torch.where(valid, label * C + pred, C * C)
    return torch.bincount(idx, minlength=C * C + 1)[:C * C].view(C, C)


def miou_from_confusion(cm) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean IoU over the classes present in GT, per-class IoU), f64."""
    cm = torch.as_tensor(cm, dtype=torch.float64)
    gt, pr, tp = cm.sum(dim=1), cm.sum(dim=0), torch.diagonal(cm)
    union = gt + pr - tp
    iou = torch.where(union > 0, tp / union.clamp(min=1e-12), torch.zeros_like(union))
    present = gt > 0
    miou = torch.where(present, iou, torch.zeros_like(iou)).sum() / present.sum().clamp(min=1)
    return miou, iou


def softmax_cross_entropy(logits: torch.Tensor, label: torch.Tensor, num_classes: int,
                          loss_scale: float = 1.0, ohem_fraction: float | None = None,
                          group=None) -> torch.Tensor:
    """Per-pixel softmax cross entropy, mean over the valid pixels (label
    not ``IGNORE_LABEL`` and below C), in f32.

    ``logits`` (N, C, ...) with the classes on dim 1, PyTorch's layout (the
    reference takes them channels last); ``label`` (N, ...).
    ``ohem_fraction`` in (0, 1) keeps the hardest ``int(pixels *
    fraction)`` (at least 1) per-pixel losses and divides by
    min(valid pixels, that count): online hard example mining.

    ``group`` (a data-parallel process group; ``parallel/mesh.py``): the
    batch is this rank's rows of a global batch, and the result is this
    rank's share of the global batch's loss: its pixels' losses over the
    global count of valid pixels, so the shares sum over the ranks to the
    loss of the whole batch, and so do their gradients. OHEM then keeps the
    hardest ``int(global pixels * fraction)`` of the global batch
    (``_ohem_share``)."""
    valid = (label != IGNORE_LABEL) & (label < num_classes)
    lab = torch.where(valid, label, torch.zeros_like(label)).long()
    logp = F.log_softmax(logits.float(), dim=1)
    nll = -logp.gather(1, lab.unsqueeze(1)).squeeze(1)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    ohem = ohem_fraction is not None and 0.0 < ohem_fraction < 1.0
    if group is not None:
        n_valid = valid.sum().reshape(1)
        dist.all_reduce(n_valid, group=group)
        if ohem:
            return _ohem_share(nll.reshape(-1), n_valid, ohem_fraction, loss_scale, group)
        return loss_scale * nll.sum() / n_valid.clamp(min=1)
    if ohem:
        flat = nll.reshape(-1)
        k = max(int(flat.numel() * ohem_fraction), 1)
        n_kept = valid.sum().clamp(max=k)
        return loss_scale * flat.topk(k).values.sum() / n_kept.clamp(min=1)
    return loss_scale * nll.sum() / valid.sum().clamp(min=1)


def _ohem_share(flat: torch.Tensor, n_valid: torch.Tensor, fraction: float,
                loss_scale: float, group) -> torch.Tensor:
    """This rank's share of the OHEM loss of the global batch: the global
    ``k`` hardest pixel losses are those above the k-th largest of the
    gathered losses, ``t``, and as many of those equal to ``t`` as fill
    ``k``, taken in the global batch's order (rank by rank, then by index
    within the rank), which is the order in which a top-k of the whole
    batch takes equal values. Equal losses give equal sums whichever are
    kept."""
    world = dist.get_world_size(group)
    gathered = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(gathered, flat.detach().contiguous(), group=group)
    every = torch.stack(gathered)
    k = max(int(every.numel() * fraction), 1)
    t = every.reshape(-1).topk(k).values[-1]
    ties = (every == t).sum(dim=1)
    rank = dist.get_rank(group)
    quota = (k - (every > t).sum() - ties[:rank].sum()).clamp(min=0, max=int(ties[rank]))
    tied = flat.detach() == t
    keep = (flat.detach() > t) | (tied & (tied.cumsum(0) <= quota))
    n_kept = n_valid.clamp(max=k)
    return loss_scale * torch.where(keep, flat, torch.zeros_like(flat)).sum() / n_kept.clamp(min=1)


class FCNLogLossMetric:
    """Running ignore-aware cross-entropy metric: feed it per-step
    (loss sum, valid count) pairs."""

    def __init__(self, name: str = "FCNLogLoss"):
        self.name = name
        self.reset()

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0

    def update(self, loss_sum: float, num_valid: int):
        self.sum_metric += float(loss_sum)
        self.num_inst += int(num_valid)

    def get(self) -> tuple[str, float]:
        return self.name, self.sum_metric / max(self.num_inst, 1)


class SegConfusionAccumulator:
    """Streaming confusion matrix: each batch counted on its device
    (``confusion_matrix``), the totals kept on the host in float64, exact
    integer counts at any dataset size."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.cm = np.zeros((num_classes, num_classes), np.float64)

    def update(self, pred, label):
        self.cm += confusion_matrix(pred, label, self.num_classes).cpu().numpy()

    def result(self) -> tuple[float, list[float]]:
        miou, iou = miou_from_confusion(self.cm)
        return float(miou), [float(x) for x in iou]
