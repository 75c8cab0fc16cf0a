"""Dataset base (counterpart of ``accel_tpu/data/imdb.py``): image index,
the pickled segdb cache, and the host-side evaluation."""

from __future__ import annotations

import os
import pickle

import numpy as np


class IMDB:
    def __init__(self, name: str, image_set: str, root_path: str, dataset_path: str):
        self.name = name + "_" + image_set
        self.image_set = image_set
        self.root_path = root_path
        self.data_path = dataset_path
        self.num_classes = 0
        self.segdb: list[dict] = []

    @property
    def cache_path(self) -> str:
        cache = os.path.join(self.root_path, "cache")
        os.makedirs(cache, exist_ok=True)
        return cache

    def gt_segdb(self) -> list[dict]:
        raise NotImplementedError

    def _load_cached(self, tag: str, builder):
        """The segdb from ``<root>/cache/<name>_<tag>.pkl``, built and
        written there on first use, under a temporary name and then
        renamed, so that a data-parallel rank never reads another's half
        written file. The cache is this program's own file: only a trusted
        dataset root may hold it, since unpickling runs code."""
        cache_file = os.path.join(self.cache_path, f"{self.name}_{tag}.pkl")
        if os.path.exists(cache_file):
            with open(cache_file, "rb") as f:
                return pickle.load(f)
        db = builder()
        tmp = f"{cache_file}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(db, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, cache_file)
        return db

    # ---- evaluation ------------------------------------------------------

    def get_confusion_matrix(self, gt_label: np.ndarray, pred_label: np.ndarray) -> np.ndarray:
        """Host-side confusion matrix, rows GT, columns prediction."""
        nc = self.num_classes
        valid = (gt_label != 255) & (gt_label < nc)
        idx = gt_label[valid].astype(np.int64) * nc + pred_label[valid].astype(np.int64)
        return np.bincount(idx, minlength=nc * nc).reshape(nc, nc).astype(np.float64)

    def evaluate_segmentations(self, pred_segmentations) -> float:
        """``pred_segmentations``: (H, W) trainId maps in segdb order.
        Prints per-class IoU and the mean; returns mIoU."""
        if len(pred_segmentations) != len(self.segdb):
            raise ValueError(f"{len(pred_segmentations)} preds vs {len(self.segdb)} gt")
        from accel_tpu_torch.data.image import resize_to

        cm = np.zeros((self.num_classes, self.num_classes))
        for pred, entry in zip(pred_segmentations, self.segdb):
            gt = self.load_annotation(entry)
            if pred.shape != gt.shape:
                pred = resize_to(pred.astype(np.uint8), *gt.shape, interp="nearest")
            cm += self.get_confusion_matrix(gt, pred)
        tp = np.diag(cm)
        union = cm.sum(0) + cm.sum(1) - tp
        iou = np.where(union > 0, tp / np.maximum(union, 1e-12), 0.0)
        present = cm.sum(1) > 0
        miou = iou[present].mean() if present.any() else 0.0
        names = getattr(self, "class_names", [str(i) for i in range(self.num_classes)])
        for n, v, p in zip(names, iou, present):
            print(f"{n:20s} IU {v * 100:6.2f}" + ("" if p else "  (absent)"))
        print(f"{'meanIU':20s} {miou * 100:6.2f}")
        return float(miou)

    def load_annotation(self, entry: dict) -> np.ndarray:
        raise NotImplementedError
