"""CamVid, 11 classes (counterpart of ``accel_tpu/data/camvid.py``): images
in ``{split}/``, labels already class indices in ``{split}annot/``."""

from __future__ import annotations

import glob
import os

import numpy as np

from accel_tpu_torch.data import png
from accel_tpu_torch.data.imdb import IMDB

CLASS_NAMES = [
    "sky", "building", "pole", "road", "pavement", "tree",
    "sign", "fence", "car", "pedestrian", "bicyclist",
]


class CamVid(IMDB):
    def __init__(self, image_set: str, root_path: str, dataset_path: str):
        super().__init__("camvid", image_set, root_path, dataset_path)
        self.split = image_set
        self.num_classes = 11
        self.class_names = CLASS_NAMES
        self.segdb = self.gt_segdb()

    def gt_segdb(self) -> list[dict]:
        def build():
            img_dir = os.path.join(self.data_path, self.split)
            ann_dir = os.path.join(self.data_path, self.split + "annot")
            entries = []
            for img in sorted(glob.glob(os.path.join(img_dir, "*.png"))):
                name = os.path.basename(img)
                ann = os.path.join(ann_dir, name)
                entries.append({"image": img, "annotation": ann if os.path.exists(ann) else None,
                                "base": name[:-4], "height": 720, "width": 960})
            return entries

        return self._load_cached("gt_segdb", build)

    def load_image(self, path: str) -> np.ndarray:
        return png.imread(path, png.IMREAD_COLOR)

    def load_annotation(self, entry: dict) -> np.ndarray:
        lab = png.imread(entry["annotation"], png.IMREAD_UNCHANGED)
        if lab.ndim == 3:
            lab = lab[:, :, 0]
        out = lab.astype(np.uint8)
        out[out >= self.num_classes] = 255
        return out
