"""Cityscapes (counterpart of ``accel_tpu/data/cityscapes.py``): 19 train
classes and the video snippets.

The index comes from ``leftImg8bit/`` + ``gtFine/`` with the standard
labelId -> trainId LUT (255 = ignore). Ground truth exists only on frame
19 (the 20th) of each 30-frame snippet in ``leftImg8bit_sequence/``.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from accel_tpu_torch.data import png
from accel_tpu_torch.data.image import map_labels
from accel_tpu_torch.data.imdb import IMDB

# standard Cityscapes labelId -> trainId (19 classes, 255 = ignore)
_ID_MAP = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}

CLASS_NAMES = [
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
]

ANNOTATED_FRAME = 19  # 0-indexed; GT on the 20th frame of each 30-frame snippet
SNIPPET_LEN = 30


def trainid_lut() -> np.ndarray:
    lut = np.full(256, 255, np.uint8)
    for k, v in _ID_MAP.items():
        lut[k] = v
    return lut


class Cityscape(IMDB):
    """image_set: '{leftImg8bit_}train' / 'val' / 'test' (reference naming)."""

    def __init__(self, image_set: str, root_path: str, dataset_path: str):
        split = image_set.replace("leftImg8bit_", "")
        super().__init__("cityscape", split, root_path, dataset_path)
        self.split = split
        self.num_classes = 19
        self.class_names = CLASS_NAMES
        self.lut = trainid_lut()
        self.segdb = self.gt_segdb()

    def gt_segdb(self) -> list[dict]:
        def build():
            img_dir = os.path.join(self.data_path, "leftImg8bit", self.split)
            entries = []
            for img in sorted(glob.glob(os.path.join(img_dir, "*", "*_leftImg8bit.png"))):
                base = os.path.basename(img)[: -len("_leftImg8bit.png")]
                city = base.split("_")[0]
                ann = os.path.join(self.data_path, "gtFine", self.split, city,
                                   base + "_gtFine_labelIds.png")
                entries.append({"image": img, "annotation": ann if os.path.exists(ann) else None,
                                "base": base, "city": city, "height": 1024, "width": 2048})
            return entries

        return self._load_cached("gt_segdb", build)

    def sequence_frame(self, entry: dict, frame_idx: int) -> str:
        """Path of frame ``frame_idx`` (0..29) of the entry's snippet: the
        entry's image for ANNOTATED_FRAME, else a file of
        ``leftImg8bit_sequence/``."""
        city, seq, frame = entry["base"].split("_")[:3]
        target = int(frame) - ANNOTATED_FRAME + frame_idx
        if frame_idx == ANNOTATED_FRAME:
            return entry["image"]
        return os.path.join(self.data_path, "leftImg8bit_sequence", self.split, city,
                            f"{city}_{seq}_{target:06d}_leftImg8bit.png")

    def has_sequences(self) -> bool:
        return os.path.isdir(os.path.join(self.data_path, "leftImg8bit_sequence"))

    def load_image(self, path: str) -> np.ndarray:
        """BGR uint8 HWC (cv2's order, which PIXEL_MEANS follows)."""
        im = png.imread(path, png.IMREAD_UNCHANGED)
        if im.ndim == 2:
            im = np.stack([im] * 3, -1)
        return im[:, :, :3]

    def load_annotation(self, entry: dict) -> np.ndarray:
        if not entry["annotation"]:
            raise FileNotFoundError(f"no annotation for {entry['image']}")
        return map_labels(png.imread(entry["annotation"], png.IMREAD_UNCHANGED), self.lut)
