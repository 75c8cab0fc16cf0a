"""The eval data loader (counterpart of ``accel_tpu/data/loader.py``'s
``TestClipLoader`` and its helpers). Host side, numpy; the move to the
device is ``data/prefetch.py``'s. The train loaders come with training.
"""

from __future__ import annotations

import numpy as np

from accel_tpu_torch.data.cityscapes import ANNOTATED_FRAME
from accel_tpu_torch.data.image import resize, resize_to, transform


def _apply_scales(im: np.ndarray, scales, interp: str = "bilinear"):
    """Short-side resize per SCALES ([[target, max]]); the image as it is
    where it already has that size."""
    if not scales:
        return im
    target, max_size = int(scales[0][0]), int(scales[0][1])
    h, w = im.shape[:2]
    if min(h, w) == target and max(h, w) <= max_size:
        return im
    out, _ = resize(im, target, max_size, interp)
    return out


def _pad_to_multiple(im: np.ndarray, mult: int, value: float = 0.0) -> np.ndarray:
    h, w = im.shape[:2]
    ph, pw = (-h) % mult, (-w) % mult
    if ph == 0 and pw == 0:
        return im
    return np.pad(im, [(0, ph), (0, pw)] + [(0, 0)] * (im.ndim - 2), constant_values=value)


class TestClipLoader:
    """Clip batches for video eval.

    Per annotated frame, the clip is the ``interval`` consecutive frames
    ending ``key_offset`` frames after the annotated one, keyframe first,
    so the annotated frame sits ``interval-1-key_offset`` steps after the
    keyframe (the reference protocol: mIoU as a function of that distance).

    Batch dict: 'clip' (B,F,H,W,3) f32, 'label' (B,F,H,W) int32 with 255
    everywhere but each clip's annotated frame, 'entry_idx' (B,),
    'ann_pos'; and, where SCALES resized the frames, 'label_native': per
    clip None or (native annotation, scaled (h, w)), so that eval scores
    at the annotation's own resolution.
    """

    __test__ = False  # pytest: not a test class (reference naming)

    def __init__(self, imdb, cfg, batch_clips: int = 1, max_items: int | None = None):
        self.imdb = imdb
        self.cfg = cfg
        self.interval = int(cfg.TEST.KEY_FRAME_INTERVAL)
        self.key_offset = int(cfg.TEST.KEY_FRAME_OFFSET)
        self.batch_clips = batch_clips
        self.means = np.asarray(cfg.network.PIXEL_MEANS, np.float32)
        self.stds = np.asarray(cfg.network.PIXEL_STDS, np.float32)
        self.scales = cfg.get("SCALES")
        entries = [e for e in imdb.segdb if e["annotation"]]
        self.entries = entries[:max_items] if max_items else entries
        self.has_seq = getattr(imdb, "has_sequences", lambda: False)()
        # the annotated frame's place in every clip
        self.ann_pos = self.interval - 1 - self.key_offset
        if not 0 <= self.ann_pos < self.interval:
            raise ValueError(f"KEY_FRAME_OFFSET {self.key_offset} out of range for "
                             f"interval {self.interval}")
        self._entry_idx = {id(e): i for i, e in enumerate(imdb.segdb)}

    def __len__(self):
        return (len(self.entries) + self.batch_clips - 1) // self.batch_clips

    def _load_clip(self, entry):
        k, ann_pos = self.interval, self.ann_pos
        frames = []
        for i in range(k):
            if self.has_seq:
                try:
                    im = self.imdb.load_image(
                        self.imdb.sequence_frame(entry, ANNOTATED_FRAME - ann_pos + i))
                except FileNotFoundError:
                    im = self.imdb.load_image(entry["image"])
            else:
                im = self.imdb.load_image(entry["image"])
            im = _apply_scales(im, self.scales)
            frames.append(transform(_pad_to_multiple(im, 128), self.means, self.stds)[0])
        clip = np.stack(frames, 0)
        label_full = np.full((k, *clip.shape[1:3]), 255, np.int32)
        ann = self.imdb.load_annotation(entry)
        native = None
        if ann.shape[:2] != im.shape[:2]:
            # SCALES resized the frames: carry the native annotation and the
            # scaled extent for scoring at native resolution; the batch label
            # gets the nearest-resized annotation
            native = (ann, im.shape[:2])
            ann = resize_to(ann, *im.shape[:2], interp="nearest")
        label_full[ann_pos, : ann.shape[0], : ann.shape[1]] = ann
        return clip, label_full, native

    def __iter__(self):
        for i in range(0, len(self.entries), self.batch_clips):
            clips, labels, idxs, natives = [], [], [], []
            for e in self.entries[i:i + self.batch_clips]:
                clip, label, native = self._load_clip(e)
                clips.append(clip)
                labels.append(label)
                idxs.append(self._entry_idx[id(e)])
                natives.append(native)
            # the last batch is filled up with repeats that score nothing
            while len(clips) < self.batch_clips:
                clips.append(clips[-1])
                labels.append(np.full_like(labels[-1], 255))
                idxs.append(-1)
                natives.append(None)
            item = {"clip": np.stack(clips, 0), "label": np.stack(labels, 0),
                    "entry_idx": np.asarray(idxs), "ann_pos": self.ann_pos}
            if any(n is not None for n in natives):
                item["label_native"] = natives
            yield item
