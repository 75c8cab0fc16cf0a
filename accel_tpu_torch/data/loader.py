"""The data loaders (counterpart of ``accel_tpu/data/loader.py``): the
train loaders ``TrainPairLoader`` and ``TrainClipLoader``, and the eval
loader ``TestClipLoader``. Host side, numpy; the move to the device is
``data/prefetch.py``'s.

The train loaders draw from ``np.random.default_rng(seed)`` the same
numbers in the same order as the reference's, so their batches are the
reference's bit for bit; the batches leave as NCHW float32 tensors (labels
int32), the eval loader's as the reference's NHWC arrays.

Under data parallelism each loader takes ``rows``, this rank's rows of
every global batch (``parallel.mesh.batch_rows``). A train loader draws
its crops and flips in order over the global batch, and a crop depends on
each image's shape, so every rank decodes and normalizes the whole global
batch and keeps its rows (W ranks do W times the host work of one). The
eval loader draws nothing, so each rank loads only its clips.
"""

from __future__ import annotations

import numpy as np
import torch

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


def _nchw(x: np.ndarray) -> torch.Tensor:
    """(..., H, W, C) float32 -> (..., C, H, W) contiguous tensor."""
    return torch.from_numpy(x).movedim(-1, -3).contiguous()


def _crop_window(rng: np.random.Generator, crop, hw) -> tuple[int, int, int, int] | None:
    """A random CROP_SIZE window (y0, x0, ch, cw) of an image of size
    ``hw``, or None where no crop is asked for or the image fits it."""
    if not crop:
        return None
    ch, cw = crop
    h, w = hw
    if h <= ch and w <= cw:
        return None
    y0 = int(rng.integers(0, max(h - ch, 0) + 1))
    x0 = int(rng.integers(0, max(w - cw, 0) + 1))
    return y0, x0, ch, cw


class _TrainLoader:
    """What the two train loaders share: the cfg, the rng, the annotated
    entries, the epoch's order and the crop and flip draws. ``rows``: the
    rows of each global batch of ``TRAIN.BATCH_IMAGES`` this loader yields
    (default all). Fewer annotated entries than a batch raise: an epoch
    would hold no batch, and the endless iterator would yield none."""

    def __init__(self, imdb, cfg, shuffle: bool = True, seed: int = 0,
                 rows: slice | None = None):
        self.imdb = imdb
        self.cfg = cfg
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.batch_size = int(cfg.TRAIN.BATCH_IMAGES)
        self.crop = tuple(int(x) for x in cfg.TRAIN.CROP_SIZE) if cfg.TRAIN.CROP_SIZE else None
        self.flip = bool(cfg.TRAIN.FLIP)
        self.means = np.asarray(cfg.network.PIXEL_MEANS, np.float32)
        self.stds = np.asarray(cfg.network.PIXEL_STDS, np.float32)
        self.scales = cfg.get("SCALES")
        self.entries = [e for e in imdb.segdb if e["annotation"]]
        if len(self.entries) < self.batch_size:
            raise ValueError(f"{len(self.entries)} annotated entries, fewer than "
                             f"TRAIN.BATCH_IMAGES={self.batch_size}: no full batch to train on")
        self.rows = rows
        self.has_seq = getattr(imdb, "has_sequences", lambda: False)()

    @property
    def epoch_size(self) -> int:
        return max(len(self.entries) // self.batch_size, 1)

    def _augment(self, images: list, label: np.ndarray):
        """The same random crop of every image and the label, then the same
        random horizontal flip."""
        win = _crop_window(self.rng, self.crop, images[0].shape[:2])
        if win is not None:
            y0, x0, ch, cw = win
            images = [im[y0:y0 + ch, x0:x0 + cw] for im in images]
            label = label[y0:y0 + ch, x0:x0 + cw]
        if self.flip and self.rng.random() < 0.5:
            images = [im[:, ::-1] for im in images]
            label = label[:, ::-1]
        return images, label

    def _normalize(self, im: np.ndarray) -> np.ndarray:
        """(H, W, 3) -> padded to a multiple of 128 and normalized, (H', W', 3)."""
        return transform(_pad_to_multiple(im, 128), self.means, self.stds)[0]

    def _batch(self, entries) -> dict:
        raise NotImplementedError

    def __iter__(self):
        while True:
            n = len(self.entries)
            order = self.rng.permutation(n) if self.shuffle else np.arange(n)
            for i in range(0, n - self.batch_size + 1, self.batch_size):
                batch = self._batch([self.entries[j] for j in order[i:i + self.batch_size]])
                yield batch if self.rows is None else {k: v[self.rows] for k, v in batch.items()}


class TrainPairLoader(_TrainLoader):
    """Pair batches for the (key, cur) objective: cur is the annotated
    frame, the ref frame lies an offset drawn from [MIN_OFFSET, MAX_OFFSET]
    from it in the snippet (cur itself at offset 0, without sequence
    frames, or where the frame is missing: ``eq_flag`` 1).

    Batch: 'data' and 'data_ref' (N,3,H,W) float32, 'eq_flag' (N,) float32,
    'label' (N,H,W) int32 (255 ignored)."""

    def __init__(self, imdb, cfg, shuffle: bool = True, seed: int = 0,
                 rows: slice | None = None):
        super().__init__(imdb, cfg, shuffle, seed, rows)
        self.min_off = int(cfg.TRAIN.MIN_OFFSET)
        self.max_off = int(cfg.TRAIN.MAX_OFFSET)

    def _load_pair(self, entry):
        cur = _apply_scales(self.imdb.load_image(entry["image"]), self.scales)
        label = self.imdb.load_annotation(entry)
        if label.shape[:2] != cur.shape[:2]:
            label = resize_to(label, *cur.shape[:2], interp="nearest")
        off = int(self.rng.integers(self.min_off, self.max_off + 1))
        if off == 0 or not self.has_seq:
            return cur, cur.copy(), 1.0, label
        try:
            ref = _apply_scales(
                self.imdb.load_image(self.imdb.sequence_frame(entry, ANNOTATED_FRAME + off)),
                self.scales)
        except FileNotFoundError:
            return cur, cur.copy(), 1.0, label
        return cur, ref, 0.0, label

    def _batch(self, entries) -> dict:
        datas, refs, eqs, labels = [], [], [], []
        for entry in entries:
            cur, ref, eq, label = self._load_pair(entry)
            (cur, ref), label = self._augment([cur, ref], label)
            datas.append(self._normalize(cur))
            refs.append(self._normalize(ref))
            labels.append(_pad_to_multiple(label, 128, 255))
            eqs.append(eq)
        return {"data": _nchw(np.stack(datas)), "data_ref": _nchw(np.stack(refs)),
                "eq_flag": torch.tensor(eqs, dtype=torch.float32),
                "label": torch.from_numpy(np.stack(labels).astype(np.int32))}


class TrainClipLoader(_TrainLoader):
    """Clip batches for the clip objective (``core.pipeline.
    clip_loss_and_stats``): per annotated frame, ``CLIP_LENGTH``
    consecutive frames, keyframe first, with the annotated frame at a
    random place in the clip per sample, so a batch supervises every
    distance from the keyframe.

    Batch: 'clip' (N,F,3,H,W) float32, 'label' (N,F,H,W) int32, 255
    everywhere but each clip's annotated frame."""

    def __init__(self, imdb, cfg, shuffle: bool = True, seed: int = 0,
                 rows: slice | None = None):
        super().__init__(imdb, cfg, shuffle, seed, rows)
        self.clip_length = int(cfg.TRAIN.CLIP_LENGTH)

    def _load_clip(self, entry):
        k = self.clip_length
        ann_pos = int(self.rng.integers(0, k))
        frames = []
        for i in range(k):
            im = None
            if self.has_seq:
                try:
                    im = self.imdb.load_image(
                        self.imdb.sequence_frame(entry, ANNOTATED_FRAME - ann_pos + i))
                except FileNotFoundError:
                    im = None
            if im is None:
                im = self.imdb.load_image(entry["image"])
            frames.append(_apply_scales(im, self.scales))
        label = self.imdb.load_annotation(entry)
        if label.shape[:2] != frames[0].shape[:2]:
            label = resize_to(label, *frames[0].shape[:2], interp="nearest")
        return frames, label, ann_pos

    def _batch(self, entries) -> dict:
        clips, labels = [], []
        for entry in entries:
            frames, label, ann_pos = self._load_clip(entry)
            frames, label = self._augment(frames, label)
            clip = np.stack([self._normalize(f) for f in frames])
            lab_full = np.full((len(frames), *clip.shape[1:3]), 255, np.int32)
            lab = _pad_to_multiple(label, 128, 255)
            lab_full[ann_pos, :lab.shape[0], :lab.shape[1]] = lab
            clips.append(clip)
            labels.append(lab_full)
        return {"clip": _nchw(np.stack(clips)), "label": torch.from_numpy(np.stack(labels))}


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

    def __init__(self, imdb, cfg, batch_clips: int = 1, max_items: int | None = None,
                 rows: slice | None = None):
        self.imdb = imdb
        self.cfg = cfg
        self.interval = int(cfg.TEST.KEY_FRAME_INTERVAL)
        self.key_offset = int(cfg.TEST.KEY_FRAME_OFFSET)
        self.batch_clips = batch_clips
        self.rows = slice(0, batch_clips) if rows is None else rows
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
        if self.rows.start >= self.rows.stop:
            return
        for i in range(0, len(self.entries), self.batch_clips):
            batch = self.entries[i:i + self.batch_clips]
            clips, labels, idxs, natives = [], [], [], []
            loaded = {}
            for row in range(self.rows.start, self.rows.stop):
                # the last batch is filled up with repeats of its last clip
                # that score nothing
                e = batch[min(row, len(batch) - 1)]
                if id(e) not in loaded:
                    loaded[id(e)] = self._load_clip(e)
                clip, label, native = loaded[id(e)]
                pad = row >= len(batch)
                clips.append(clip)
                labels.append(np.full_like(label, 255) if pad else label)
                idxs.append(-1 if pad else self._entry_idx[id(e)])
                natives.append(None if pad else native)
            item = {"clip": np.stack(clips, 0), "label": np.stack(labels, 0),
                    "entry_idx": np.asarray(idxs), "ann_pos": self.ann_pos}
            if any(n is not None for n in natives):
                item["label_native"] = natives
            yield item
