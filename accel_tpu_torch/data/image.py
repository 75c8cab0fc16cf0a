"""Host-side image preprocessing (counterpart of ``accel_tpu/data/image.py``).

Short-side ``resize`` capped at a max size, BGR mean-subtract
``transform``, the label LUT and ``tensor_vstack`` batching. The hot loops
(bilinear resize, normalize, label LUT) run in the C++ of
``accel_tpu_torch/native`` (``native_ops``), as the reference's do once
its extension is built; nearest resizes are numpy indexing.
"""

from __future__ import annotations

import numpy as np

from accel_tpu_torch.native import native_ops


def resize(im: np.ndarray, target_size: int, max_size: int, interp: str = "bilinear"):
    """Scale so the short side is ``target_size``, capped so the long side
    is at most ``max_size``. Returns (resized image, scale)."""
    h, w = im.shape[:2]
    scale = float(target_size) / min(h, w)
    if round(scale * max(h, w)) > max_size:
        scale = float(max_size) / max(h, w)
    out_h, out_w = int(round(h * scale)), int(round(w * scale))
    return resize_to(im, out_h, out_w, interp), scale


def resize_to(im: np.ndarray, out_h: int, out_w: int, interp: str = "bilinear"):
    if im.shape[0] == out_h and im.shape[1] == out_w:
        return im
    if interp == "nearest":
        ys = (np.arange(out_h) * (im.shape[0] / out_h)).astype(np.int64)
        xs = (np.arange(out_w) * (im.shape[1] / out_w)).astype(np.int64)
        return im[ys][:, xs]
    return native_ops.resize_bilinear(im, out_h, out_w)


def transform(im: np.ndarray, pixel_means, pixel_stds=(1.0, 1.0, 1.0)) -> np.ndarray:
    """uint8/float HWC in BGR order -> normalized float32 (1, H, W, C)."""
    return native_ops.normalize(im, np.asarray(pixel_means, np.float32),
                                np.asarray(pixel_stds, np.float32))[None]


def transform_inverse(im_tensor: np.ndarray, pixel_means, pixel_stds=(1.0, 1.0, 1.0)):
    """(1, H, W, C) normalized -> uint8 HWC BGR."""
    im = im_tensor[0] * np.asarray(pixel_stds, np.float32) + np.asarray(pixel_means, np.float32)
    return np.clip(im, 0, 255).astype(np.uint8)


def map_labels(label: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Apply a 256-entry labelId -> trainId LUT (255 = ignore)."""
    return native_ops.map_labels(label, lut)


def tensor_vstack(tensor_list, pad: float = 0.0) -> np.ndarray:
    """Stack along axis 0, padding trailing dims with ``pad`` to the
    largest shape."""
    if len(tensor_list) == 1:
        return tensor_list[0]
    ndim = tensor_list[0].ndim
    shapes = np.array([t.shape for t in tensor_list])
    out_shape = [int(shapes[:, 0].sum())] + [int(shapes[:, d].max()) for d in range(1, ndim)]
    out = np.full(out_shape, pad, dtype=tensor_list[0].dtype)
    pos = 0
    for t in tensor_list:
        sl = (slice(pos, pos + t.shape[0]),) + tuple(slice(0, s) for s in t.shape[1:])
        out[sl] = t
        pos += t.shape[0]
    return out
