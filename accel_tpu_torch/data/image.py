"""Host-side image preprocessing (counterpart of ``accel_tpu/data/image.py``).

Short-side ``resize`` capped at a max size, BGR mean-subtract
``transform``, the label LUT and ``tensor_vstack`` batching, in numpy:
the ops of ``accel_tpu/native/__init__.py``'s numpy fallback (half-pixel
bilinear resize, normalize, LUT). The reference's C++ extension for these
loops (``accel_tpu/native/_accel_native.cpp``) has no counterpart here yet.
"""

from __future__ import annotations

import numpy as np


def resize_bilinear(im: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel-centre bilinear resize, edges clamped, in f32 (HW or HWC)."""
    squeeze = im.ndim == 2
    if squeeze:
        im = im[..., None]
    h, w, _ = im.shape
    fy = np.clip((np.arange(out_h) + 0.5) * (h / out_h) - 0.5, 0, h - 1)
    fx = np.clip((np.arange(out_w) + 0.5) * (w / out_w) - 0.5, 0, w - 1)
    y0 = fy.astype(np.int64)
    x0 = fx.astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (fy - y0)[:, None, None].astype(np.float32)
    wx = (fx - x0)[None, :, None].astype(np.float32)
    im = im.astype(np.float32)
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out[..., 0] if squeeze else out


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
    return resize_bilinear(im, out_h, out_w)


def transform(im: np.ndarray, pixel_means, pixel_stds=(1.0, 1.0, 1.0)) -> np.ndarray:
    """uint8/float HWC in BGR order -> normalized float32 (1, H, W, C)."""
    means = np.asarray(pixel_means, np.float32)
    stds = np.asarray(pixel_stds, np.float32)
    return ((im.astype(np.float32) - means) / stds).astype(np.float32)[None]


def transform_inverse(im_tensor: np.ndarray, pixel_means, pixel_stds=(1.0, 1.0, 1.0)):
    """(1, H, W, C) normalized -> uint8 HWC BGR."""
    im = im_tensor[0] * np.asarray(pixel_stds, np.float32) + np.asarray(pixel_means, np.float32)
    return np.clip(im, 0, 255).astype(np.uint8)


def map_labels(label: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Apply a 256-entry labelId -> trainId LUT (255 = ignore)."""
    return lut[label.astype(np.uint8)]


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
