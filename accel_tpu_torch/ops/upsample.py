"""Bilinear resize / upsampling (counterpart of ``accel_tpu/ops/upsample.py``).

``jax.image.resize(..., 'linear')`` uses half-pixel centres, clamps at the
edges, and antialiases when it downscales (the triangle kernel widens by
the scale factor). ``F.interpolate(mode='bilinear', align_corners=False)``
is the same resize when ``antialias=True`` is set for a downscale; on an
upscale the antialias kernel equals plain bilinear, so it is set only where
some axis shrinks. ``accel_tpu``'s ``DOWNSCALE_METHOD`` defaults to the
plain resize, which is the one ported here.

PyTorch's CPU antialiased resize has no 16-bit kernels, so a CPU tensor of
a 16-bit type that is downscaled is resized in f32 and rounded back once;
a CUDA tensor keeps its own dtype throughout.

Under spatial sharding (``parallel/spatial.py``) the rows of a resize by
an integer factor read a halo: one row each side for an upscale, the
downscale's taps (``_down_taps``) for a downscale (:func:`resize_halo`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from accel_tpu_torch.parallel import spatial


@functools.lru_cache(maxsize=None)
def _down_taps(f: int) -> tuple[np.ndarray, np.ndarray]:
    """Tap offsets and interior weights of the factor-``f`` antialiased
    bilinear downscale: a stride-``f`` correlation with the triangle
    ``tri((j - x_i) / f)`` sampled at ``x_i = f*i + (f-1)/2``, normalized
    to sum 1 (``accel_tpu/ops/upsample.py::_down_taps``; the edge rows,
    where taps fall outside the image, renormalize differently)."""
    x0 = (f - 1) / 2.0
    lo = int(np.floor(x0 - f)) + 1
    hi = int(np.ceil(x0 + f)) - 1
    offs = np.arange(lo, hi + 1)
    w = np.maximum(0.0, 1.0 - np.abs((offs - x0) / f))
    return offs, w / w.sum()


def resize_halo(h: int, oh: int) -> tuple[int, int, int]:
    """(top, bottom, stride) input rows a resize of ``h`` rows to ``oh``
    reads beyond a shard: 0 where the rows keep their size; one row each
    side for an upscale by an integer factor (half-pixel centres clamp to
    the neighbours); for a downscale by an integer factor f the taps'
    reach ``_down_taps(f)`` spans, at stride f. Raises for other ratios."""
    if oh == h:
        return 0, 0, 1
    if oh % h == 0:
        return 1, 1, 1
    if h % oh == 0:
        f = h // oh
        offs, _ = _down_taps(f)
        return -int(offs[0]), int(offs[-1]) - (f - 1), f
    raise ValueError(f"spatial sharding resizes rows by integer factors only: {h} -> {oh}")


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear-resize NCHW ``x`` to spatial size ``out_hw``, in x's dtype.
    Under spatial sharding ``x`` holds the rank's rows and ``out_hw`` its
    rows of the output."""
    if x.dim() != 4:
        raise ValueError(f"expected 4D NCHW, got {tuple(x.shape)}")
    h, w = x.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (h, w) == (oh, ow):
        return x
    if spatial.active() is not None:
        top, bottom, stride = resize_halo(h, oh)
        return spatial.halo_apply(
            lambda t: _resize(t, t.shape[-2] * oh // h, ow), x, top, bottom, stride)
    return _resize(x, oh, ow)


def _resize(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    antialias = oh < h or ow < w
    if antialias and x.device.type == "cpu" and x.dtype in (torch.bfloat16, torch.float16):
        return F.interpolate(x.to(torch.float32), size=(oh, ow), mode="bilinear",
                             align_corners=False, antialias=True).to(x.dtype)
    return F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=False,
                         antialias=antialias)


def bilinear_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Upsample NCHW by an integer factor."""
    h, w = x.shape[-2:]
    return resize_bilinear(x, (h * factor, w * factor))
