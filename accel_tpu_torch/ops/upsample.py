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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear-resize NCHW ``x`` to spatial size ``out_hw``, in x's dtype."""
    if x.dim() != 4:
        raise ValueError(f"expected 4D NCHW, got {tuple(x.shape)}")
    h, w = x.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (h, w) == (oh, ow):
        return x
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
