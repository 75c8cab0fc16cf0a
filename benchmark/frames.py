"""Seeded camera frames, made on the device.

A scene is a smooth random image (normal noise at an eighth of the frame
size, bilinearly upsampled); a clip pans it ``PAN`` pixels a frame to the
right, as a camera moving along a street does. Frames are normalized f32
(B, F, H, W, 3), the layout the program's serving API takes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PAN = 4


def panning_clip(n_frames: int, hw: tuple[int, int], seed: int, device) -> torch.Tensor:
    """(1, n_frames, H, W, 3) f32: one scene drawn from ``seed``, panned."""
    g = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn((1, 3, hw[0] // 8, hw[1] // 8), generator=g, device=device)
    base = F.interpolate(base, size=tuple(hw), mode="bilinear", align_corners=False)
    clip = torch.stack([torch.roll(base, shifts=PAN * t, dims=3) for t in range(n_frames)],
                       dim=1)
    return clip.permute(0, 1, 3, 4, 2).contiguous()


def nchw(frames: torch.Tensor) -> torch.Tensor:
    """(F, H, W, 3) -> (F, 3, H, W) f32."""
    return frames.permute(0, 3, 1, 2).float()
