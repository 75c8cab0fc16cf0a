"""Flow-guided bilinear warp (counterpart of ``accel_tpu/ops/warp.py``).

``out[n, c, y, x] = feat[n, c, y + dy, x + dx]`` with bilinear interpolation
and zero padding outside the image (MXNet ``BilinearSampler`` semantics).
``flow`` is ``(N, 2, h, w)`` with channel 0 = dx (along W) and channel 1 =
dy (along H), in feature-resolution pixels.

:func:`bilinear_warp_plain` is the exact, unbounded warp, one gather of
all four taps as ``bilinear_warp_xla_stacked`` does it; the reference's
4-gather ``bilinear_warp_xla`` computes the same function, so 'taps' and
'stacked' both name it. :func:`bilinear_warp` dispatches as the
JAX package does on a TPU: ``gather='onehot'`` first, at any width, to the
wide-feature warp (``ops/warp_onehot.py``: flow_y clamped to
``±max_disp``, bf16 tap weights); then narrow maps (C <= 64) to the
displacement-bounded kernel (``ops/warp_cuda.py``), whose flow is clamped
to ``±max_disp`` on both axes; wider maps, or ``use_pallas=False``, take
the unbounded plain form.

Under spatial sharding (``parallel/spatial.py``) a bounded warp reads
ceil(max_disp) + 1 rows beyond the rank's rows (its flow and any scale
are zero-padded there: those output rows are cropped); the unbounded plain
form reads the whole frame.
"""

from __future__ import annotations

import math

import torch

from accel_tpu_torch.ops.upsample import resize_bilinear
from accel_tpu_torch.parallel import spatial
from accel_tpu_torch.ops.warp_cuda import warp
from accel_tpu_torch.ops.warp_onehot import warp_onehot


def bilinear_warp_plain(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Exact bilinear warp as one gather of all four taps
    (``bilinear_warp_xla_stacked``). feat (N,C,H,W), flow (N,2,H,W).

    The taps are gathered in feat's own dtype and summed in f32; returns
    feat's dtype."""
    N, C, H, W = feat.shape
    f32 = torch.float32
    yy = torch.arange(H, device=feat.device, dtype=f32).view(1, H, 1)
    xx = torch.arange(W, device=feat.device, dtype=f32).view(1, 1, W)
    sy = yy + flow[:, 1].to(f32)
    sx = xx + flow[:, 0].to(f32)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = sy - y0
    wx = sx - x0
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    # (N, 4, H, W) tap coordinates and weights, in the order 00, 01, 10, 11
    ys = torch.stack([y0i, y0i, y0i + 1, y0i + 1], dim=1)
    xs = torch.stack([x0i, x0i + 1, x0i, x0i + 1], dim=1)
    w = torch.stack([(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx], dim=1)
    valid = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
    idx = (ys.clamp(0, H - 1) * W + xs.clamp(0, W - 1)).reshape(N, 1, 4 * H * W)
    g = torch.gather(feat.reshape(N, C, H * W), 2, idx.expand(N, C, 4 * H * W))
    g = g.reshape(N, C, 4, H * W).to(f32)
    w = torch.where(valid, w, 0.0).reshape(N, 1, 4, H * W)
    return (g * w).sum(dim=2).reshape(N, C, H, W).to(feat.dtype)


GATHERS = ("taps", "stacked", "onehot")


def bilinear_warp(
    feat: torch.Tensor,
    flow: torch.Tensor,
    use_pallas: bool = True,
    max_disp: int = 16,
    gather: str = "taps",
    plain: bool = False,
) -> torch.Tensor:
    """Dispatching entry point (``accel_tpu.ops.warp.bilinear_warp``).

    ``use_pallas`` keeps the JAX package's name for the kernel switch;
    ``gather`` is 'taps', 'stacked' (both name the plain form where it
    runs) or 'onehot'. ``plain=True`` runs the kernel's
    plain version even on a CUDA tensor (for comparing the two)."""
    if gather not in GATHERS:
        raise ValueError(f"unknown warp gather {gather!r} {GATHERS}")
    if gather == "onehot":
        return warp_onehot(feat, flow, None, max_disp, plain=plain)
    if use_pallas and feat.shape[1] <= 64:
        halo = math.ceil(max_disp) + 1
        return spatial.halo_apply(lambda f, fl: warp(f, fl, max_disp, plain=plain), feat,
                                  halo, halo, padded=(flow,))
    return spatial.halo_apply(bilinear_warp_plain, feat, None, None, padded=(flow,))


def flow_to_feature_res(flow: torch.Tensor, feat_hw: tuple[int, int],
                        unit_scale: float, plain: bool = False) -> torch.Tensor:
    """Resize a flow field (N,2,h,w) to ``feat_hw`` in f32 and rescale its
    units by ``unit_scale`` (e.g. FlowNet ran on 2x-downscaled frames and
    features are at stride 16 -> 2/16); ``plain`` as ``resize_bilinear``."""
    return resize_bilinear(flow.to(torch.float32), feat_hw, plain) * unit_scale
