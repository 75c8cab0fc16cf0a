"""Fused bilinear upsample + channel argmax (counterpart of
``accel_tpu/ops/upsample_argmax.py``): the serving tail that turns
stride-level logits into a full-resolution uint8 class map without the
full-resolution C-channel logits. The kernel is
``kernels/upsample_argmax.cu``. An argmax has no gradient: the kernel
raises on logits that autograd records rather than return a class map cut
from the graph without a word.

``upsample_argmax_op`` (``torch.ops.accel_tpu_torch.upsample_argmax``) is
the kernel as a ``torch.library`` op, for programs that ``torch.export``
traces: the kernel on a CUDA tensor, the plain version on a CPU tensor and
a fake implementation for shapes; it registers no gradient.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from accel_tpu_torch import kernels
from accel_tpu_torch.ops.upsample import resize_bilinear
from accel_tpu_torch.parallel import spatial


def upscale_taps(n_in: int, n_out: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-output-sample taps ``(i0, i1, l1)`` of the half-pixel bilinear
    upscale, exactly as ``kernels/upsample_argmax.cu`` forms them:
    ``s = (o + 0.5) * n_in / n_out - 0.5`` clamped to ``[0, n_in-1]``,
    ``i0 = floor(s)``, ``i1 = min(i0 + 1, n_in - 1)``, ``l1 = s - i0``."""
    scale = torch.tensor(n_in / n_out, dtype=torch.float32)
    s = scale * (torch.arange(n_out, dtype=torch.float32) + 0.5) - 0.5
    s = s.clamp(0.0, float(n_in - 1))
    i0 = s.to(torch.int64)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    return i0, i1, s - i0.to(torch.float32)


def resize_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) f32 matrix M with ``M @ x`` the bilinear upscale of x
    along one axis (``accel_tpu``'s ``resize_matrix`` for n_out >= n_in)."""
    i0, i1, l1 = upscale_taps(n_in, n_out)
    m = torch.zeros((n_out, n_in), dtype=torch.float32)
    rows = torch.arange(n_out)
    m.index_put_((rows, i0), 1.0 - l1, accumulate=True)
    m.index_put_((rows, i1), l1, accumulate=True)
    return m


def upsample_argmax_plain(logits: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """The kernel's plain version: materialize the bilinear resize in f32
    (``resize_bilinear``, antialiased on a downscale as ``accel_tpu``'s
    oracle is), then argmax. logits (N,C,h,w) -> (N,H,W) uint8."""
    up = resize_bilinear(logits.to(torch.float32), tuple(out_hw), plain=True)
    return up.argmax(dim=1).to(torch.uint8)


def upsample_argmax_cuda(logits: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Launch ``kernels/upsample_argmax.cu``. logits (N,C,h,w) f32 on CUDA
    -> (N,H,W) uint8. Any H >= h, W >= w; a downscale raises, and so do
    logits that require grad under grad mode."""
    device = logits.device
    if torch.is_grad_enabled() and logits.requires_grad:
        raise RuntimeError("upsample_argmax_cuda: an argmax has no gradient; call it under "
                           "torch.no_grad() or on detached logits")
    if device.type != "cuda" or logits.dtype != torch.float32:
        raise ValueError(f"upsample_argmax_cuda takes f32 CUDA logits, got "
                         f"{logits.dtype} on {device}")
    N, C, h, w = logits.shape
    H, W = int(out_hw[0]), int(out_hw[1])
    if H < h or W < w:
        raise ValueError(f"upsample_argmax_cuda upscales only: ({h},{w}) -> ({H},{W})")
    if C > 256:
        raise ValueError(f"class index {C - 1} does not fit uint8")
    if N > 65535:
        raise ValueError(f"upsample_argmax_cuda grid limit: N={N} (max 65535)")
    if not logits.is_contiguous():
        logits = logits.contiguous()
    out = torch.empty((N, H, W), dtype=torch.uint8, device=device)
    kernels.launch("upsample_argmax", device, logits.data_ptr(), out.data_ptr(),
                   N, C, h, w, H, W)
    upsample_argmax_cuda.launches += 1
    return out


upsample_argmax_cuda.launches = 0


@torch.library.custom_op("accel_tpu_torch::upsample_argmax", mutates_args=(),
                         device_types="cuda")
def upsample_argmax_op(logits: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    """#2 as an op: ``upsample_argmax_cuda`` on a CUDA tensor."""
    return upsample_argmax_cuda(logits, out_hw)


upsample_argmax_op.register_kernel("cpu")(upsample_argmax_plain)


@upsample_argmax_op.register_fake
def _(logits, out_hw):
    return logits.new_empty((logits.shape[0], out_hw[0], out_hw[1]), dtype=torch.uint8)


def upsample_argmax(logits: torch.Tensor, out_hw: tuple[int, int],
                    plain: bool = False) -> torch.Tensor:
    """``argmax(resize_bilinear(logits, out_hw), dim=1)`` as uint8: the
    kernel for a CUDA tensor, the plain version for a CPU tensor or when
    ``plain`` is set (``accel_tpu``'s ``upsample_argmax_or_oracle``);
    ``upsample_argmax_op`` while a program is traced. Under spatial
    sharding ``logits`` and ``out_hw`` are the rank's rows: the logits
    extended by a row each side, upscaled by the global row factor
    ``out_hw[0] / h`` and cropped (``parallel/spatial.py``)."""
    if spatial.active() is not None:
        factor, rem = divmod(int(out_hw[0]), logits.shape[-2])
        if rem or factor < 1:
            raise ValueError(f"spatial sharding upscales rows by an integer factor, got "
                             f"{logits.shape[-2]} -> {out_hw[0]}")
        return spatial.halo_apply(
            lambda t: upsample_argmax(t, (factor * t.shape[-2], out_hw[1]), plain), logits, 1, 1)
    if not plain and torch.compiler.is_compiling():
        return upsample_argmax_op(logits, [int(out_hw[0]), int(out_hw[1])])
    if plain or logits.device.type == "cpu":
        return upsample_argmax_plain(logits, out_hw)
    return upsample_argmax_cuda(logits, out_hw)
