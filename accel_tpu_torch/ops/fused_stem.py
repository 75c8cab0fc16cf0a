"""Fused ResNet stem: conv 7x7/2 (3 channels in, 64 out) + folded-BN
affine + relu (counterpart of ``accel_tpu/ops/fused_stem.py``). The 3x3/2
maxpool stays outside. The kernel is ``kernels/fused_stem.cu``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from accel_tpu_torch import kernels


def fused_stem_plain(x: torch.Tensor, weight: torch.Tensor, inv: torch.Tensor,
                     shift: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version (``accel_tpu``'s ``_oracle``): the conv in
    f32, the affine, relu, cast back to x's dtype.

    x (N,3,H,W), weight (64,3,7,7), inv/shift (64,) -> (N,64,H/2,W/2)."""
    y = F.conv2d(x.to(torch.float32), weight.to(torch.float32), stride=2, padding=3)
    y = y * inv.to(torch.float32).view(1, -1, 1, 1) + shift.to(torch.float32).view(1, -1, 1, 1)
    return torch.relu(y).to(x.dtype)


def fused_stem_cuda(x: torch.Tensor, weight: torch.Tensor, inv: torch.Tensor,
                    shift: torch.Tensor) -> torch.Tensor:
    """Launch ``kernels/fused_stem.cu``. x (N,3,H,W) f32 or bf16 on CUDA;
    the weights are used in f32 (as given, e.g. already rounded to bf16)."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_stem_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_stem_cuda takes f32 or bf16 input, got {x.dtype}")
    N, C, H, W = x.shape
    if C != 3 or tuple(weight.shape) != (64, 3, 7, 7):
        raise ValueError(f"fused stem expects 3->64 7x7, got x {tuple(x.shape)}, "
                         f"weight {tuple(weight.shape)}")
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    if N > 65535:
        raise ValueError(f"fused_stem_cuda grid limit: N={N} (max 65535)")
    x = x.contiguous()
    # (ci, ky, kx, co): output channel innermost, as the kernel stages it
    w = weight.to(device=x.device, dtype=torch.float32).permute(1, 2, 3, 0).contiguous()
    inv = inv.to(device=x.device, dtype=torch.float32).contiguous()
    shift = shift.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty((N, 64, Ho, Wo), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        launch = kernels.load("fused_stem")
        err = launch(x.data_ptr(), w.data_ptr(), inv.data_ptr(), shift.data_ptr(),
                     out.data_ptr(), N, H, W, Ho, Wo, int(x.dtype == torch.bfloat16),
                     torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "fused_stem_cuda")
    fused_stem_cuda.launches += 1
    return out


fused_stem_cuda.launches = 0


def fused_stem(x: torch.Tensor, weight: torch.Tensor, inv: torch.Tensor,
               shift: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """relu(conv7x7/2(x) * inv + shift): the kernel for a CUDA tensor, the
    plain version for a CPU tensor or when ``plain`` is set."""
    if plain or x.device.type == "cpu":
        return fused_stem_plain(x, weight, inv, shift)
    return fused_stem_cuda(x, weight, inv, shift)
