"""Stride-1, 'same'-padded dilated 3x3 convolution: CUDA kernel and its
plain version (counterpart of ``accel_tpu/ops/dilated_pallas.py``; the
kernel is ``kernels/dilated_conv.cu``).

``network.dilated_conv: pallas`` routes DeepLab's atrous convs here
(``models/resnet.py::DilatedConv3x3``). The JAX hook also falls back to the
lax conv for shapes its TPU tiles reject (``_eligible``: channel counts,
H % 8, W % 16, d <= 8). The CUDA kernel takes any H, W and dilation, f32
with any channel count and bf16 with Cin % 8 == 0 (every ResNet conv), so
every conv the hook would consider goes to the kernel; no shape the router
sends falls back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from accel_tpu_torch import kernels


def conv3x3_dilated_plain(x: torch.Tensor, weight: torch.Tensor, dilation: int) -> torch.Tensor:
    """The kernel's plain version: ``F.conv2d`` with padding = dilation.
    x (N,Cin,H,W), weight (Cout,Cin,3,3) in x's dtype -> (N,Cout,H,W)."""
    d = int(dilation)
    return F.conv2d(x, weight, padding=d, dilation=d)


def pack_dilated_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Cout,Cin,3,3) OIHW -> the kernel's (9, Cout, Cin): tap 3i+j's
    (Cout x Cin) slab, Cin contiguous (the K-major B operand)."""
    Cout, Cin = weight.shape[:2]
    return weight.permute(2, 3, 0, 1).reshape(9, Cout, Cin).contiguous()


def conv3x3_dilated_cuda(x: torch.Tensor, weight: torch.Tensor, dilation: int,
                         packed: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``kernels/dilated_conv.cu``. x and weight both f32 or both
    bf16 on one CUDA device; f32 accumulation, output NCHW in their dtype.
    ``packed`` is ``pack_dilated_weight(weight)`` made once by the caller;
    without it the weights are packed on this call. The bf16 kernel reads
    x channels-last: an NCHW x is copied to that layout here."""
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(f"conv3x3_dilated_cuda needs CUDA tensors on one device, got "
                         f"{x.device} and {weight.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or weight.dtype != x.dtype:
        raise ValueError(f"conv3x3_dilated_cuda takes f32 or bf16 operands of one dtype, "
                         f"got {x.dtype} and {weight.dtype}")
    N, Cin, H, W = x.shape
    Cout = weight.shape[0]
    if tuple(weight.shape) != (Cout, Cin, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} is not ({Cout},{Cin},3,3)")
    d = int(dilation)
    if d < 1:
        raise ValueError(f"dilation {d} < 1")
    bf16 = x.dtype == torch.bfloat16
    if bf16 and Cin % 8:
        raise ValueError(f"the bf16 kernel needs Cin % 8 == 0 (16-byte TMA strides), got {Cin}")
    if not bf16 and (H > 65535 or N * -(-Cout // 64) > 65535):
        raise ValueError(f"conv3x3_dilated_cuda grid limit: H={H}, N={N}, Cout={Cout}")
    if packed is None:
        packed = pack_dilated_weight(weight)
    elif (tuple(packed.shape) != (9, Cout, Cin) or packed.dtype != x.dtype
          or packed.device != x.device or not packed.is_contiguous()):
        raise ValueError(f"packed weight {tuple(packed.shape)} {packed.dtype} is not a "
                         f"contiguous (9,{Cout},{Cin}) {x.dtype} on {x.device}")
    # bf16: NHWC (a free view when x is already channels-last); f32: NCHW
    xk = x.permute(0, 2, 3, 1).contiguous() if bf16 else x.contiguous()
    out = torch.empty((N, Cout, H, W), dtype=x.dtype, device=x.device)
    kernels.launch("dilated_conv", x.device, xk.data_ptr(), packed.data_ptr(), out.data_ptr(),
                   N, Cin, Cout, H, W, d, int(bf16))
    conv3x3_dilated_cuda.launches += 1
    return out


conv3x3_dilated_cuda.launches = 0


def conv3x3_dilated(x: torch.Tensor, weight: torch.Tensor, dilation: int,
                    plain: bool = False, packed: torch.Tensor | None = None) -> torch.Tensor:
    """Dilated 3x3 conv, no bias: the kernel for a CUDA tensor (with the
    pre-packed weights ``packed`` if given), the plain version for a CPU
    tensor or when ``plain`` is set."""
    if plain or x.device.type == "cpu":
        return conv3x3_dilated_plain(x, weight, dilation)
    return conv3x3_dilated_cuda(x, weight, dilation, packed)
