"""Fused ResNet stem: conv 7x7/2 (3 channels in, 64 out) + folded-BN
affine + relu (counterpart of ``accel_tpu/ops/fused_stem.py``). The 3x3/2
maxpool stays outside. The kernel is ``kernels/fused_stem.cu``.

As in the reference (``fused_stem_fwd`` packs ``kernel.astype(x.dtype)``),
the conv weights are rounded to x's dtype before the conv; the products
and sums are f32.

Gradients (``FusedStemFunction``) are those of ``accel_tpu``'s custom VJP
(``ops/fused_stem.py:201-218``): autograd through the plain stem with
respect to x, the weights, inv and shift.

``fused_stem_op`` (``torch.ops.accel_tpu_torch.fused_stem``) is the kernel
as a ``torch.library`` op, for programs that ``torch.export`` traces: the
kernel on a CUDA tensor, the plain version on a CPU tensor, a fake
implementation for shapes, and the same gradients. The dispatcher
:func:`fused_stem` routes through it while a program is traced.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from accel_tpu_torch import kernels
from accel_tpu_torch.ops.autograd import needs_grad, plain_vjp

# K of the tensor-core GEMM: (c, ky, kx') with kx' = kx + 1 in 0..7 (kx' = 0
# is a zero column, so the kernel reads tap pairs (kx', kx'+1) as aligned
# 32-bit words of its staged input rows), 3*7*8 = 168 taps, padded to 176
# (eleven k16 steps) with zero rows
STEM_K = 176


def pack_stem_weight(weight: torch.Tensor) -> torch.Tensor:
    """(64,3,7,7) OIHW -> the bf16 kernel's (STEM_K, 64) B operand, row
    ``(c*7 + ky)*8 + kx + 1`` holding tap (c, ky, kx); every other row is
    zero. Keeps the weight's dtype."""
    w = F.pad(weight.permute(1, 2, 3, 0), (0, 0, 1, 0))  # (3,7,8,64), kx' = 0 zero
    return F.pad(w.reshape(168, 64), (0, 0, 0, STEM_K - 168)).contiguous()


def stem_kernel_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The kernel's weight operand for an input of ``dtype``, the weights
    rounded to it: bf16 ``pack_stem_weight``'s (STEM_K, 64); f32 (3,7,7,64)
    with the output channel innermost, as the CUDA-core kernel stages it."""
    w = weight.to(dtype)
    return pack_stem_weight(w) if dtype == torch.bfloat16 else w.permute(1, 2, 3, 0).contiguous()


def fused_stem_plain(x: torch.Tensor, weight: torch.Tensor, inv: torch.Tensor,
                     shift: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version (``accel_tpu``'s kernel semantics): the
    weights rounded to x's dtype, the conv in f32, the affine, relu, cast
    back to x's dtype.

    x (N,3,H,W), weight (64,3,7,7), inv/shift (64,) -> (N,64,H/2,W/2)."""
    w = weight.to(x.dtype).to(torch.float32)
    y = F.conv2d(x.to(torch.float32), w, stride=2, padding=3)
    y = y * inv.to(torch.float32).view(1, -1, 1, 1) + shift.to(torch.float32).view(1, -1, 1, 1)
    return torch.relu(y).to(x.dtype)


def fused_stem_cuda(x: torch.Tensor, weight: torch.Tensor, inv: torch.Tensor,
                    shift: torch.Tensor, packed: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``kernels/fused_stem.cu``. x (N,3,H,W) f32 or bf16 on CUDA;
    the weights are rounded to x's dtype. bf16 runs the tensor-core kernel
    on ``pack_stem_weight``'s operand, f32 the CUDA-core kernel. ``packed``
    is ``stem_kernel_weight(weight, x.dtype)`` made once by the caller;
    without it the weights are packed on this call."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_stem_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_stem_cuda takes f32 or bf16 input, got {x.dtype}")
    N, C, H, W = x.shape
    if C != 3 or tuple(weight.shape) != (64, 3, 7, 7):
        raise ValueError(f"fused stem expects 3->64 7x7, got x {tuple(x.shape)}, "
                         f"weight {tuple(weight.shape)}")
    Ho, Wo = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    if x.dtype == torch.float32 and N > 65535:
        raise ValueError(f"fused_stem_cuda f32 grid limit: N={N} (max 65535)")
    x = x.contiguous()
    shape = (STEM_K, 64) if x.dtype == torch.bfloat16 else (3, 7, 7, 64)
    if packed is None:
        packed = stem_kernel_weight(weight.to(x.device), x.dtype)
    elif (tuple(packed.shape) != shape or packed.dtype != x.dtype or packed.device != x.device
          or not packed.is_contiguous()):
        raise ValueError(f"packed stem weight {tuple(packed.shape)} {packed.dtype} is not a "
                         f"contiguous {shape} {x.dtype} on {x.device}")
    inv = inv.to(device=x.device, dtype=torch.float32).contiguous()
    shift = shift.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty((N, 64, Ho, Wo), dtype=x.dtype, device=x.device)
    kernels.launch("fused_stem", x.device, x.data_ptr(), packed.data_ptr(), inv.data_ptr(),
                   shift.data_ptr(), out.data_ptr(), N, H, W, Ho, Wo,
                   int(x.dtype == torch.bfloat16))
    fused_stem_cuda.launches += 1
    return out


fused_stem_cuda.launches = 0


def _save(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs[:4])


def _backward(ctx, grad):
    """Autograd through ``fused_stem_plain`` on the saved inputs; none
    for the packing."""
    return (*plain_vjp(fused_stem_plain, ctx.saved_tensors, ctx.needs_input_grad[:4], grad),
            None)


class FusedStemFunction(torch.autograd.Function):
    """``fused_stem_cuda`` in the forward; in the backward, autograd
    through ``fused_stem_plain`` on the saved inputs."""

    @staticmethod
    def forward(ctx, x, weight, inv, shift, packed):
        _save(ctx, (x, weight, inv, shift, packed), None)
        return fused_stem_cuda(x, weight, inv, shift, packed)

    backward = staticmethod(_backward)


@torch.library.custom_op("accel_tpu_torch::fused_stem", mutates_args=(), device_types="cuda")
def fused_stem_op(x: torch.Tensor, weight: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor,
                  packed: torch.Tensor | None) -> torch.Tensor:
    """#3 as an op: ``fused_stem_cuda`` on a CUDA tensor."""
    return fused_stem_cuda(x, weight, inv, shift, packed)


fused_stem_op.register_autograd(_backward, setup_context=_save)


@fused_stem_op.register_kernel("cpu")
def _(x, weight, inv, shift, packed):
    return fused_stem_plain(x, weight, inv, shift).contiguous()


@fused_stem_op.register_fake
def _(x, weight, inv, shift, packed):
    N, _, H, W = x.shape
    return x.new_empty((N, 64, (H - 1) // 2 + 1, (W - 1) // 2 + 1))


def fused_stem(x: torch.Tensor, weight: torch.Tensor, inv: torch.Tensor,
               shift: torch.Tensor, plain: bool = False,
               packed: torch.Tensor | None = None) -> torch.Tensor:
    """relu(conv7x7/2(x) * inv + shift): the kernel for a CUDA tensor (with
    the pre-packed weights ``packed`` if given; through
    ``FusedStemFunction`` where autograd records it), the plain version for
    a CPU tensor or when ``plain`` is set; ``fused_stem_op`` while a
    program is traced."""
    if not plain and torch.compiler.is_compiling():
        return fused_stem_op(x, weight, inv, shift, packed)
    if plain or x.device.type == "cpu":
        return fused_stem_plain(x, weight, inv, shift)
    if needs_grad(x, weight, inv, shift):
        return FusedStemFunction.apply(x, weight, inv, shift, packed)
    return fused_stem_cuda(x, weight, inv, shift, packed)
