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

Gradients (``DilatedConvFunction``) follow ``accel_tpu``'s custom VJP
(``ops/dilated_pallas.py:204-230``): dx is the same dilated conv of the
output gradient with the weights rotated 180 degrees and their input and
output channels swapped, on this kernel (``conv3x3_dilated_dx_cuda``,
counted in ``conv3x3_dilated_cuda.backward_launches``); dw is
``torch.nn.grad.conv2d_weight``, as the JAX backward takes dw from the lax
transpose. The dx conv's input is the output gradient, so the bf16 kernel
needs the forward's Cout % 8 == 0 there, which every ResNet conv has.

``conv3x3_dilated_op`` (``torch.ops.accel_tpu_torch.conv3x3_dilated``) is
the forward kernel as a ``torch.library`` op, for programs that
``torch.export`` traces: the kernel on a CUDA tensor, the plain version on
a CPU tensor and a fake implementation for shapes. A traced program serves
and registers no gradient; the dx stays inside ``DilatedConvFunction``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from accel_tpu_torch import kernels
from accel_tpu_torch.ops.autograd import needs_grad


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


def rotate_dilated_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Cout,Cin,3,3) -> (Cin,Cout,3,3): the 180-degree rotated weights with
    input and output channels swapped, the weights of dx's conv."""
    return weight.flip(2, 3).transpose(0, 1)


def pack_dilated_weight_dx(weight: torch.Tensor) -> torch.Tensor:
    """The kernel's packing of the dx conv's weights:
    ``pack_dilated_weight(rotate_dilated_weight(weight))``, (9, Cin, Cout)."""
    return pack_dilated_weight(rotate_dilated_weight(weight))


def conv3x3_dilated_dx_plain(grad: torch.Tensor, weight: torch.Tensor,
                             dilation: int) -> torch.Tensor:
    """The dx conv's plain version: the output gradient (N,Cout,H,W)
    convolved with the rotated weights -> (N,Cin,H,W)."""
    return conv3x3_dilated_plain(grad, rotate_dilated_weight(weight), dilation)


def _launch(x: torch.Tensor, weight: torch.Tensor, d: int,
            packed: torch.Tensor | None) -> torch.Tensor:
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
    d = int(d)
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
    return out


def conv3x3_dilated_cuda(x: torch.Tensor, weight: torch.Tensor, dilation: int,
                         packed: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``kernels/dilated_conv.cu``. x and weight both f32 or both
    bf16 on one CUDA device; f32 accumulation, output NCHW in their dtype.
    ``packed`` is ``pack_dilated_weight(weight)`` made once by the caller;
    without it the weights are packed on this call. The bf16 kernel reads
    x channels-last: an NCHW x is copied to that layout here."""
    out = _launch(x, weight, dilation, packed)
    conv3x3_dilated_cuda.launches += 1
    return out


conv3x3_dilated_cuda.launches = 0
conv3x3_dilated_cuda.backward_launches = 0


def conv3x3_dilated_dx_cuda(grad: torch.Tensor, weight: torch.Tensor, dilation: int,
                            packed_dx: torch.Tensor | None = None) -> torch.Tensor:
    """dx of ``conv3x3_dilated_cuda`` on the kernel: ``grad`` (N,Cout,H,W)
    convolved with the rotated weights (``packed_dx``, made by
    ``pack_dilated_weight_dx``, or packed on this call) -> (N,Cin,H,W).
    Counted in ``conv3x3_dilated_cuda.backward_launches``."""
    out = _launch(grad, rotate_dilated_weight(weight), dilation, packed_dx)
    conv3x3_dilated_cuda.backward_launches += 1
    return out


class DilatedConvFunction(torch.autograd.Function):
    """``conv3x3_dilated_cuda`` in the forward; dx on the kernel
    (``conv3x3_dilated_dx_cuda``) and dw by ``conv2d_weight`` in the
    backward. ``packed_dx`` is None or a callable giving the rotated
    packing of the saved weight (the model's cache)."""

    @staticmethod
    def forward(ctx, x, weight, dilation, packed, packed_dx):
        ctx.save_for_backward(x, weight)
        ctx.dilation, ctx.packed_dx = int(dilation), packed_dx
        return conv3x3_dilated_cuda(x, weight, dilation, packed)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        d = ctx.dilation
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_dilated_dx_cuda(grad, weight, d,
                                         None if ctx.packed_dx is None else ctx.packed_dx())
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(x, weight.shape, grad, padding=d, dilation=d)
        return dx, dw, None, None, None


@torch.library.custom_op("accel_tpu_torch::conv3x3_dilated", mutates_args=(),
                         device_types="cuda")
def conv3x3_dilated_op(x: torch.Tensor, weight: torch.Tensor, dilation: int,
                       packed: torch.Tensor | None) -> torch.Tensor:
    """#5's forward as an op: ``conv3x3_dilated_cuda`` on a CUDA tensor."""
    return conv3x3_dilated_cuda(x, weight, dilation, packed)


@conv3x3_dilated_op.register_kernel("cpu")
def _(x, weight, dilation, packed):
    return conv3x3_dilated_plain(x, weight, dilation).contiguous()


@conv3x3_dilated_op.register_fake
def _(x, weight, dilation, packed):
    return x.new_empty((x.shape[0], weight.shape[0], *x.shape[2:]))


def conv3x3_dilated(x: torch.Tensor, weight: torch.Tensor, dilation: int,
                    plain: bool = False, packed: torch.Tensor | None = None,
                    packed_dx=None) -> torch.Tensor:
    """Dilated 3x3 conv, no bias: the kernel for a CUDA tensor (with the
    pre-packed weights ``packed`` if given; through ``DilatedConvFunction``,
    with ``packed_dx`` for its dx, where autograd records it), the plain
    version for a CPU tensor or when ``plain`` is set;
    ``conv3x3_dilated_op`` while a program is traced."""
    if not plain and torch.compiler.is_compiling():
        return conv3x3_dilated_op(x, weight, int(dilation), packed)
    if plain or x.device.type == "cpu":
        return conv3x3_dilated_plain(x, weight, dilation)
    if needs_grad(x, weight):
        return DilatedConvFunction.apply(x, weight, dilation, packed, packed_dx)
    return conv3x3_dilated_cuda(x, weight, dilation, packed)
