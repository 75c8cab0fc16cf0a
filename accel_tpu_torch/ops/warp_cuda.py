"""Displacement-bounded bilinear warp: CUDA kernel and its plain version.

Counterpart of ``accel_tpu/ops/warp_pallas.py::warp_pallas_fwd``: the warp
of ``ops/warp.py`` with the flow clamped to ``±max_disp`` on both axes, as
the TPU kernel clamps it. The kernel is ``kernels/warp.cu``.

Gradients (``WarpFunction``) are those of ``accel_tpu``'s custom VJP
(``ops/warp.py:139-152``): autograd through the plain warp on the same
clamped flow, so the gradient with respect to the flow is zero where the
clamp is active.

``warp_op`` (``torch.ops.accel_tpu_torch.warp``) is the kernel as a
``torch.library`` op, for programs that ``torch.export`` traces: the kernel
on a CUDA tensor, the plain version on a CPU tensor, a fake implementation
for shapes, and the same gradients. The dispatcher :func:`warp` routes
through it while a program is traced.
"""

from __future__ import annotations

import torch

from accel_tpu_torch import kernels
from accel_tpu_torch.ops.autograd import needs_grad, plain_vjp


def warp_plain(feat: torch.Tensor, flow: torch.Tensor, max_disp: float) -> torch.Tensor:
    """The kernel's plain version: the 4-gather warp of the clamped flow."""
    from accel_tpu_torch.ops.warp import bilinear_warp_plain

    d = float(max_disp)
    return bilinear_warp_plain(feat, flow.to(torch.float32).clamp(-d, d))


def warp_cuda(feat: torch.Tensor, flow: torch.Tensor, max_disp: float) -> torch.Tensor:
    """Launch ``kernels/warp.cu``. feat (N,C,H,W) f32 or bf16 on CUDA, flow
    (N,2,H,W) -> warped (N,C,H,W) in feat's dtype. Raises on anything the
    kernel does not take."""
    device = feat.device
    if device.type != "cuda" or flow.device != device:
        raise ValueError(f"warp_cuda needs CUDA tensors on one device, got "
                         f"{device} and {flow.device}")
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"warp_cuda takes f32 or bf16 feat, got {feat.dtype}")
    N, C, H, W = feat.shape
    if flow.shape != (N, 2, H, W):
        raise ValueError(f"flow {tuple(flow.shape)} does not match feat {tuple(feat.shape)}")
    # the kernel's grid: a row per image row, a z index per image and chunk
    # of 4 channels
    if H > 65535 or N * ((C + 3) // 4) > 65535:
        raise ValueError(f"warp_cuda grid limit: H={H}, N*ceil(C/4)={N * ((C + 3) // 4)} "
                         "(max 65535)")
    # the host work around a launch-sized kernel is most of its cost: copy
    # only what needs copying
    if not feat.is_contiguous():
        feat = feat.contiguous()
    if flow.dtype != torch.float32 or not flow.is_contiguous():
        flow = flow.to(torch.float32).contiguous()
    out = torch.empty_like(feat)
    kernels.launch("warp", device, feat.data_ptr(), flow.data_ptr(), out.data_ptr(), N, C, H, W,
                   float(max_disp), int(feat.dtype == torch.bfloat16))
    warp_cuda.launches += 1
    return out


warp_cuda.launches = 0


def _save(ctx, inputs, output) -> None:
    feat, flow, max_disp = inputs
    ctx.save_for_backward(feat, flow)
    ctx.max_disp = max_disp


def _backward(ctx, grad):
    """Autograd through ``warp_plain`` (the clamped flow) on the saved
    inputs."""
    d = ctx.max_disp
    return (*plain_vjp(lambda f, fl: warp_plain(f, fl, d), ctx.saved_tensors,
                       ctx.needs_input_grad[:2], grad), None)


class WarpFunction(torch.autograd.Function):
    """``warp_cuda`` in the forward; in the backward, autograd through
    ``warp_plain`` (the clamped flow) on the saved inputs."""

    @staticmethod
    def forward(ctx, feat, flow, max_disp):
        _save(ctx, (feat, flow, max_disp), None)
        return warp_cuda(feat, flow, max_disp)

    backward = staticmethod(_backward)


@torch.library.custom_op("accel_tpu_torch::warp", mutates_args=(), device_types="cuda")
def warp_op(feat: torch.Tensor, flow: torch.Tensor, max_disp: float) -> torch.Tensor:
    """#1 as an op: ``warp_cuda`` on a CUDA tensor."""
    return warp_cuda(feat, flow, max_disp)


warp_op.register_kernel("cpu")(warp_plain)
warp_op.register_autograd(_backward, setup_context=_save)


@warp_op.register_fake
def _(feat, flow, max_disp):
    return feat.new_empty(feat.shape)


def warp(feat: torch.Tensor, flow: torch.Tensor, max_disp: float,
         plain: bool = False) -> torch.Tensor:
    """Bounded warp: the kernel for a CUDA tensor (through ``WarpFunction``
    where autograd records it), the plain version for a CPU tensor or when
    ``plain`` is set; ``warp_op`` while a program is traced."""
    if plain:
        return warp_plain(feat, flow, max_disp)
    if torch.compiler.is_compiling():
        return warp_op(feat, flow, float(max_disp))
    if feat.device.type == "cpu":
        return warp_plain(feat, flow, max_disp)
    if needs_grad(feat, flow):
        return WarpFunction.apply(feat, flow, max_disp)
    return warp_cuda(feat, flow, max_disp)
