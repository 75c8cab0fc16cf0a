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

An exact 2x upscale of a contiguous bf16 or f32 tensor goes to
:func:`upsample2x`: the kernel ``kernels/upsample2x.cu`` on a CUDA tensor
(no TPU kernel stands behind it: the JAX package resizes with XLA's
resize), its plain version :func:`upsample2x_plain` (``F.interpolate``,
which the kernel equals bit for bit on the card) on a CPU tensor or when
``plain`` is set. ``upsample2x_op`` (``torch.ops.accel_tpu_torch.upsample2x``)
is the kernel as a ``torch.library`` op, for programs that ``torch.export``
traces: the kernel on a CUDA tensor, the plain version on a CPU tensor, a
fake for shapes. Where autograd records the kernel, its gradient is the
exact adjoint of the taps (:func:`upsample2x_adjoint`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from accel_tpu_torch import kernels
from accel_tpu_torch.ops.autograd import needs_grad
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


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    plain: bool = False) -> torch.Tensor:
    """Bilinear-resize NCHW ``x`` to spatial size ``out_hw``, in x's dtype;
    an exact 2x upscale through :func:`upsample2x` (``plain``: its plain
    version). Under spatial sharding ``x`` holds the rank's rows and
    ``out_hw`` its rows of the output."""
    if x.dim() != 4:
        raise ValueError(f"expected 4D NCHW, got {tuple(x.shape)}")
    h, w = x.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (h, w) == (oh, ow):
        return x
    if spatial.active() is not None:
        top, bottom, stride = resize_halo(h, oh)
        return spatial.halo_apply(
            lambda t: _resize(t, t.shape[-2] * oh // h, ow, plain), x, top, bottom, stride)
    return _resize(x, oh, ow, plain)


def _resize(x: torch.Tensor, oh: int, ow: int, plain: bool = False) -> torch.Tensor:
    h, w = x.shape[-2:]
    if ((oh, ow) == (2 * h, 2 * w) and x.dtype in (torch.bfloat16, torch.float32)
            and x.is_contiguous()):
        return upsample2x(x, plain)
    antialias = oh < h or ow < w
    if antialias and x.device.type == "cpu" and x.dtype in (torch.bfloat16, torch.float16):
        return F.interpolate(x.to(torch.float32), size=(oh, ow), mode="bilinear",
                             align_corners=False, antialias=True).to(x.dtype)
    return F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=False,
                         antialias=antialias)


def bilinear_upsample(x: torch.Tensor, factor: int, plain: bool = False) -> torch.Tensor:
    """Upsample NCHW by an integer factor (``plain``: as ``resize_bilinear``)."""
    h, w = x.shape[-2:]
    return resize_bilinear(x, (h * factor, w * factor), plain)


# ---- the exact 2x upscale ----------------------------------------------------------


def upsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: the library call that computes its
    function, ``F.interpolate(x, size=(2h, 2w), mode="bilinear",
    align_corners=False)``. On a card that is ATen's
    ``upsample_bilinear2d``, which the kernel equals bit for bit; the CPU
    computes outputs of H + W <= 128 with a separable kernel whose f32
    roundings are its own (a few ulps from the kernel's order)."""
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear", align_corners=False)


def upsample2x_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``kernels/upsample2x.cu``: contiguous NCHW ``x`` (N,C,h,w),
    bf16 or f32 on CUDA -> (N,C,2h,2w) in x's dtype. Raises on anything
    else."""
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"upsample2x_cuda takes a contiguous NCHW tensor, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.device.type != "cuda" or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"upsample2x_cuda takes a bf16 or f32 CUDA tensor, got {x.dtype} on "
                         f"{x.device}")
    N, C, h, w = x.shape
    out = torch.empty((N, C, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    kernels.launch("upsample2x", x.device, x.data_ptr(), out.data_ptr(), N * C, h, w,
                   int(x.dtype == torch.bfloat16))
    upsample2x_cuda.launches += 1
    return out


upsample2x_cuda.launches = 0


def _axis_adjoint(g: torch.Tensor) -> torch.Tensor:
    """The adjoint of the 2x taps along the last axis, (..., 2n) -> (..., n).
    Input sample i took 0.75 into outputs 2i and 2i + 1 and 0.25 into
    outputs 2i - 1 and 2i + 2; output 0 took sample 0 whole (0.25 more
    than the rule) and output 2n - 1 read sample n - 1 twice (0.25 more)."""
    even, odd = g[..., 0::2], g[..., 1::2]
    before = torch.cat([even[..., :1], odd[..., :-1]], dim=-1)
    after = torch.cat([even[..., 1:], odd[..., -1:]], dim=-1)
    return 0.75 * (even + odd) + 0.25 * (before + after)


def upsample2x_adjoint(grad: torch.Tensor) -> torch.Tensor:
    """The exact adjoint of the 2x upscale, in f32 and with no atomics (the
    same sums in the same order on every run): (N,C,2h,2w) -> (N,C,h,w) in
    grad's dtype."""
    g = _axis_adjoint(grad.to(torch.float32))
    return _axis_adjoint(g.transpose(-1, -2)).transpose(-1, -2).to(grad.dtype)


class Upsample2xFunction(torch.autograd.Function):
    """The kernel in the forward; :func:`upsample2x_adjoint` in the
    backward."""

    @staticmethod
    def forward(ctx, x):
        return upsample2x_cuda(x)

    @staticmethod
    def backward(ctx, grad):
        return upsample2x_adjoint(grad)


@torch.library.custom_op("accel_tpu_torch::upsample2x", mutates_args=(), device_types="cuda")
def upsample2x_op(x: torch.Tensor) -> torch.Tensor:
    """#6 as an op: ``upsample2x_cuda`` on a CUDA tensor."""
    return upsample2x_cuda(x)


upsample2x_op.register_autograd(lambda ctx, grad: upsample2x_adjoint(grad))
upsample2x_op.register_kernel("cpu")(upsample2x_plain)


@upsample2x_op.register_fake
def _(x):
    N, C, h, w = x.shape
    return x.new_empty((N, C, 2 * h, 2 * w))


def upsample2x(x: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """The exact 2x bilinear upscale of contiguous NCHW ``x`` (bf16 or f32):
    the kernel for a CUDA tensor (through ``Upsample2xFunction`` where
    autograd records it), the plain version for a CPU tensor or when
    ``plain`` is set; ``upsample2x_op`` while a program is traced."""
    if not plain and torch.compiler.is_compiling():
        return upsample2x_op(x)
    if plain or x.device.type == "cpu":
        return upsample2x_plain(x)
    if needs_grad(x):
        return Upsample2xFunction.apply(x)
    return upsample2x_cuda(x)
