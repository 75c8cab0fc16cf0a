"""Int8 serving convolutions (counterpart of ``accel_tpu/ops/quant.py``).

Symmetric int8: one dynamic scale per activation tensor (over the whole
batch the conv is called on), one static scale per output channel of the
weights, ``max(|x|, 1e-8) / 127``; values are divided by their scale,
rounded half to even and clipped to +-127. The product accumulates in
int32 and the result is ``acc * (x_scale * w_scale)`` in f32, rounded to
x's dtype. Zero padding stays exact (0 quantizes to 0).

The JAX package runs this conv in XLA (``lax.conv_general_dilated`` on int8
operands with an int32 result), outside any Pallas kernel. On the card the
port does the same with a library product: an int8 im2col (pad and strided
slices of the int8 tensor, NHWC rows; a 1x1 conv is a reshape) and cuBLAS's
int8 GEMM, ``torch._int_mm`` (int32 out). ``torch._int_mm`` on CUDA wants
m > 16 and k, n multiples of 8: every quantized ResNet and fc6 conv has
Cin*kh*kw and Cout multiples of 8 (``int_mm`` checks it), and a frame's
pixels are far more than 16. The plain version computes the same int32 accumulators
exactly: ``F.conv2d`` in float64 on the integer values (127^2 * K < 2^53
for every K here).

Weights are quantized once per weight version (``QuantizedWeight``); the
JAX package quantizes them at trace time, which XLA folds into constants.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pair(v) -> tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def quantize_symmetric(x: torch.Tensor, dim: int | None = None):
    """x -> (int8 values, f32 scale). ``dim=None``: one scale for the whole
    tensor; otherwise one per slice along ``dim`` (shaped to broadcast)."""
    if dim is None:
        s = x.abs().amax()
    else:
        s = x.abs().amax(dim=[i for i in range(x.dim()) if i != dim], keepdim=True)
    s = s.clamp_min(1e-8).to(torch.float32) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / s), -127, 127).to(torch.int8)
    return q, s


class QuantizedWeight:
    """A conv weight (Cout, Cin, kh, kw) quantized per output channel:
    ``q`` (int8, OIHW), ``scale`` (Cout,) f32 and ``mat`` (kh*kw*Cin, Cout)
    int8, the GEMM's B operand in the im2col's (ky, kx, c) order."""

    def __init__(self, weight: torch.Tensor):
        self.q, s = quantize_symmetric(weight, dim=0)
        self.scale = s.reshape(-1)
        self.mat = self.q.permute(2, 3, 1, 0).reshape(-1, weight.shape[0]).contiguous()


def int8_conv_acc_plain(xq: torch.Tensor, wq: torch.Tensor, stride, padding,
                        dilation) -> torch.Tensor:
    """The int32 accumulators of the int8 conv, exactly: ``F.conv2d`` in
    float64 on the integer values. xq (N,Cin,H,W), wq (Cout,Cin,kh,kw) int8
    -> (N,Cout,Ho,Wo) int32."""
    y = F.conv2d(xq.to(torch.float64), wq.to(torch.float64), stride=stride, padding=padding,
                 dilation=dilation)
    return y.to(torch.int32)


def im2col_int8(xq: torch.Tensor, kernel: tuple[int, int], stride, padding,
                dilation) -> tuple[torch.Tensor, int, int]:
    """xq (N,C,H,W) int8 -> ((N*Ho*Wo, kh*kw*C) int8, Ho, Wo): one row per
    output pixel in NHWC order, its taps in (ky, kx, c) order."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = (kernel, _pair(stride), _pair(padding),
                                              _pair(dilation))
    N, C, H, W = xq.shape
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    x = xq.permute(0, 2, 3, 1)
    if kh == kw == 1 and ph == pw == 0:
        return x[:, ::sh, ::sw].reshape(N * Ho * Wo, C), Ho, Wo
    x = F.pad(x, (0, 0, pw, pw, ph, ph))
    taps = [x[:, ky * dh:ky * dh + sh * (Ho - 1) + 1:sh, kx * dw:kx * dw + sw * (Wo - 1) + 1:sw]
            for ky in range(kh) for kx in range(kw)]
    return torch.stack(taps, dim=3).reshape(N * Ho * Wo, kh * kw * C), Ho, Wo


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm(a, b)``: int8 (m,k) @ int8 (k,n) -> int32 (m,n).
    Raises where CUDA's int8 GEMM refuses the shape (m <= 16, or k or n
    not a multiple of 8). Counts its calls in ``int_mm.launches``."""
    (m, k), n = a.shape, b.shape[1]
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(f"int8 GEMM of ({m},{k}) @ ({k},{n}): needs m > 16 and k, n "
                         "multiples of 8")
    int_mm.launches += 1
    return torch._int_mm(a, b)


int_mm.launches = 0


def int8_conv_acc_gemm(xq: torch.Tensor, w: QuantizedWeight, stride, padding,
                       dilation) -> torch.Tensor:
    """The int32 accumulators through im2col and ``int_mm`` -> (N,Cout,Ho,Wo)
    int32, channels innermost in memory. Runs on the card and on the CPU."""
    kh, kw = w.q.shape[2:]
    cols, Ho, Wo = im2col_int8(xq, (kh, kw), stride, padding, dilation)
    acc = int_mm(cols, w.mat)
    return acc.reshape(xq.shape[0], Ho, Wo, -1).permute(0, 3, 1, 2)


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor | QuantizedWeight, stride=1, padding=0,
                dilation=1, *, plain: bool = False) -> torch.Tensor:
    """The int8 conv of NCHW float ``x`` (no bias), in x's dtype. ``weight``
    is the float OIHW weight or its ``QuantizedWeight``. On a CUDA tensor
    the product runs through ``int_mm`` (cuBLAS), on a CPU tensor or with
    ``plain`` through ``int8_conv_acc_plain``."""
    w = weight if isinstance(weight, QuantizedWeight) else QuantizedWeight(weight)
    xq, xs = quantize_symmetric(x)
    if plain or x.device.type == "cpu":
        acc = int8_conv_acc_plain(xq, w.q, stride, padding, dilation)
    else:
        acc = int8_conv_acc_gemm(xq, w, stride, padding, dilation)
    scale = (xs * w.scale).view(1, -1, 1, 1)
    return (acc.to(torch.float32) * scale).to(x.dtype)
