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
m > 16 and k, n multiples of 8 (``int_mm`` checks it), so
``int8_conv_acc_gemm`` zero-pads the im2col rows up to 17 and k and n up
to multiples of 8 (the weights once, in ``QuantizedWeight``), then slices
the product back: zero rows and columns add nothing to an int32
accumulator, so every conv shape computes exactly. The plain version
computes the same int32 accumulators exactly: ``F.conv2d`` in float64 on
the integer values (127^2 * K < 2^53 for every K here).

Weights are quantized once per weight version (``QuantizedWeight``); the
JAX package quantizes them at trace time, which XLA folds into constants.

The activation scale is that of the reference's whole call. Under a mesh
the JAX package runs the unsharded program (``jit``), so a call's max
runs over every frame of the global batch and every row of the frame;
here each rank holds a part of the call, and the caller that holds the
mesh opens a :class:`ScaleGroup` (``with sharing(group):``) whose ranks
take the max of their absmaxes, one all-reduce of the f32 absmax per
call. Outside a group nothing changes. A rank that holds none of a call's
samples runs a stand-in (``ScaleGroup.counts`` False): it issues the same
all-reduces, with 0 for its absmax, so that every rank of the group meets
every call.
"""

from __future__ import annotations

import contextlib
import contextvars
from collections.abc import Callable, Iterator
from dataclasses import dataclass, replace

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclass(frozen=True)
class ScaleGroup:
    """The ranks whose parts of one int8 call share its activation scale.
    ``reduce_max(t)`` returns the f32 ``t`` maxed over them (a collective
    every rank of the group makes); ``counts``: whether this rank's
    activations count (False: a stand-in, whose absmax counts as 0);
    ``batch``: under a data axis, (start, size, total), this rank's samples
    ``[start, start + size)`` of the ``total`` of the call's global batch
    (``core/pipeline.py`` chunks by it), None where every rank of the group
    holds the call's whole batch (the spatial axis)."""
    reduce_max: Callable[[torch.Tensor], torch.Tensor]
    counts: bool = True
    batch: tuple[int, int, int] | None = None

    def within(self, start: int, size: int, total: int) -> ScaleGroup:
        """This group for a call of ``total`` samples of which this rank
        holds ``[start, start + size)`` (none: a stand-in)."""
        return replace(self, counts=size > 0, batch=(start, size, total))


def process_group_max(group) -> Callable[[torch.Tensor], torch.Tensor]:
    """``reduce_max`` over a ``torch.distributed`` group: one
    ``all_reduce(op=MAX)``."""
    def reduce_max(t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return t

    return reduce_max


_GROUP: contextvars.ContextVar[ScaleGroup | None] = contextvars.ContextVar(
    "accel_tpu_torch_int8_scales", default=None)
_RECORD: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "accel_tpu_torch_int8_record", default=None)


def active() -> ScaleGroup | None:
    """The scale group of the running ``sharing`` context, or None."""
    return _GROUP.get()


@contextlib.contextmanager
def sharing(group: ScaleGroup | None) -> Iterator[ScaleGroup | None]:
    """The int8 calls take their activation scales over ``group`` for the
    duration (None: the running context's group, if any, stays)."""
    if group is None:
        yield _GROUP.get()
        return
    token = _GROUP.set(group)
    try:
        yield group
    finally:
        _GROUP.reset(token)


def bound(group: ScaleGroup | None, fn: Callable[..., object]) -> Callable[..., object]:
    """``fn`` run under ``group`` (None: the calling thread's) whatever the
    context of the thread that calls it (remat's recompute, which on the
    card runs in autograd's device thread)."""
    def run(*args, **kwargs):
        with sharing(group):
            return fn(*args, **kwargs)

    return run


@contextlib.contextmanager
def scales_recorded() -> Iterator[list[torch.Tensor]]:
    """Every int8 call's activation scale (f32 scalar tensors, in call
    order) for the duration, in this context."""
    seen: list[torch.Tensor] = []
    token = _RECORD.set(seen)
    try:
        yield seen
    finally:
        _RECORD.reset(token)


def _pair(v) -> tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def quantize_symmetric(x: torch.Tensor, dim: int | None = None,
                       group: ScaleGroup | None = None):
    """x -> (int8 values, f32 scale). ``dim=None``: one scale for the whole
    tensor, maxed over ``group`` where given (this rank's absmax, 0 for a
    stand-in or an empty tensor, in f32, exact for every float dtype);
    otherwise one per slice along ``dim`` (shaped to broadcast)."""
    if dim is None:
        s = x.abs().amax() if x.numel() else x.new_zeros(())
        if group is not None:
            local = s.to(torch.float32).reshape(1) * float(group.counts)
            s = group.reduce_max(local)[0].to(x.dtype)
    else:
        s = x.abs().amax(dim=[i for i in range(x.dim()) if i != dim], keepdim=True)
    s = s.clamp_min(1e-8).to(torch.float32) / 127.0
    q = torch.clamp(torch.round(x.to(torch.float32) / s), -127, 127).to(torch.int8)
    return q, s


class QuantizedWeight:
    """A conv weight (Cout, Cin, kh, kw) quantized per output channel:
    ``q`` (int8, OIHW), ``scale`` (Cout,) f32 and ``mat``, the GEMM's int8
    B operand: (kh*kw*Cin, Cout) in the im2col's (ky, kx, c) order,
    zero-padded to multiples of 8 in both dimensions."""

    def __init__(self, weight: torch.Tensor):
        self.q, s = quantize_symmetric(weight, dim=0)
        self.scale = s.reshape(-1)
        mat = self.q.permute(2, 3, 1, 0).reshape(-1, weight.shape[0])
        self.mat = F.pad(mat, (0, -mat.shape[1] % 8, 0, -mat.shape[0] % 8)).contiguous()


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
    int32, channels innermost in memory. The im2col rows are zero-padded to
    at least 17 and its columns to ``w.mat``'s padded k, and the product is
    sliced back to (rows, Cout): exact for every shape. Runs on the card and
    on the CPU."""
    Cout, _, kh, kw = w.q.shape
    cols, Ho, Wo = im2col_int8(xq, (kh, kw), stride, padding, dilation)
    m, k = cols.shape
    pad_k, pad_m = w.mat.shape[0] - k, max(17 - m, 0)
    if pad_k or pad_m:
        cols = F.pad(cols, (0, pad_k, 0, pad_m))
    acc = int_mm(cols, w.mat)
    if pad_m or acc.shape[1] != Cout:
        acc = acc[:m, :Cout]
    return acc.reshape(xq.shape[0], Ho, Wo, Cout).permute(0, 3, 1, 2)


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor | QuantizedWeight, stride=1, padding=0,
                dilation=1, *, plain: bool = False,
                group: ScaleGroup | None = None) -> torch.Tensor:
    """The int8 conv of NCHW float ``x`` (no bias), in x's dtype. ``weight``
    is the float OIHW weight or its ``QuantizedWeight``; the activation
    scale is maxed over ``group`` where given. On a CUDA tensor the
    product runs through ``int_mm`` (cuBLAS), on a CPU tensor or with
    ``plain`` through ``int8_conv_acc_plain``. Records its scale where
    ``scales_recorded`` is open."""
    w = weight if isinstance(weight, QuantizedWeight) else QuantizedWeight(weight)
    xq, xs = quantize_symmetric(x, group=group)
    record = _RECORD.get()
    if record is not None:
        record.append(xs.detach().clone())
    if plain or x.device.type == "cpu":
        acc = int8_conv_acc_plain(xq, w.q, stride, padding, dilation)
    else:
        acc = int8_conv_acc_gemm(xq, w, stride, padding, dilation)
    scale = (xs * w.scale).view(1, -1, 1, 1)
    return (acc.to(torch.float32) * scale).to(x.dtype)
