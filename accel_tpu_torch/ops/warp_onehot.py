"""Bilinear warp of wide feature maps with a fused scale epilogue: CUDA
kernel and its plain version (counterpart of ``accel_tpu/ops/warp_onehot.py``
``warp_onehot_fwd``; the kernel is ``kernels/warp_onehot.cu``).

The TPU kernel serves DFF's 1024-channel fc6 feature warp. Its numerics,
which both versions here repeat:

- flow_y is clamped to ``±max_disp``; flow_x is not clamped;
- each tap weight ``ry * cx`` is formed in f32 and rounded once to
  ``weights_dtype`` (bf16 by default);
- the feature values are rounded to ``weights_dtype`` too;
- taps outside the image read 0; the sum is in f32;
- with ``scale``: ``out * (f32(scale) * gain[n])``, gain only when given;
- the result is cast to feat's dtype.

The kernel stages each channel chunk's source window (the band's rows and
the ±ceil(D) rows around them, zero outside the image) in shared memory;
:func:`plan` sizes the bands, chunks and stages from the shape.

Gradients (``WarpOnehotFunction``) take the place of ``accel_tpu``'s
custom VJP (``ops/warp_onehot.py:366-404``, the gather oracle's VJP):
autograd through the plain version, with its flow_y clamp, tap-weight
rounding, ``scale`` and ``gain``, with respect to each of feat, flow,
scale and gain.

``warp_onehot_op`` (``torch.ops.accel_tpu_torch.warp_onehot``) is the
kernel as a ``torch.library`` op, for programs that ``torch.export``
traces: the kernel on a CUDA tensor, the plain version on a CPU tensor, a
fake implementation for shapes, and the same gradients. The dispatcher
:func:`warp_onehot` routes through it while a program is traced.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from accel_tpu_torch import kernels
from accel_tpu_torch.ops.autograd import needs_grad, plain_vjp
from accel_tpu_torch.parallel import spatial

_WEIGHTS_DTYPES = (torch.bfloat16, torch.float32)

SMEM_PER_SM = 233472        # 228 KB of shared memory per SM (H100)
SMEM_PER_BLOCK = 232448     # 227 KB, a block's most
MAX_CONSUMERS = 512         # the kernel's __launch_bounds__, less the producer warp
SMS = 132                   # an H100 SXM's SMs, when no card is asked


class Plan(NamedTuple):
    """How ``kernels/warp_onehot.cu`` cuts a shape: bands of ``rows`` output
    rows, windows of ``chunk`` channels, ``stages`` windows in flight (2 or
    3 under TMA staging, 2 under cp.async), ``runs`` blocks along the
    channels, each ``run`` chunks long, ``smem`` bytes of shared memory a
    block. A window is ``win_rows`` (the band and ceil(D) rows above and
    below it) x ``width`` (the row and 16 bytes of zero columns on each
    side: TMA starts a box only on a 16-byte boundary)."""
    tma: bool
    rows: int
    chunk: int
    stages: int
    runs: int
    run: int
    win_rows: int
    width: int
    smem: int
    grid: tuple[int, int, int]


@functools.lru_cache(maxsize=256)
def plan(N: int, C: int, H: int, W: int, max_disp: float, elem: int, aligned: bool = True,
         sms: int = SMS) -> Plan:
    """The kernel's cut of an (N,C,H,W) map of ``elem``-byte features.

    TMA staging where a feature row is a multiple of 16 bytes, every pointer
    is 16-byte aligned (``aligned``) and a window row is at most 256
    columns; cp.async otherwise. The tallest band (16 rows where that takes
    at most 256 threads, else 8, 4, 2, 1), then the largest chunk (8, 4, 2,
    1 channels), whose stages let two blocks share an SM (on an H100 the
    16-row bands were the faster at the DFF shapes, and one block per SM
    much the slower). The run length takes the fewest waves of blocks times
    the chunks a block walks (plus one for its set-up). Raises
    ``ValueError`` where even one row and one channel do not fit."""
    halo = math.ceil(max_disp)
    per_thread = 16 // elem           # pixels a thread, and zero columns a side
    width = W + 2 * per_thread
    tpr = -(-W // per_thread)
    tma = aligned and W * elem % 16 == 0 and width <= 256
    for stages in ((3, 2) if tma else (2,)):
        for rows in (16, 8, 4, 2, 1):
            consumers = -(-tpr * rows // 32) * 32
            win_rows = rows + 2 * halo + 1
            # 16-row bands only as far as 256 threads: more would leave
            # registers for one block per SM
            if (consumers > (256 if rows > 8 else MAX_CONSUMERS)
                    or (tma and win_rows > 256)):
                continue
            threads = consumers + (32 if tma else 0)
            for chunk in (8, 4, 2, 1):
                stage = -(-chunk * win_rows * width * elem // 128) * 128
                smem = 128 + stages * (stage + 16)
                if smem > SMEM_PER_BLOCK or 2 * (smem + 1024) > SMEM_PER_SM:
                    continue
                per_sm = min(32, 2048 // threads, SMEM_PER_SM // (smem + 1024))
                bands, nchunks = -(-H // rows), -(-C // chunk)
                cost = lambda run: (-(-N * bands * -(-nchunks // run) // (sms * per_sm))
                                    * (run + 1))
                run = min(range(nchunks, 0, -1), key=cost)
                runs = -(-nchunks // run)
                return Plan(tma, rows, chunk, stages, runs, run, win_rows, width, smem,
                            (bands, runs, N))
    raise ValueError(f"warp_onehot_cuda: no staging of ({N},{C},{H},{W}) with max_disp "
                     f"{max_disp} fits {SMEM_PER_BLOCK} bytes of shared memory")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_args(feat, flow, scale, gain, weights_dtype) -> None:
    N, C, H, W = feat.shape
    if tuple(flow.shape) != (N, 2, H, W):
        raise ValueError(f"flow {tuple(flow.shape)} does not match feat {tuple(feat.shape)}")
    if scale is not None and tuple(scale.shape) != tuple(feat.shape):
        raise ValueError(f"scale {tuple(scale.shape)} does not match feat {tuple(feat.shape)}")
    if gain is not None:
        if scale is None:
            raise ValueError("gain requires scale (it rides the scale epilogue)")
        if tuple(gain.shape) != (N,):
            raise ValueError(f"gain {tuple(gain.shape)} is not ({N},)")
    if weights_dtype not in _WEIGHTS_DTYPES:
        raise ValueError(f"weights_dtype must be bf16 or f32, got {weights_dtype}")


def warp_onehot_plain(feat: torch.Tensor, flow: torch.Tensor, scale: torch.Tensor | None = None,
                      max_disp: int = 4, gain: torch.Tensor | None = None,
                      weights_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's plain version: a 4-gather warp with the TPU kernel's
    clamp and roundings. feat (N,C,H,W), flow (N,2,H,W) (dx, dy), scale like
    feat, gain (N,) -> (N,C,H,W) in feat's dtype."""
    _check_args(feat, flow, scale, gain, weights_dtype)
    N, C, H, W = feat.shape
    f32 = torch.float32
    d = float(max_disp)
    dx = flow[:, 0].to(f32)
    dy = flow[:, 1].to(f32).clamp(-d, d)
    yy = torch.arange(H, device=feat.device, dtype=f32).view(1, H, 1)
    xx = torch.arange(W, device=feat.device, dtype=f32).view(1, 1, W)
    sy = yy + dy
    sx = xx + dx
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = sy - y0
    wx = sx - x0

    flat = feat.to(weights_dtype).to(f32).reshape(N, C, H * W)
    out = torch.zeros((N, C, H * W), dtype=f32, device=feat.device)
    for oy, ox, w in (
        (0, 0, (1 - wy) * (1 - wx)),
        (0, 1, (1 - wy) * wx),
        (1, 0, wy * (1 - wx)),
        (1, 1, wy * wx),
    ):
        w = w.to(weights_dtype).to(f32)
        yi, xi = y0 + oy, x0 + ox
        # bounds in float: flow_x is unbounded
        valid = ((yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)).reshape(N, 1, H * W)
        idx = (yi.clamp(0, H - 1).to(torch.int64) * W
               + xi.clamp(0, W - 1).to(torch.int64))
        g = torch.gather(flat, 2, idx.reshape(N, 1, H * W).expand(N, C, H * W))
        out = out + torch.where(valid, g, 0.0) * w.reshape(N, 1, H * W)
    out = out.reshape(N, C, H, W)
    if scale is not None:
        s = scale.to(f32)
        if gain is not None:
            s = s * gain.to(f32).view(N, 1, 1, 1)
        out = out * s
    return out.to(feat.dtype)


def warp_onehot_cuda(feat: torch.Tensor, flow: torch.Tensor, scale: torch.Tensor | None = None,
                     max_disp: int = 4, gain: torch.Tensor | None = None,
                     weights_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Launch ``kernels/warp_onehot.cu``. feat and scale f32 or bf16 on one
    CUDA device. Raises on anything the kernel does not take."""
    if feat.device.type != "cuda" or flow.device != feat.device:
        raise ValueError(f"warp_onehot_cuda needs CUDA tensors on one device, got "
                         f"{feat.device} and {flow.device}")
    _check_args(feat, flow, scale, gain, weights_dtype)
    for name, t in (("feat", feat), ("scale", scale)):
        if t is not None and t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"warp_onehot_cuda takes f32 or bf16 {name}, got {t.dtype}")
    if max_disp < 0:
        raise ValueError(f"max_disp must be >= 0, got {max_disp}")
    N, C, H, W = feat.shape
    feat = feat.contiguous()
    flow = flow.to(torch.float32).contiguous()
    if scale is not None:
        scale = scale.to(feat.device).contiguous()
    if gain is not None:
        gain = gain.to(device=feat.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(feat)
    aligned = all(t.data_ptr() % 16 == 0 for t in (feat, scale, out) if t is not None)
    p = plan(N, C, H, W, float(max_disp), feat.element_size(), aligned,
             _sm_count(feat.device.index))
    if p.grid[1] > 65535 or p.grid[2] > 65535:
        raise ValueError(f"warp_onehot_cuda grid limit: {p.grid} (runs and N at most 65535)")
    kernels.launch("warp_onehot", feat.device, feat.data_ptr(), flow.data_ptr(),
                   None if scale is None else scale.data_ptr(),
                   None if gain is None else gain.data_ptr(), out.data_ptr(),
                   N, C, H, W, float(max_disp), int(feat.dtype == torch.bfloat16),
                   int(scale is not None and scale.dtype == torch.bfloat16),
                   int(weights_dtype == torch.bfloat16), p.rows, p.chunk, p.stages, p.runs,
                   int(p.tma))
    warp_onehot_cuda.launches += 1
    return out


warp_onehot_cuda.launches = 0


def _vjp(ctx, needs, grad) -> tuple:
    """Autograd through ``warp_onehot_plain`` on the saved (feat, flow,
    scale, gain): the gradients of those whose ``needs`` is set, in that
    order."""
    d, wd = ctx.max_disp, ctx.weights_dtype
    return plain_vjp(lambda f, fl, s, g: warp_onehot_plain(f, fl, s, d, g, wd),
                     ctx.saved_tensors, needs, grad)


class WarpOnehotFunction(torch.autograd.Function):
    """``warp_onehot_cuda`` in the forward; in the backward, autograd
    through ``warp_onehot_plain`` on the saved inputs."""

    @staticmethod
    def forward(ctx, feat, flow, scale, gain, max_disp, weights_dtype):
        ctx.save_for_backward(feat, flow, scale, gain)
        ctx.max_disp, ctx.weights_dtype = max_disp, weights_dtype
        return warp_onehot_cuda(feat, flow, scale, max_disp, gain, weights_dtype)

    @staticmethod
    def backward(ctx, grad):
        return (*_vjp(ctx, ctx.needs_input_grad[:4], grad), None, None)


@torch.library.custom_op("accel_tpu_torch::warp_onehot", mutates_args=(), device_types="cuda")
def warp_onehot_op(feat: torch.Tensor, flow: torch.Tensor, scale: torch.Tensor | None,
                   max_disp: float, gain: torch.Tensor | None,
                   weights_dtype: torch.dtype) -> torch.Tensor:
    """#4 as an op, in ``warp_onehot``'s argument order:
    ``warp_onehot_cuda`` on a CUDA tensor."""
    return warp_onehot_cuda(feat, flow, scale, max_disp, gain, weights_dtype)


warp_onehot_op.register_kernel("cpu")(warp_onehot_plain)


def _op_save(ctx, inputs, output) -> None:
    feat, flow, scale, max_disp, gain, weights_dtype = inputs
    ctx.save_for_backward(feat, flow, scale, gain)
    ctx.max_disp, ctx.weights_dtype = max_disp, weights_dtype


def _op_backward(ctx, grad):
    n = ctx.needs_input_grad
    gf, gfl, gs, gg = _vjp(ctx, (n[0], n[1], n[2], n[4]), grad)
    return gf, gfl, gs, None, gg, None


warp_onehot_op.register_autograd(_op_backward, setup_context=_op_save)


@warp_onehot_op.register_fake
def _(feat, flow, scale, max_disp, gain, weights_dtype):
    return feat.new_empty(feat.shape)


def warp_onehot(feat: torch.Tensor, flow: torch.Tensor, scale: torch.Tensor | None = None,
                max_disp: int = 4, gain: torch.Tensor | None = None,
                weights_dtype: torch.dtype = torch.bfloat16, plain: bool = False) -> torch.Tensor:
    """Warp [* scale * gain]: the kernel for a CUDA tensor (through
    ``WarpOnehotFunction`` where autograd records it), the plain version for
    a CPU tensor or when ``plain`` is set; ``warp_onehot_op`` while a
    program is traced. Under spatial sharding on the rank's rows extended
    by ceil(max_disp) + 1 rows each side (flow_y is clamped; W is whole),
    flow and scale zero-padded there (``parallel/spatial.py``)."""
    halo = math.ceil(max_disp) + 1
    return spatial.halo_apply(
        lambda f, fl, s: _warp_onehot(f, fl, s, max_disp, gain, weights_dtype, plain),
        feat, halo, halo, padded=(flow, scale))


def _warp_onehot(feat, flow, scale, max_disp, gain, weights_dtype, plain):
    if not plain and torch.compiler.is_compiling():
        return warp_onehot_op(feat, flow, scale, float(max_disp), gain, weights_dtype)
    if plain or feat.device.type == "cpu":
        return warp_onehot_plain(feat, flow, scale, max_disp, gain, weights_dtype)
    if needs_grad(feat, flow, scale, gain):
        return WarpOnehotFunction.apply(feat, flow, scale, gain, max_disp, weights_dtype)
    return warp_onehot_cuda(feat, flow, scale, max_disp, gain, weights_dtype)
