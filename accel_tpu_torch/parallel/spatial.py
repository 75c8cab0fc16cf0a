"""The spatial axis of the mesh: each frame's rows split over ranks, with
halo exchanges (counterpart of the ``spatial`` axis of
``accel_tpu/parallel/mesh.py``, where XLA's SPMD partitioner inserts the
convolutions' halo exchanges).

Each rank of a spatial group of S ranks holds rows ``[s*h, (s+1)*h)`` of
every tensor of the model's inference path, h = H/S at each level. The
module is active only inside ``with spatial_sharding(mesh, model):``,
which the callers open around the model call; outside it every op runs as
it does without a mesh.

One rule serves every op that reads a window of rows:

1. extend: the rank gathers ``top`` rows from the ranks above it and
   ``bottom`` rows from the ranks below (both rounded up to the op's row
   stride; where a halo is taller than a shard, from further ranks), and
   none past the frame's top or bottom;
2. run the op as it is, with its own padding and edge rule, on the
   extended shard, so that at the frame's edges its zero padding, -inf,
   edge clamp or renormalised taps give the global answer;
3. crop the output rows that belong to the halo.

No kernel changes and no op needs a global row offset. The convs run the
rule through forward pre- and post-hooks on every ``nn.Conv2d`` of the
model (int8 convs too: their activation scale is the whole call's, over
the scale group that :func:`spatial_sharding` opens, ``ops/quant.py``); the
functional ops (resizes, warps, the fused stem, the s2d stem and the
folded downscales, which pad by hand, the max pool, the upsample+argmax
tail) call :func:`halo_apply`, and the reductions over H (GroupNorm's
statistics, mean1's per-sample mean) :func:`row_sum`.
Both pass their arguments through outside a context, so an op calls them
unconditionally; only the resizes (``resize_bilinear``,
``upsample_argmax``) branch on :func:`active`, because the integer row
ratio a halo needs is a condition of sharding alone: outside it any ratio
resizes.

The exchange is one ``all_gather`` of every rank's boundary rows within
its spatial group, as bytes, so NCCL and gloo serve it alike. Training
differentiates through it: the exchange and the sums over the group are
autograd Functions. The exchange's backward returns the gradient of every
halo row to the rank that owns the row and sums it there (the
reduce-scatter of the all-gather, run as one all-reduce of the rows each
rank returns, in the gradient's dtype); the sum's backward all-reduces
the gradient (``torch.distributed.nn.functional.all_reduce``'s rule).
Both backends serve all-reduce on CPU and CUDA tensors. Backward
collectives pair up across ranks by the order autograd runs them, which
is the same on every rank because every rank builds the same graph. The
shard is read from a ``ContextVar``, which autograd's own thread (where a
backward runs the recompute of ``torch.utils.checkpoint`` on the card)
does not see: a recomputed function runs under :func:`bound`, which sets
the caller's shard again around it.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from collections.abc import Callable, Iterator

import torch
import torch.distributed as dist
from torch import nn
import torch.nn.functional as F

from accel_tpu_torch.ops import quant

_ACTIVE: contextvars.ContextVar[SpatialShard | None] = contextvars.ContextVar(
    "accel_tpu_torch_spatial", default=None)


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def window_halo(k: int, stride: int = 1, dilation: int = 1,
                padding: int | None = None) -> tuple[int, int]:
    """(top, bottom) input rows an op with a k-row window, ``stride``,
    ``dilation`` and top ``padding`` (default 'same': dilation*(k//2))
    needs from beyond its shard: ``padding`` above and ``dilation*(k-1) -
    padding`` below, each rounded up to a multiple of the stride so that
    the crop starts on an output row."""
    p = dilation * (k // 2) if padding is None else padding
    return _ceil_to(p, stride), _ceil_to(max(dilation * (k - 1) - p, 0), stride)


def conv_halo(conv: nn.Conv2d) -> tuple[int, int, int]:
    """(top, bottom, stride) of a conv's rows, from its kernel size,
    dilation, stride and padding."""
    if isinstance(conv.padding, str) or conv.padding_mode != "zeros":
        raise ValueError(f"spatial sharding takes zero-padded convs with integer padding, got "
                         f"padding={conv.padding!r}, padding_mode={conv.padding_mode!r}")
    s = conv.stride[0]
    return (*window_halo(conv.kernel_size[0], s, conv.dilation[0], conv.padding[0]), s)


class SpatialShard:
    """One rank's part of a spatial group: the group, its size S and this
    rank's ``index`` s, and what its collectives moved. In the forward:
    ``exchanges`` (halo all-gathers), ``halo_bytes`` (bytes of the halo
    rows received, the recompute's included), ``reductions`` (all-reduces over H) and ``gathers``
    (whole maps assembled by :func:`gather_rows`); the ``*_recomputed``
    counts are the exchanges and reductions a backward's recompute ran
    again; the ``*_backward`` counts are those of the backward itself,
    ``halo_bytes_backward`` the bytes of the halo rows whose gradient was
    returned."""

    COUNTERS = ("exchanges", "halo_bytes", "reductions", "gathers", "exchanges_recomputed",
                "reductions_recomputed", "exchanges_backward", "halo_bytes_backward",
                "reductions_backward")

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index
        for name in self.COUNTERS:
            setattr(self, name, 0)
        self._pending: dict[int, tuple[int, int, int]] = {}

    def counters(self) -> dict[str, int]:
        return {name: getattr(self, name) for name in self.COUNTERS}

    def _count_forward(self, kind: str) -> None:
        """One more forward ``kind`` ('exchanges', 'reductions'), counted
        as recomputed where it runs inside a backward."""
        if in_backward():
            kind += "_recomputed"
        setattr(self, kind, getattr(self, kind) + 1)

    # the collectives, without autograd (a test's shard stands in others)

    def _all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (the same shape and dtype on each), as bytes."""
        flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
        parts = [torch.empty_like(flat) for _ in range(self.size)]
        dist.all_gather(parts, flat, group=self.group)
        return [p.view(t.dtype).view(t.shape) for p in parts]

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group (a new tensor)."""
        out = t.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.group)
        return out

    def extend(self, x: torch.Tensor, top: int | None, bottom: int | None,
               stride: int = 1) -> tuple[torch.Tensor, int, int]:
        """``x`` (..., h, W), this rank's rows, with ``top`` rows of the
        ranks above and ``bottom`` rows of the ranks below it (None: every
        row there), each rounded up to ``stride``; fewer at the frame's top
        and bottom. Returns the extended tensor (contiguous; ``x`` itself
        where there is no halo) and the rows it took above and below.
        Raises where h does not divide by the stride: the rank's first row
        would not start an output row. Differentiable (``_Exchange``)."""
        h = x.shape[-2]
        if h % stride:
            raise ValueError(f"spatial sharding: a shard of {h} rows at a stride-{stride} op "
                             f"starts at row {self.index * h}, not a multiple of {stride}")
        S, s = self.size, self.index
        top = (S - 1) * h if top is None else _ceil_to(top, stride)
        bottom = (S - 1) * h if bottom is None else _ceil_to(bottom, stride)
        if top == 0 and bottom == 0:
            return x, 0, 0
        # every rank sends its last min(top, h) rows (the halo of the ranks
        # below) and its first min(bottom, h) rows (of the ranks above)
        rows = (min(top, h), min(bottom, h), min(top, s * h), min(bottom, (S - 1 - s) * h))
        ext = _Exchange.apply(x, self, rows)
        t, b = rows[2:]
        self._count_forward("exchanges")
        self.halo_bytes += (t + b) * x[..., :1, :].numel() * x.element_size()
        return ext, t, b

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The whole of ``t`` (..., h, W) from the rows every rank of the
        group holds (eval: no gradient passes)."""
        if torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError("spatial sharding: gather_rows has no backward (eval only)")
        self.gathers += 1
        return torch.cat(self._all_gather(t), dim=-2)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group (a new tensor), differentiable
        (``_GroupSum``)."""
        self._count_forward("reductions")
        return _GroupSum.apply(t, self)

    # ---- the conv hooks ---------------------------------------------------

    def _pre_hook(self, conv: nn.Conv2d, args):
        if _ACTIVE.get() is not self:
            return None
        top, bottom, stride = conv_halo(conv)
        x = args[0]
        ext, t, _ = self.extend(x, top, bottom, stride)
        if ext is x:
            return None
        self._pending[id(conv)] = (t, x.shape[-2], ext.shape[-2])
        return (ext, *args[1:])

    def _post_hook(self, conv: nn.Conv2d, args, out):
        if _ACTIVE.get() is not self:
            return None
        rows = self._pending.pop(id(conv), None)
        return None if rows is None else crop(out, *rows)

    @contextlib.contextmanager
    def serving(self, model: nn.Module) -> Iterator[SpatialShard]:
        """This shard active, with its hooks on every ``nn.Conv2d`` of
        ``model`` (subclasses included), for the duration."""
        handles = []
        token = _ACTIVE.set(self)
        try:
            for m in model.modules():
                if isinstance(m, nn.Conv2d):
                    handles.append(m.register_forward_pre_hook(self._pre_hook))
                    handles.append(m.register_forward_hook(self._post_hook))
            yield self
        finally:
            for handle in handles:
                handle.remove()
            _ACTIVE.reset(token)


class _Exchange(torch.autograd.Function):
    """``SpatialShard.extend``'s halo: ``x`` (..., h, W) -> the extended
    shard, with ``rows`` = (last, first, t, b): every rank sends its last
    ``last`` and first ``first`` rows in one all-gather; this rank takes
    ``t`` rows above (the last rows of the ranks above it, ``last`` from
    each) and ``b`` below (the first rows of the ranks below). The backward
    puts each halo row's gradient in the slot of the rank that sent the
    row, all-reduces the slots of every rank and adds this rank's slot to
    the gradient of the rows it sent."""

    @staticmethod
    def forward(ctx, x, shard: SpatialShard, rows: tuple[int, int, int, int]):
        h = x.shape[-2]
        last, first, t, b = rows
        parts = shard._all_gather(torch.cat([x[..., h - last:, :], x[..., :first, :]], dim=-2))
        s = shard.index
        pieces = []
        if t:
            above = parts[s - math.ceil(t / h):s]
            pieces.append(torch.cat([p[..., :last, :] for p in above], dim=-2)[..., -t:, :])
        pieces.append(x)
        if b:
            below = parts[s + 1:s + 1 + math.ceil(b / h)]
            pieces.append(torch.cat([p[..., last:, :] for p in below], dim=-2)[..., :b, :])
        ctx.shard, ctx.rows, ctx.h = shard, rows, h
        return torch.cat(pieces, dim=-2)

    @staticmethod
    def backward(ctx, grad):
        shard, (last, first, t, b), h = ctx.shard, ctx.rows, ctx.h
        s = shard.index
        lead, width = grad.shape[:-2], grad.shape[-1]
        # slot q: the gradient of the rows rank q sent, as this rank used them
        slots = grad.new_zeros((shard.size, *lead, last + first, width))
        if t:  # the last t of the `last` rows ranks s-n .. s-1 sent
            n = math.ceil(t / h)
            above = grad.new_zeros((*lead, n * last, width))
            above[..., n * last - t:, :] = grad[..., :t, :]
            slots[s - n:s, ..., :last, :] = above.unflatten(-2, (n, last)).movedim(-3, 0)
        if b:  # the first b of the `first` rows ranks s+1 .. s+n sent
            n = math.ceil(b / h)
            below = grad.new_zeros((*lead, n * first, width))
            below[..., :b, :] = grad[..., t + h:, :]
            slots[s + 1:s + 1 + n, ..., last:, :] = below.unflatten(-2, (n, first)).movedim(-3, 0)
        mine = shard._all_reduce(slots)[s]
        shard.exchanges_backward += 1
        shard.halo_bytes_backward += (t + b) * grad[..., :1, :].numel() * grad.element_size()
        dx = grad[..., t:t + h, :].clone()
        dx[..., h - last:, :] += mine[..., :last, :]
        dx[..., :first, :] += mine[..., last:, :]
        return dx, None, None


class _GroupSum(torch.autograd.Function):
    """``t`` summed over ``shard``'s group; the backward all-reduces the
    gradient (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, t, shard: SpatialShard):
        ctx.shard = shard
        return shard._all_reduce(t)

    @staticmethod
    def backward(ctx, grad):
        ctx.shard.reductions_backward += 1
        return ctx.shard._all_reduce(grad), None


def crop(y: torch.Tensor, t: int, h: int, ext_h: int) -> torch.Tensor:
    """The rows of ``y`` (an op's output on an extended shard of ``ext_h``
    rows, ``t`` of them from above) that belong to the ``h`` rows of the
    shard: the op's row ratio out/in maps both."""
    n = y.shape[-2]
    if t * n % ext_h or h * n % ext_h:
        raise RuntimeError(f"spatial sharding: {n} output rows of {ext_h} input rows do not "
                           f"map the shard's {h} rows ({t} above) onto whole rows")
    start = t * n // ext_h
    return y[..., start:start + h * n // ext_h, :]


def active() -> SpatialShard | None:
    """The spatial shard of the running ``spatial_sharding`` context, or None."""
    return _ACTIVE.get()


def in_backward() -> bool:
    """Whether a backward runs in this thread: a forward op here is remat's
    recompute."""
    return torch._C._current_graph_task_id() != -1


def bound(shard: SpatialShard | None, fn: Callable[..., object]) -> Callable[..., object]:
    """``fn`` run with ``shard`` active (None: inactive), whatever the
    context of the thread that calls it: a function that
    ``torch.utils.checkpoint`` recomputes in a backward, which on the card
    runs in autograd's device thread."""
    def run(*args, **kwargs):
        token = _ACTIVE.set(shard)
        try:
            return fn(*args, **kwargs)
        finally:
            _ACTIVE.reset(token)

    return run


def halo_apply(fn: Callable[..., torch.Tensor], x: torch.Tensor, top: int | None,
               bottom: int | None, stride: int = 1,
               padded: tuple[torch.Tensor | None, ...] = ()) -> torch.Tensor:
    """``fn(x, *padded)`` for an op whose output rows read ``top``/``bottom``
    rows beyond them (None: every row of the frame there) at a row
    ``stride``: outside a spatial context, ``fn`` as it is; inside, on the
    extended shard (each of ``padded``, per-row inputs whose halo rows do
    not matter, zero-padded by as many rows; None stays None), with the
    context suspended, then cropped to the shard's rows."""
    shard = _ACTIVE.get()
    if shard is None:
        return fn(x, *padded)
    ext, t, b = shard.extend(x, top, bottom, stride)
    extra = [None if p is None else F.pad(p, (0, 0, t, b)) for p in padded]
    token = _ACTIVE.set(None)
    try:
        y = fn(ext, *extra)
    finally:
        _ACTIVE.reset(token)
    return crop(y, t, x.shape[-2], ext.shape[-2])


def windowed(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, k: int,
             stride: int = 1, dilation: int = 1, padding: int | None = None) -> torch.Tensor:
    """``halo_apply`` for a windowed op (``window_halo``)."""
    return halo_apply(fn, x, *window_halo(k, stride, dilation, padding), stride)


def row_sum(*tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Partial sums over rows, summed over the spatial group inside a
    context (one all-reduce for all of them, in f32, or in int64 where all
    are integers, such as counts); as they are outside. Differentiable."""
    shard = _ACTIVE.get()
    if shard is None:
        return tensors
    dtype = (torch.float32 if any(t.is_floating_point() for t in tensors) else torch.int64)
    flat = shard.sum(torch.cat([t.to(dtype).reshape(-1) for t in tensors]))
    return tuple(p.view(t.shape).to(t.dtype)
                 for p, t in zip(flat.split([t.numel() for t in tensors]), tensors, strict=True))


def ranks() -> int:
    """The ranks a frame's rows are split over: the spatial group's size
    inside a context, 1 outside."""
    shard = _ACTIVE.get()
    return 1 if shard is None else shard.size


def mean(x: torch.Tensor, dim: tuple[int, ...], keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dim)`` over dims that include H (-2): over the whole frame
    inside a context (the f32 sum all-reduced, over the global count)."""
    if _ACTIVE.get() is None:
        return x.mean(dim=dim, keepdim=keepdim)
    (total,) = row_sum(x.sum(dim=dim, keepdim=keepdim, dtype=torch.float32))
    count = math.prod(x.shape[d] for d in dim) * ranks()
    return (total / count).to(x.dtype)


def check_rows(h: int, stride: int, what: str) -> None:
    """Inside a context: a shard's ``h`` rows must divide by ``stride``, the
    model's largest row stride (``ValueError`` naming ``what``)."""
    shard = _ACTIVE.get()
    if shard is not None and h % stride:
        raise ValueError(f"spatial sharding: a frame of {h * shard.size} rows over "
                         f"{shard.size} ranks gives shards of {h} rows, which do not divide "
                         f"by {what}'s row stride {stride}")


@contextlib.contextmanager
def spatial_sharding(mesh, model: nn.Module) -> Iterator[SpatialShard | None]:
    """Run ``model`` on this rank's part of ``mesh`` for the duration: the
    conv hooks registered on every ``nn.Conv2d`` of ``model`` (subclasses
    included), the functional ops and reductions active. Yields the
    ``SpatialShard`` (None where ``mesh`` is None or has one spatial
    rank). Every model ``build_model`` builds is served: the s2d stem and
    the folded convs read their halo through ``halo_apply``, and an int8
    model (``model.quantized``) on a mesh of more than one rank takes each
    call's activation scale over the world (``ops/quant.py``), the
    reference's whole call; a caller that splits a batch over data indices
    places this rank's samples in it (``quant.active().within``)."""
    scales = None
    if (getattr(model, "quantized", False) and mesh is not None and mesh.group is not None
            and mesh.data * mesh.spatial > 1):
        scales = quant.ScaleGroup(quant.process_group_max(mesh.group))
    with quant.sharing(scales):
        if mesh is None or mesh.spatial == 1:
            yield None
            return
        with SpatialShard(mesh.spatial_group, mesh.spatial,
                          mesh.spatial_index).serving(model) as shard:
            yield shard


def frame_rows(mesh, h: int) -> slice:
    """This rank's rows of a frame of ``h`` rows: all of them without a
    spatial axis. ``ValueError`` where h does not divide by the ranks."""
    if mesh is None or mesh.spatial == 1:
        return slice(0, h)
    if h % mesh.spatial:
        raise ValueError(f"a frame of {h} rows does not split over {mesh.spatial} ranks")
    per = h // mesh.spatial
    return slice(mesh.spatial_index * per, (mesh.spatial_index + 1) * per)
