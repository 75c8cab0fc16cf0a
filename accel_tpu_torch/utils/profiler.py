"""Profiling and debug helpers (counterpart of ``accel_tpu/utils/profiler.py``).

``profile_trace`` writes a ``torch.profiler`` trace (host and, where there
is a card, device events; viewable in TensorBoard's profiler or Perfetto)
where the JAX package writes a ``jax.profiler`` one; ``StageTimer`` times
stages on the host clock after a device synchronize; ``debug_nans`` raises
on the first op that makes a NaN, as ``jax_debug_nans`` does.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@contextlib.contextmanager
def profile_trace(logdir: str | None, enabled: bool = True):
    """Capture a ``torch.profiler`` trace of the scope into ``logdir``
    (``<host>_<pid>.<time>.pt.trace.json``). No-op when disabled or
    ``logdir`` is None."""
    if not enabled or not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


class StageTimer:
    """Wall-clock stage timing with a device sync (pred_eval's t_data/t_net
    split, generalized)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time the scope under ``name``. ``sync``: a tensor or a nested
        structure of them; the card of each CUDA tensor in it is
        synchronized before the clock is read, so the stage's queued device
        work is inside its time."""
        t0 = time.perf_counter()
        yield
        for device in {t.device for t in tree_leaves(sync)
                       if isinstance(t, torch.Tensor) and t.is_cuda}:
            torch.cuda.synchronize(device)
        self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        return "  ".join(f"{k}={self.totals[k] / max(self.counts[k], 1) * 1000:.2f}ms"
                         for k in self.totals)


class _NanCheck(TorchDispatchMode):
    """Raise ``FloatingPointError`` naming the op whose floating output
    holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"debug_nans: {func} produced a NaN")
        return out


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """Within the scope, raise ``FloatingPointError`` on the first op whose
    floating output holds a NaN (``jax_debug_nans``; debug runs only: every
    op's output is read back to the host). Leaving the scope removes the
    check; ``enabled=False`` adds none."""
    if not enabled:
        yield
        return
    with _NanCheck():
        yield
