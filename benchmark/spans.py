"""What the per-layer metrics read from the program's spans
(``accel_tpu_torch/utils/profiler.py``): the ranges of the serving spans in
the traced segment's host events, the kernel-launch calls inside them, the
device's idle time inside them, and the spans' stream seconds by name.

Each function returns None where the spans it reads did not run (a program
without them) or the trace holds no device event (no card), so a reader
returns nothing there.
"""

from __future__ import annotations

import numpy as np

GROUP = ("serve.group",)
FRAME = ("serve.key", "serve.cur")
# the CUDA calls that launch device work (`cuda*` and `cu*`); a graph launch counts one
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")


def ranges(trace, names) -> list[tuple[float, float]]:
    """The (start, end) of the host events named ``names``, by start."""
    if trace is None:
        return []
    return sorted((s, e) for n, s, e in trace.host if n in names)


def launch_calls(trace) -> list[tuple[float, float]]:
    """The launch calls' (start, end), by start; a call that lies inside
    another (a `cu*` call under a `cuda*` call) is not counted again."""
    calls, end = [], -np.inf
    for s, e in sorted((s, e) for n, s, e in trace.host if n.startswith(LAUNCHES)):
        if e <= end:
            continue
        calls.append((s, e))
        end = e
    return calls


def launches_inside(trace, names):
    """(launch calls a range, host seconds in them a range) over the ranges
    of ``names``; None without such ranges."""
    spans = ranges(trace, names)
    if not spans or not trace.device:
        return None
    starts = np.array([s for s, _ in spans])
    ends = np.array([e for _, e in spans])
    count, host_s = 0, 0.0
    for s, e in launch_calls(trace):
        i = np.searchsorted(starts, s, side="right") - 1
        if i >= 0 and e <= ends[i]:
            count += 1
            host_s += e - s
    return count / len(spans), host_s / len(spans)


def idle_share(trace, names):
    """The share (%) of the ranges' time in which no device event ran; None
    without such ranges."""
    spans = ranges(trace, names)
    total = sum(e - s for s, e in spans)
    if not spans or total <= 0 or not trace.device:
        return None
    merged: list[list[float]] = []
    for s, e in sorted((s, e) for _, s, e in trace.device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    ms, me = np.array(merged).T
    busy = sum(float(np.clip(np.minimum(me, e) - np.maximum(ms, s), 0.0, None).sum())
               for s, e in spans)
    return 100.0 * (1.0 - busy / total)


def program_span_totals():
    """The program's ``span_totals()``, or None where it has none."""
    try:
        from accel_tpu_torch.utils.profiler import span_totals
    except ImportError:
        return None
    return span_totals()


def stage_ms(run, name: str):
    """Stream ms of the spans ``name`` a ``serve.group`` span of the traced
    segment; None where either did not run or has no stream time."""
    if run.trace is None:
        return None
    totals = program_span_totals()
    if not totals:
        return None
    groups = totals.get(GROUP[0], {}).get("count", 0)
    stage = totals.get(name)
    if not groups or not stage or stage["stream_s"] is None:
        return None
    return 1e3 * stage["stream_s"] / groups
