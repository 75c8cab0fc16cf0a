"""Profiling and debug helpers (counterpart of ``accel_tpu/utils/profiler.py``).

``profile_trace`` writes a ``torch.profiler`` trace (host and, where there
is a card, device events; viewable in TensorBoard's profiler or Perfetto)
where the JAX package writes a ``jax.profiler`` one; ``span`` and
``spanned`` mark the port's serving calls and model stages in such a
trace; ``debug_nans`` raises on the first op that makes a NaN, as
``jax_debug_nans`` does.

Spans. The port marks its layer boundaries with spans:

==================  =====================================================
``serve.group``     ``VideoSegmenter.push_group``
``serve.replay``    the CUDA graph a serving call replays
                    (``core/graphs.py``), inside ``serve.group``,
                    ``serve.key`` or ``serve.cur``; the stages run inside
                    the graph, where no span is live
``serve.key``       a ``push_frame`` that runs the key predictor
``serve.cur``       a ``push_frame`` that runs the cur predictor
``model.key``       ``AccelNet.ref_propagated``: the keyframe branch + fc6
``model.flow``      FlowNet-S to flow and scale field at feature
                    resolution (``downscale_for_flow``,
                    ``flow_stem_partials``, ``flow_pair``,
                    ``flow_pair_from_partials``, ``flow``)
``model.warp``      ``AccelNet.warp`` (#1 or #4) with its modulation
                    (``pipeline.propagate_step``) and the composition
                    warps (``pipeline._warp_field``)
``model.heads``     ``ref_scores_from_propagated`` and ``fuse``
``model.update``    ``AccelNet.update_scores``: the update branch
``model.tail``      the class maps from the logits (#2, ``upsample_argmax``)
==================  =====================================================

A span is live only while a ``torch.profiler`` records (inside
``profile_trace``, or any ``torch.profiler.profile``). Otherwise entering
and leaving it reads one flag and does nothing else: no profiler range,
no CUDA event, no allocation, no sync. It is inert as well while
``torch.compile`` or ``torch.export`` traces (an exported program holds no
span), while the current CUDA stream captures a graph, and inside a live
span of the same name (a stage is counted once).

A live span opens a ``torch.profiler.record_function`` range of its name,
on the trace's clock with the device's events, and keeps a
``SpanRecord``: name, id, parent id, request id (the outermost live span's
id: one ``push_group`` or ``push_frame`` call), host start and end, and on
CUDA two pooled events recorded on the current stream at entry and exit.
The events are resolved only when the records are read
(``span_records``, ``span_totals``), into the span's stream seconds: how
long the stream took to pass through the stage, idle time while its
launches came in included. The records sit in a buffer of
``SPAN_CAPACITY``; a span past it is counted in ``spans_dropped`` and not
kept. ``clear_spans`` empties the buffer.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# the flag torch.profiler sets while it records
_autograd_profiler = torch.autograd.profiler

SPAN_CAPACITY = 1 << 16


@contextlib.contextmanager
def profile_trace(logdir: str | None, enabled: bool = True):
    """Capture a ``torch.profiler`` trace of the scope into ``logdir``
    (``<host>_<pid>.<time>.pt.trace.json``). No-op when disabled or
    ``logdir`` is None. The port's spans are live inside it: their ranges
    are in the trace and their records in ``span_records``."""
    if not enabled or not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


class SpanRecord:
    """One live span: ``name``, ``id``, ``parent`` (the id of the live span
    it ran in, or None), ``request`` (the outermost live span's id),
    ``host_start``/``host_end`` (``time.perf_counter`` seconds) and
    ``stream_s`` (CUDA: seconds the current stream took between the
    span's entry and exit; None elsewhere)."""

    __slots__ = ("name", "id", "parent", "request", "host_start", "host_end", "_events",
                 "_stream_s")

    def __init__(self, name: str, span_id: int, parent: SpanRecord | None):
        self.name, self.id = name, span_id
        self.parent = None if parent is None else parent.id
        self.request = span_id if parent is None else parent.request
        self.host_start = self.host_end = 0.0
        self._events = None
        self._stream_s = None

    @property
    def host_s(self) -> float:
        return self.host_end - self.host_start

    @property
    def stream_s(self) -> float | None:
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._stream_s = start.elapsed_time(end) / 1e3
            _event_pool.extend(self._events)
            self._events = None
        return self._stream_s


class _Stack(threading.local):
    def __init__(self):
        self.live: list[SpanRecord] = []


_stack = _Stack()
_records: list[SpanRecord] = []
_event_pool: list = []
_ids = itertools.count(1)
_dropped = 0
_lock = threading.Lock()


def _event():
    return _event_pool.pop() if _event_pool else torch.cuda.Event(enable_timing=True)


class _Off:
    """The inert span."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Live:
    __slots__ = ("_record", "_range")

    def __init__(self, name: str):
        live = _stack.live
        self._record = SpanRecord(name, next(_ids), live[-1] if live else None)
        self._range = _autograd_profiler.record_function(name)

    def __enter__(self):
        record = self._record
        self._range.__enter__()
        if torch.cuda.is_initialized():
            record._events = (_event(), _event())
            record._events[0].record()
        _stack.live.append(record)
        record.host_start = time.perf_counter()
        return record

    def __exit__(self, *exc):
        global _dropped
        record = self._record
        record.host_end = time.perf_counter()
        if record._events is not None:
            record._events[1].record()
        _stack.live.pop()
        self._range.__exit__(*exc)
        with _lock:
            if len(_records) < SPAN_CAPACITY:
                _records.append(record)
                return False
            _dropped += 1
        if record._events is not None:
            _event_pool.extend(record._events)
            record._events = None
        return False


def _live_or_off(name: str):
    """A live span of ``name``, or the inert one where the call is traced,
    the stream captures, or a span of the same name is live."""
    if torch.compiler.is_compiling():
        return _OFF
    if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
        return _OFF
    if any(r.name == name for r in _stack.live):
        return _OFF
    return _Live(name)


def span(name: str):
    """A context manager marking the scope as the stage ``name`` (module
    docstring); one flag read while no profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _live_or_off(name)


def spanned(name: str):
    """Decorator: every call of the function runs in ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _live_or_off(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def span_records() -> list[SpanRecord]:
    """The kept records, oldest first, their stream seconds resolved
    (waiting for the events' streams)."""
    out = list(_records)
    for r in out:
        r.stream_s  # noqa: B018 - resolves and returns the events to the pool
    return out


def span_totals() -> dict[str, dict]:
    """By span name: {'count', 'host_s', 'stream_s'} summed over the kept
    records (``stream_s`` None where no record of the name has one)."""
    totals: dict[str, dict] = {}
    for r in span_records():
        t = totals.setdefault(r.name, dict(count=0, host_s=0.0, stream_s=None))
        t["count"] += 1
        t["host_s"] += r.host_s
        if r.stream_s is not None:
            t["stream_s"] = (t["stream_s"] or 0.0) + r.stream_s
    return totals


def spans_dropped() -> int:
    """Live spans not kept since the last ``clear_spans``: the buffer was
    full."""
    return _dropped


def clear_spans() -> None:
    """Empty the record buffer and the dropped count."""
    global _dropped
    span_records()
    with _lock:
        _records.clear()
        _dropped = 0


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
