"""CUDA graphs of a serving call: one captured graph per input signature,
replayed in place of the call's launches.

A serving step of the port launches hundreds of kernels (a ``push_frame``)
to ~1,300-1,600 (a ``push_group``) one at a time from Python, and the card
waits on the host between them. ``CallGraphs`` serves a call
``fn(*xs) -> out`` (``out`` a tensor or a dict of tensors) by the
signature of ``xs``, each input's shape, dtype and device:

1. the first call of a signature runs ``fn`` eagerly. It is also the
   warm-up a capture needs: cuDNN and cuBLAS handles and workspaces, the
   kernels' attributes and the packed-weight caches are made outside the
   capture;
2. the second copies ``xs`` into static input buffers, captures ``fn`` on
   them as a ``torch.cuda.CUDAGraph`` with a memory pool of its own, and
   replays the graph;
3. every later call copies ``xs`` in, replays (the span ``serve.replay``,
   ``utils/profiler.py``) and returns a clone of each static output, so a
   result the caller keeps is never overwritten by the next call. An
   output that is one of the inputs itself (a direct cur step hands back
   the keyframe's tensor and anchor) is returned as the caller's own
   input, with no copy.

Only a call whose first input ``capturable`` admits takes this path; any
other call runs ``fn`` as it is. If a capture raises (a host sync inside
``fn``, say), the signature runs eagerly from then on and
``capture_failures`` counts it. The static buffers are the object's, not a
caller's: several callers may share one ``CallGraphs`` (the segmenters of
one model do) where they call it from one thread on one stream, so that
each call's copy in, replay and copy out are done before the next call
writes the buffers.

The graph reads the tensors it was captured on in place. Those of
``watched`` (a model's parameters and buffers) are stamped at every call
by storage and version: an in-place write (``load_state_dict``, ``copy_``
under ``torch.no_grad()``) or a move to other storage drops every graph,
and the next call of a signature starts again at step 1, since caches
derived from them (packed weights) are rebuilt only outside a capture. A
tensor replaced by another object, a write that bypasses the version
counter (through ``.data``) and a changed Python setting of the model are
not seen: make a new ``CallGraphs`` for them.
"""

from __future__ import annotations

import operator
import warnings
from collections.abc import Callable, Iterable

import torch

from accel_tpu_torch.ops import quant
from accel_tpu_torch.parallel import spatial
from accel_tpu_torch.utils.profiler import span

REPLAY = "serve.replay"

_WARM = "warm"    # the signature's first, eager call ran
_EAGER = "eager"  # its capture failed: eager for good

_VERSION = operator.attrgetter("_version")


def capturable(x) -> bool:
    """Whether a call on ``x`` may be captured and replayed: ``x`` is on a
    CUDA device, the current stream is not capturing already, no
    ``torch.compile`` or ``torch.export`` trace is running, and neither a
    spatial shard nor an int8 scale group is open (their collectives and
    gloo round trips run on the host inside the call)."""
    return (getattr(x, "is_cuda", False) and not torch.compiler.is_compiling()
            and not torch.cuda.is_current_stream_capturing()
            and spatial.active() is None and quant.active() is None)


def _record(fn: Callable, static_in: tuple) -> tuple[torch.cuda.CUDAGraph, object]:
    """Capture ``fn(*static_in)`` on a side stream into a new graph with its
    own memory pool; returns the graph and its output, which the first
    replay computes."""
    with torch.cuda.device(static_in[0].device):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(torch.cuda.Stream()):
            graph.capture_begin()
            try:
                out = fn(*static_in)
            finally:
                graph.capture_end()
    return graph, out


class _Graph:
    """A captured signature: the graph, its static inputs, and its outputs
    as (name, static tensor, index of the input it is or None); name None
    for a call that returns one tensor."""

    __slots__ = ("graph", "static_in", "outs")

    def __init__(self, graph, static_in: tuple, out):
        self.graph, self.static_in = graph, static_in
        items = out.items() if isinstance(out, dict) else ((None, out),)
        self.outs = tuple((name, t, next((i for i, s in enumerate(static_in) if t is s), None))
                          for name, t in items)

    def results(self, xs: tuple):
        """The replay's outputs for the call on ``xs``: clones, or the
        caller's own input where the output is that input."""
        got = {name: t.clone() if i is None else xs[i] for name, t, i in self.outs}
        return got if self.outs[0][0] is not None else got[None]


class CallGraphs:
    """``fn(*xs)`` served from one CUDA graph per signature of ``xs``
    (module docstring). ``watched``: the tensors ``fn`` reads besides
    ``xs`` whose in-place writes must be seen. ``captures`` and
    ``capture_failures`` count the captures made and those that raised."""

    def __init__(self, fn: Callable, watched: Iterable[torch.Tensor] = ()):
        self.fn = fn
        # an inference tensor has no version counter (and takes no write
        # outside inference mode)
        self._watched = tuple(t for t in watched if not t.is_inference())
        self._stamp: tuple | None = None
        self._graphs: dict[tuple, object] = {}
        self.captures = 0
        self.capture_failures = 0

    def stamp(self) -> tuple:
        """The watched tensors' storages and versions. Two maps take a third
        less host time than a tuple a tensor."""
        return (list(map(torch.Tensor.data_ptr, self._watched)),
                list(map(_VERSION, self._watched)))

    def __call__(self, *xs):
        if not capturable(xs[0]):
            return self.fn(*xs)
        # the stamp runs before the launch, while the card waits
        stamp = self.stamp()
        if stamp != self._stamp:
            self._graphs.clear()
            self._stamp = stamp
        key = tuple((tuple(x.shape), x.dtype, x.device) for x in xs)
        entry = self._graphs.get(key)
        if entry is None or entry is _EAGER:
            self._graphs.setdefault(key, _WARM)
            return self.fn(*xs)
        with torch.inference_mode():
            if entry is _WARM:
                entry = self._capture(key, xs)
                if entry is None:
                    return self.fn(*xs)
            else:
                for static, x in zip(entry.static_in, xs):
                    static.copy_(x)
            with span(REPLAY):
                entry.graph.replay()
            return entry.results(xs)

    def _capture(self, key: tuple, xs: tuple) -> _Graph | None:
        static_in = tuple(x.clone() for x in xs)
        try:
            graph, out = _record(self.fn, static_in)
        except RuntimeError as e:
            self._graphs[key] = _EAGER
            self.capture_failures += 1
            warnings.warn(f"CUDA graph capture of {key} failed, served eagerly: {e}",
                          RuntimeWarning, stacklevel=3)
            return None
        self.captures += 1
        entry = self._graphs[key] = _Graph(graph, static_in, out)
        return entry
