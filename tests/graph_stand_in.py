"""A stand-in for the CUDA capture of ``accel_tpu_torch/core/graphs.py`` on
the CPU: ``use(monkeypatch)`` admits every call (``capturable``) and
replaces ``_record`` by one whose graph reruns the function on the static
inputs at each replay, writing into the outputs it returned at capture.
Those start out holding 255 everywhere, so a call served from a graph
that was never replayed shows it; an output that is one of the static
inputs stays that input, as a captured graph's does. ``StandIn.recorded``
counts the captures, ``StandIn.replays`` the replays."""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_leaves, tree_map

from accel_tpu_torch.core import graphs


class StandIn:
    recorded = 0
    replays = 0
    fail = False

    def __init__(self, fn, static_in: tuple):
        self.fn, self.static_in = fn, static_in

    def replay(self) -> None:
        StandIn.replays += 1
        for out, new in zip(tree_leaves(self.out), tree_leaves(self.fn(*self.static_in)),
                            strict=True):
            if out is not new:
                out.copy_(new)

    @classmethod
    def record(cls, fn, static_in: tuple):
        cls.recorded += 1
        if cls.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        graph = cls(fn, static_in)
        graph.out = tree_map(lambda t: t if any(t is s for s in static_in)
                             else torch.full_like(t, 255), fn(*static_in))
        return graph, graph.out


def use(monkeypatch, fail: bool = False) -> type[StandIn]:
    """Serve every ``CallGraphs`` call through ``StandIn`` graphs for the
    test; ``fail``: every capture raises."""
    monkeypatch.setattr(StandIn, "recorded", 0)
    monkeypatch.setattr(StandIn, "replays", 0)
    monkeypatch.setattr(StandIn, "fail", fail)
    monkeypatch.setattr(graphs, "capturable", lambda x: True)
    monkeypatch.setattr(graphs, "_record", StandIn.record)
    return StandIn
