"""A stand-in for the CUDA capture of ``accel_tpu_torch/core/graphs.py`` on
the CPU: ``use(monkeypatch)`` admits every call (``capturable``) and
replaces ``_record`` by one whose graph reruns the function on the static
input at each replay, writing into the output it returned at capture. That
output starts out holding 255 everywhere, so a call served from a graph
that was never replayed shows it. ``StandIn.recorded`` counts the
captures, ``StandIn.replays`` the replays."""

from __future__ import annotations

import torch

from accel_tpu_torch.core import graphs


class StandIn:
    recorded = 0
    replays = 0
    fail = False

    def __init__(self, fn, static_in: torch.Tensor):
        self.fn, self.static_in = fn, static_in

    def replay(self) -> None:
        StandIn.replays += 1
        self.out.copy_(self.fn(self.static_in))

    @classmethod
    def record(cls, fn, static_in: torch.Tensor):
        cls.recorded += 1
        if cls.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        graph = cls(fn, static_in)
        graph.out = torch.full_like(fn(static_in), 255)
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
