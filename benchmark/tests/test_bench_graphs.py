"""The readers of the CUDA graph replay span (``metrics/group_graph_share.py``,
``metrics/group_replay_ms.py``) on made-up span totals: the share of
``serve.group`` spans that held a ``serve.replay`` and the replay's stream
ms a group, each its hand-computed value, and None where no group replayed
in a program without ``core/graphs.py``."""

from types import SimpleNamespace

import pytest

from benchmark import spans, spec
from benchmark.devtrace import Trace

# a traced segment with a device event: a run on a card
CARD = Trace(device=[("conv", 0.0, 1.0)], host=[("serve.group", 0.0, 1.0)], window_s=1.0,
             frames={})


def _reader(name):
    return spec.load_module(spec.HERE / "metrics" / f"{name}.py")


def _run(trace=CARD):
    return SimpleNamespace(trace=trace)


def _totals(groups, replays, stream_s=0.1):
    out = {"serve.group": dict(count=groups, host_s=1.0, stream_s=0.2)}
    if replays:
        out["serve.replay"] = dict(count=replays, host_s=0.01, stream_s=stream_s)
    return out


@pytest.mark.parametrize("replays, share", [(16, 100.0), (8, 50.0), (0, 0.0)])
def test_graph_share_of_the_groups(replays, share, monkeypatch):
    monkeypatch.setattr(spans, "program_span_totals", lambda: _totals(16, replays))
    assert _reader("group_graph_share").read(_run()) == pytest.approx(share)


def test_replay_ms_a_group(monkeypatch):
    monkeypatch.setattr(spans, "program_span_totals", lambda: _totals(16, 8, stream_s=0.2))
    assert _reader("group_replay_ms").read(_run()) == pytest.approx(1e3 * 0.2 / 16)


@pytest.mark.parametrize("name", ["group_graph_share", "group_replay_ms"])
def test_nothing_where_no_group_replayed_in_a_program_without_graphs(name, monkeypatch):
    reader = _reader(name)
    monkeypatch.setattr(spans, "program_span_totals", lambda: _totals(16, 0))
    if name == "group_graph_share":
        monkeypatch.setattr(reader, "program_replays", lambda: False)
    assert reader.read(_run()) is None


@pytest.mark.parametrize("name", ["group_graph_share", "group_replay_ms"])
def test_nothing_without_a_trace_a_card_or_groups(name, monkeypatch):
    reader = _reader(name)
    for totals in (None, {}, _totals(0, 0)):
        monkeypatch.setattr(spans, "program_span_totals", lambda totals=totals: totals)
        assert reader.read(_run()) is None
    monkeypatch.setattr(spans, "program_span_totals", lambda: _totals(16, 16))
    assert reader.read(_run(None)) is None
    if name == "group_graph_share":
        # a run with no card: no device event, no stream time
        assert reader.read(_run(Trace([], CARD.host, 1.0, {}))) is None


def test_the_program_serves_groups_from_graphs():
    assert _reader("group_graph_share").program_replays()
