"""The readers of the per-frame CUDA graph replay (``metrics/frame_graph_share.py``,
``metrics/frame_replay_ms.py``) on made-up span records: the share of
``serve.key``/``serve.cur`` spans that held a ``serve.replay`` and the
replays' stream ms a frame, each its hand-computed value; a replay inside
``serve.group`` counts for neither; None where no frame replayed (a
program that serves ``push_frame`` eagerly), without a trace, a card or
records."""

from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.devtrace import Trace

CARD = Trace(device=[("conv", 0.0, 1.0)], host=[("serve.key", 0.0, 1.0)], window_s=1.0,
             frames={})
NAMES = ("frame_graph_share", "frame_replay_ms")


def _reader(name):
    return spec.load_module(spec.HERE / "metrics" / f"{name}.py")


def _run(trace=CARD):
    return SimpleNamespace(trace=trace)


def _records(kinds, replayed, stream_s=0.002, group_replays=0):
    """A frame span of each kind in ``kinds``, the first ``replayed`` of
    them holding a ``serve.replay`` of ``stream_s``; then
    ``group_replays`` replays inside ``serve.group`` spans."""
    out, ids = [], iter(range(1, 1000))
    for i, kind in enumerate(kinds):
        frame = SimpleNamespace(name=f"serve.{kind}", id=next(ids), parent=None, stream_s=0.01)
        out.append(frame)
        if i < replayed:
            out.append(SimpleNamespace(name="serve.replay", id=next(ids), parent=frame.id,
                                       stream_s=stream_s))
    for _ in range(group_replays):
        group = SimpleNamespace(name="serve.group", id=next(ids), parent=None, stream_s=0.03)
        out += [group, SimpleNamespace(name="serve.replay", id=next(ids), parent=group.id,
                                       stream_s=0.025)]
    return out


@pytest.mark.parametrize("replayed, share", [(10, 100.0), (8, 80.0), (1, 10.0)])
def test_graph_share_of_the_frames(replayed, share, monkeypatch):
    reader = _reader("frame_graph_share")
    records = _records(["key", "cur", "cur", "cur", "cur"] * 2, replayed, group_replays=3)
    monkeypatch.setattr(reader, "program_span_records", lambda: records)
    assert reader.read(_run()) == pytest.approx(share)


def test_replay_ms_a_frame(monkeypatch):
    reader = _reader("frame_replay_ms")
    records = _records(["key", "cur", "cur", "cur"], 3, stream_s=0.004, group_replays=2)
    monkeypatch.setattr(reader, "program_span_records", lambda: records)
    assert reader.read(_run()) == pytest.approx(1e3 * 3 * 0.004 / 4)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_where_no_frame_replayed(name, monkeypatch):
    """The eager program: frames without replays, a replayed group aside."""
    reader = _reader(name)
    for records in (_records(["key", "cur"], 0, group_replays=2), [], None):
        monkeypatch.setattr(reader, "program_span_records", lambda records=records: records)
        assert reader.read(_run()) is None


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_a_trace_or_a_card(name, monkeypatch):
    reader = _reader(name)
    records = _records(["key", "cur"], 2)
    monkeypatch.setattr(reader, "program_span_records", lambda: records)
    assert reader.read(_run(None)) is None
    if name == "frame_graph_share":
        assert reader.read(_run(Trace([], CARD.host, 1.0, {}))) is None
    else:
        # no card: the spans have no stream time
        for r in records:
            r.stream_s = None
        assert reader.read(_run()) is None


@pytest.mark.parametrize("name", NAMES)
def test_the_program_keeps_span_records(name):
    assert isinstance(_reader(name).program_span_records(), list)
