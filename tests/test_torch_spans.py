"""The port's spans (``utils/profiler.py``: ``span``, ``spanned``) on the
serving calls and the model's stages, on tiny Accel and DFF models (R18,
head 32, 128x128, f32, k=5) on the CPU.

With no profiler recording a span opens no profiler range, creates no
event and keeps no record; under ``torch.profiler.profile()`` every
serving call yields its spans, once a stage where the stage runs once, all
under the call's request id, and the class maps are the same bits as with
tracing off. Spans stay inert while ``torch.export`` traces, while a
stream captures and inside a span of their own name; CUDA events are
pooled and resolved only when the records are read; the record buffer is
bounded and counts what it drops. ``push_group`` on the CPU captures no
CUDA graph (``core/graphs.py``) and gives ``clip_predictions``' maps; with
the capture stood in, its replay is the span ``serve.replay`` inside
``serve.group``."""

import collections
import json
import os

import graph_stand_in
import pytest
import torch

from accel_tpu_torch.core.export import export_serving
from accel_tpu_torch.core.pipeline import clip_predictions
from accel_tpu_torch.core.serving import VideoSegmenter
from accel_tpu_torch.models.accel import build_model
from accel_tpu_torch.utils import profiler
from accel_tpu_torch.utils.profiler import (clear_spans, profile_trace, span, span_records,
                                            span_totals, spanned, spans_dropped)

torch.set_num_threads(2)
HW, K = 128, 5
NETS = {
    "accel": (dict(name="accel", ref_depth=18, update_depth=18, head_channels=32,
                   dtype="float32"), "incremental"),
    "dff": (dict(name="dff", ref_depth=18, head_channels=32, flow_width_mult=0.5,
                 warp_gather="onehot", scale_field_norm="mean1", dtype="float32"), "direct"),
}
# the stage spans of one push_group at k=5: incremental Accel warps four
# times in a chain, direct DFF once at batch 4
GROUP_STAGES = {
    "accel": {"model.key": 1, "model.flow": 2, "model.warp": 4, "model.heads": 3,
              "model.update": 1, "model.tail": 1},
    "dff": {"model.key": 1, "model.flow": 2, "model.warp": 1, "model.heads": 2,
            "model.tail": 1},
}


@pytest.fixture(scope="module", params=list(NETS))
def served(request):
    net, propagate = NETS[request.param]
    model = build_model(net, device="cpu", generator=torch.Generator().manual_seed(3))
    clip = torch.randn((1, K, HW, HW, 3), generator=torch.Generator().manual_seed(4)) * 0.5
    return request.param, model, propagate, clip


@pytest.fixture(autouse=True)
def _empty_buffer():
    clear_spans()
    yield
    clear_spans()


def _serve(model, propagate, clip):
    """One push_group, then a keyframe and a non-key push_frame."""
    with torch.inference_mode():
        seg = VideoSegmenter(model, K, propagate=propagate)
        group = seg.push_group(clip)
        frames = [seg.push_frame(clip[:, i]) for i in range(2)]
    return group, frames


def _by_request(records):
    out = collections.defaultdict(list)
    for r in records:
        out[r.request].append(r)
    return out


def _root(records):
    (root,) = [r for r in records if r.parent is None]
    return root


def test_spans_with_no_profiler_are_free(served, monkeypatch):
    """No profiler range, no CUDA event, no live span and no record."""
    _, model, propagate, clip = served
    calls = []

    def spy(what):
        def call(*args, **kwargs):
            calls.append(what)
            raise AssertionError(f"{what} called with no profiler recording")
        return call

    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy("record_function"))
    monkeypatch.setattr(torch.cuda, "Event", spy("Event"))
    monkeypatch.setattr(profiler, "_live_or_off", spy("_live_or_off"))
    monkeypatch.setattr(profiler, "_Live", spy("_Live"))
    assert not torch.autograd.profiler._is_profiler_enabled
    _serve(model, propagate, clip)
    assert calls == [] and span_records() == [] and spans_dropped() == 0


def test_push_group_yields_each_stage_once_under_one_request(served):
    family, model, propagate, clip = served
    with torch.inference_mode():
        seg = VideoSegmenter(model, K, propagate=propagate)
        with torch.profiler.profile() as prof:
            seg.push_group(clip)
    records = span_records()
    (request,) = _by_request(records)
    root = _root(records)
    assert root.name == "serve.group" and root.id == request
    stages = collections.Counter(r.name for r in records if r is not root)
    assert stages == GROUP_STAGES[family]
    by_id = {r.id: r for r in records}
    for r in records:
        assert r.request == request
        if r is not root:
            assert r.parent == root.id
        # no stage inside a span of its own name
        parent = by_id.get(r.parent)
        while parent is not None:
            assert parent.name != r.name
            parent = by_id.get(parent.parent)
        assert root.host_start <= r.host_start <= r.host_end <= root.host_end
        assert r.stream_s is None  # no CUDA stream here
    # the profiler's trace holds one range a span, by name
    ranges = collections.Counter(e.name for e in prof.events() if e.name in
                                 set(GROUP_STAGES[family]) | {"serve.group"})
    assert ranges == collections.Counter(r.name for r in records)
    totals = span_totals()
    assert {n: t["count"] for n, t in totals.items()} == dict(stages, **{"serve.group": 1})
    assert totals["serve.group"]["host_s"] >= totals["model.key"]["host_s"] > 0


def test_push_frame_yields_key_and_cur(served):
    family, model, propagate, clip = served
    with torch.inference_mode():
        seg = VideoSegmenter(model, K, propagate=propagate)
        with torch.profiler.profile():
            seg.push_frame(clip[:, 0])
            seg.push_frame(clip[:, 1])
    requests = _by_request(span_records())
    assert len(requests) == 2
    roots = [_root(rs) for rs in requests.values()]
    assert [r.name for r in sorted(roots, key=lambda r: r.id)] == ["serve.key", "serve.cur"]
    for rs in requests.values():
        root = _root(rs)
        names = collections.Counter(r.name for r in rs if r is not root)
        assert all(r.parent == root.id for r in rs if r is not root)
        assert names["model.tail"] == 1
        if root.name == "serve.key":
            assert names["model.key"] == 1 and names["model.warp"] == 0
        else:
            assert names["model.key"] == 0 and names["model.warp"] == 1
            assert names["model.flow"] >= 1
        assert names["model.update"] == (family == "accel")


def test_class_maps_bit_equal_with_tracing_on_and_off(served):
    _, model, propagate, clip = served
    off_group, off_frames = _serve(model, propagate, clip)
    assert span_records() == []
    with torch.profiler.profile():
        on_group, on_frames = _serve(model, propagate, clip)
    assert span_records()
    assert torch.equal(on_group, off_group)
    for on, off in zip(on_frames, off_frames, strict=True):
        assert torch.equal(on, off)


def test_push_group_on_the_cpu_makes_no_graph(served):
    """The CPU path is the eager call: ``clip_predictions``' maps, no capture."""
    _, model, propagate, clip = served
    with torch.inference_mode():
        seg = VideoSegmenter(model, K, propagate=propagate)
        outs = [seg.push_group(clip) for _ in range(3)]
        want = clip_predictions(model, clip, K, propagate)
    for out in outs:
        assert torch.equal(out, want)
    assert seg._group.captures == 0 and seg._group.capture_failures == 0
    assert not seg._group._graphs


def test_push_group_through_a_stand_in_graph(served, monkeypatch):
    """With the capture stood in (``graph_stand_in.py``): the first group
    eager, the second captured, the third replayed, each on its own frames,
    each ``clip_predictions``' maps; the replay inside ``serve.group``."""
    _, model, propagate, clip = served
    stand_in = graph_stand_in.use(monkeypatch)
    clips = [clip, clip.flip(2), clip.flip(3)]
    with torch.inference_mode():
        seg = VideoSegmenter(model, K, propagate=propagate)
        outs = [seg.push_group(clips[0]), seg.push_group(clips[1])]
        with torch.profiler.profile():
            outs.append(seg.push_group(clips[2]))
        for c, out in zip(clips, outs, strict=True):
            assert torch.equal(out, clip_predictions(model, c, K, propagate))
    assert stand_in.recorded == 1 and stand_in.replays == 2 and seg._group.captures == 1
    records = span_records()
    root = _root(records)
    (replay,) = [r for r in records if r.name == "serve.replay"]
    assert root.name == "serve.group" and replay.parent == root.id


def test_exported_program_holds_no_span(served):
    """``torch.export`` traces through the spans under a profiler: the
    program holds no profiler op and no span is kept."""
    _, model, propagate, _ = served
    with torch.profiler.profile():
        blob = export_serving(model, None, (HW, HW), K, propagate, batch=1)
    assert span_records() == []
    from accel_tpu_torch.core.export import load_serving

    graph = load_serving(blob).exported.graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]


def test_inert_while_compiling_capturing_or_nested(monkeypatch):
    with torch.profiler.profile():
        with span("outer"):
            with span("outer"):  # the same name: inert
                with span("inner") as inner:
                    assert inner is not None
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        with span("compiled") as s:
            assert s is None
        monkeypatch.undo()
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        with span("captured") as s:
            assert s is None
    records = span_records()
    assert [r.name for r in records] == ["inner", "outer"]
    inner, outer = records
    assert inner.parent == outer.id and inner.request == outer.request == outer.id


class _FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = _FakeEvent.clock
        _FakeEvent.clock += 2.5

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def test_cuda_events_pooled_and_resolved_when_read(monkeypatch):
    """On CUDA a live span records two events on the current stream; they
    are resolved (ms -> s) only when the records are read, then reused."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(profiler, "_event_pool", [])
    _FakeEvent.made, _FakeEvent.clock = 0, 0.0

    @spanned("stage")
    def stage():
        return 7

    with torch.profiler.profile():
        with span("call"):
            assert stage() == 7
    assert _FakeEvent.made == 4
    assert all(r._events is not None for r in profiler._records)  # not resolved yet
    totals = span_totals()
    # clock: call enters 0, stage 2.5 .. 5.0, call exits 7.5 (ms)
    assert totals["stage"]["stream_s"] == pytest.approx(2.5e-3)
    assert totals["call"]["stream_s"] == pytest.approx(7.5e-3)
    assert len(profiler._event_pool) == 4
    clear_spans()
    with torch.profiler.profile():
        stage()
    assert _FakeEvent.made == 4 and len(profiler._event_pool) == 2


def test_buffer_is_bounded_and_drops_are_counted(monkeypatch):
    monkeypatch.setattr(profiler, "SPAN_CAPACITY", 3)
    with torch.profiler.profile() as prof:
        for i in range(5):
            with span(f"s{i}"):
                pass
    assert [r.name for r in span_records()] == ["s0", "s1", "s2"]
    assert spans_dropped() == 2
    # a dropped span still opens its range
    assert {e.name for e in prof.events()} >= {f"s{i}" for i in range(5)}
    clear_spans()
    assert span_records() == [] and spans_dropped() == 0


def test_profile_trace_holds_the_spans(tmp_path):
    """``profile_trace`` is how an operator records the spans: their
    ranges are in the written trace."""
    with profile_trace(str(tmp_path)):
        with span("serve.group"):
            torch.ones(3).sum()
    (trace,) = os.listdir(tmp_path)
    events = json.loads((tmp_path / trace).read_text())["traceEvents"]
    assert any(e.get("name") == "serve.group" for e in events)
    assert [r.name for r in span_records()] == ["serve.group"]
