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
``serve.group``. ``push_frame`` through stood-in graphs: three segmenters
interleaved over two keyframe groups each give eager ``push_frame``'s maps
from one key and one cur graph they share, and a kept map or carried
tensor is never overwritten; ``reset()`` keeps the graphs and
``load_state_dict`` starts them again; a failed capture serves eagerly;
the replay is ``serve.replay`` inside ``serve.key`` or ``serve.cur``."""

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


STREAMS = 3


@pytest.fixture(scope="module")
def streams(served):
    """Three streams of two keyframe groups (2K frames) each, and each
    one's eager ``push_frame`` maps (the CPU path makes no graph)."""
    _, model, propagate, clip = served
    frames = [torch.cat([c, c.flip(1)], dim=1) for c in (clip, clip.flip(2), clip.flip(3))]
    with torch.inference_mode():
        want = []
        for f in frames:
            seg = VideoSegmenter(model, K, propagate=propagate)
            want.append([seg.push_frame(f[:, i]) for i in range(2 * K)])
    return frames, want


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
    assert seg._steps.group.captures == 0 and seg._steps.group.capture_failures == 0
    assert not seg._steps.group._graphs


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
    assert stand_in.recorded == 1 and stand_in.replays == 2 and seg._steps.group.captures == 1
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


def _interleaved(segs, frames):
    """Stream s starts s frames after stream 0; frame by frame, each
    stream's maps, and (returned, a copy) of every map, prop and anchor."""
    got, kept = [[] for _ in segs], []
    n = frames[0].shape[1]
    for tick in range(n + len(segs) - 1):
        for s, seg in enumerate(segs):
            if 0 <= tick - s < n:
                got[s].append(seg.push_frame(frames[s][:, tick - s]))
                held = (got[s][-1], seg._prop, seg._anchor_small)
                kept.append((held, [t.clone() for t in held]))
    return got, kept


def test_interleaved_segmenters_share_frame_graphs(served, streams, monkeypatch):
    """Three segmenters of one model, interleaved over two keyframe groups
    each: eager ``push_frame``'s maps, from one key and one cur graph they
    share; no kept map, prop or anchor is overwritten by a later call."""
    _, model, propagate, _ = served
    frames, want = streams
    stand_in = graph_stand_in.use(monkeypatch)
    with torch.inference_mode():
        segs = [VideoSegmenter(model, K, propagate=propagate) for _ in range(STREAMS)]
        got, kept = _interleaved(segs, frames)
    steps = segs[0]._steps
    assert all(seg._steps is steps for seg in segs)
    for gs, ws in zip(got, want, strict=True):
        assert all(torch.equal(g, w) for g, w in zip(gs, ws, strict=True))
    for held, copies in kept:
        assert all(torch.equal(t, c) for t, c in zip(held, copies, strict=True))
    # 6 key and 24 cur calls: each step's first eager, the second captured
    assert stand_in.recorded == 2 and stand_in.replays == 6 - 1 + 24 - 1
    assert steps.key.captures == steps.cur.captures == 1
    assert steps.key.capture_failures == steps.cur.capture_failures == 0


def test_reset_keeps_the_graphs_and_load_state_dict_starts_again(served, streams,
                                                                   monkeypatch):
    _, model, propagate, _ = served
    frames, want = streams
    stand_in = graph_stand_in.use(monkeypatch)
    f = frames[0]
    state = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        with torch.inference_mode():
            seg = VideoSegmenter(model, K, propagate=propagate)
            pushed = [seg.push_frame(f[:, i]) for i in range(K + 1)]  # two keys
            seg.reset()
            pushed += [seg.push_frame(f[:, i]) for i in range(2)]
            assert stand_in.recorded == 2 and seg._steps.key.captures == 1
            for got, i in zip(pushed, [*range(K + 1), 0, 1], strict=True):
                assert torch.equal(got, want[0][i])
            # new weights, written in place: eager, then captured again
            changed = {k: v * 1.5 if v.is_floating_point() else v for k, v in state.items()}
            model.load_state_dict(changed)
            seg.reset()
            new = [seg.push_frame(f[:, K])]  # the graphs were dropped: eager
            assert stand_in.recorded == 2 and seg._steps.key.captures == 1
            seg.reset()
            new.append(seg.push_frame(f[:, K]))  # captured again
            assert stand_in.recorded == 3 and seg._steps.key.captures == 2
            eager = seg._steps.key.fn(f[:, K])["pred"]
            assert all(torch.equal(n, eager) for n in new)
            assert not torch.equal(eager, want[0][K])
    finally:
        model.load_state_dict(state)


def test_a_failed_frame_capture_serves_eagerly(served, streams, monkeypatch):
    _, model, propagate, _ = served
    frames, want = streams
    stand_in = graph_stand_in.use(monkeypatch, fail=True)
    with torch.inference_mode():
        seg = VideoSegmenter(model, K, propagate=propagate)
        with pytest.warns(RuntimeWarning, match="capture .* failed"):
            got = [seg.push_frame(frames[0][:, i]) for i in range(K + 2)]
    assert all(torch.equal(g, w) for g, w in zip(got, want[0], strict=False))
    steps = seg._steps
    assert stand_in.recorded == 2 and stand_in.replays == 0
    assert steps.key.capture_failures == steps.cur.capture_failures == 1
    assert steps.key.captures == steps.cur.captures == 0


def test_a_frame_replay_is_serve_replay_inside_serve_key_or_cur(served, streams, monkeypatch):
    _, model, propagate, _ = served
    frames, want = streams
    graph_stand_in.use(monkeypatch)
    with torch.inference_mode():
        seg = VideoSegmenter(model, K, propagate=propagate)
        for i in range(3):  # key (eager), cur (eager), cur (captured)
            seg.push_frame(frames[0][:, i])
        seg.reset()
        seg.push_frame(frames[0][:, 0])  # key (captured)
        with torch.profiler.profile():
            got = [seg.push_frame(frames[0][:, i]) for i in (1, 2)]  # cur, cur
            seg.reset()
            got.append(seg.push_frame(frames[0][:, 0]))  # key
    assert all(torch.equal(g, want[0][i]) for g, i in zip(got, (1, 2, 0), strict=True))
    records = span_records()
    by_id = {r.id: r for r in records}
    replays = [r for r in records if r.name == "serve.replay"]
    assert [by_id[r.parent].name for r in replays] == ["serve.cur", "serve.cur", "serve.key"]
    assert all(r.request == r.parent for r in replays)


def test_a_changed_scale_cascade_gets_steps_of_its_own(served):
    """The segmenters alive share their steps by model and settings, the
    model's scale cascade among them: one made after the cascade changed
    builds and checks its own predictors (incremental 'mean1' is refused)
    while an older one lives, and the old cascade's steps serve again."""
    _, model, _, _ = served
    seg = VideoSegmenter(model, K, propagate="incremental")
    cascade = model.scale_cascade
    try:
        model.scale_cascade = "product"
        assert VideoSegmenter(model, K, propagate="incremental")._steps is not seg._steps
        model.scale_cascade = "mean1"
        with pytest.raises(ValueError, match="scale_cascade='mean1'"):
            VideoSegmenter(model, K, propagate="incremental")
    finally:
        model.scale_cascade = cascade
    assert VideoSegmenter(model, K, propagate="incremental")._steps is seg._steps
