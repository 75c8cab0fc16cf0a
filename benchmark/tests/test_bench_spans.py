"""The readers of the program's spans (``benchmark/spans.py`` and the
eleven ``metrics/*`` that use it) on made-up traces and span totals: each
gives its hand-computed value, and None where its spans did not run."""

from types import SimpleNamespace

import pytest

from benchmark import spans, spec
from benchmark.devtrace import Trace

STAGES = ("key", "flow", "warp", "heads", "update", "tail")
GROUP_READERS = ("launches_per_group", "group_launch_host_ms", "group_call_idle_share")
FRAME_READERS = ("launches_per_frame", "frame_call_idle_share")


def _reader(name):
    return spec.load_module(spec.HERE / "metrics" / f"{name}.py")


def _run(trace):
    return SimpleNamespace(trace=trace)


# two groups, [0, 1) and [2, 3) s: launches (and one `cu*` call nested in
# a runtime call, one launch outside any group); the device busy 0.2-0.6
# and 0.8-1.4 (overlapping events count once) and 2.0-2.5
GROUPS = Trace(
    device=[("conv", 0.2, 0.5), ("conv", 0.4, 0.6), ("copy", 0.8, 1.4), ("conv", 2.0, 2.5)],
    host=[("serve.group", 0.0, 1.0), ("serve.group", 2.0, 3.0),
          ("aten::conv", 0.1, 0.3),
          ("cudaLaunchKernel", 0.10, 0.11), ("cudaLaunchKernelExC", 0.20, 0.23),
          ("cuLaunchKernel", 0.21, 0.22),
          ("cudaGraphLaunch", 2.10, 2.15), ("cuLaunchKernelEx", 2.50, 2.51),
          ("cudaLaunchKernel", 1.50, 1.52), ("cudaMemcpyAsync", 0.7, 0.8)],
    window_s=3.0, frames={})
# three frames: a key [0, 0.4), two cur [1, 1.2) and [2, 2.2)
FRAMES = Trace(
    device=[("k", 0.1, 0.3), ("c", 1.15, 1.25), ("c", 2.0, 2.2)],
    host=[("serve.key", 0.0, 0.4), ("serve.cur", 1.0, 1.2), ("serve.cur", 2.0, 2.2),
          ("cudaLaunchKernel", 0.05, 0.06), ("cudaLaunchKernel", 0.07, 0.08),
          ("cudaLaunchKernel", 1.05, 1.06), ("cudaLaunchKernel", 1.5, 1.6)],
    window_s=2.5, frames={})
NONE = Trace(device=[("conv", 0.0, 1.0)], host=[("cudaLaunchKernel", 0.1, 0.2)],
             window_s=1.0, frames={})


def test_launches_a_group_and_their_host_ms():
    # group 1: 0.10-0.11 and 0.20-0.23 (its nested `cu*` call not again);
    # group 2: the graph launch and 2.50-2.51; 1.50 lies outside both
    assert _reader("launches_per_group").read(_run(GROUPS)) == pytest.approx(2.0)
    host_ms = 1e3 * (0.01 + 0.03 + 0.05 + 0.01) / 2
    assert _reader("group_launch_host_ms").read(_run(GROUPS)) == pytest.approx(host_ms)


def test_idle_share_inside_the_group_calls():
    # busy inside: 0.4 + 0.2 of [0, 1), 0.5 of [2, 3)
    want = 100.0 * (1.0 - (0.4 + 0.2 + 0.5) / 2.0)
    assert _reader("group_call_idle_share").read(_run(GROUPS)) == pytest.approx(want)


def test_frame_readers():
    assert _reader("launches_per_frame").read(_run(FRAMES)) == pytest.approx(3 / 3)
    # busy inside: 0.2 of the key's 0.4, 0.05 of [1, 1.2), 0.2 of [2, 2.2)
    want = 100.0 * (1.0 - (0.2 + 0.05 + 0.2) / 0.8)
    assert _reader("frame_call_idle_share").read(_run(FRAMES)) == pytest.approx(want)


@pytest.mark.parametrize("name", GROUP_READERS + FRAME_READERS)
def test_trace_readers_read_nothing_without_their_spans(name):
    assert _reader(name).read(_run(NONE)) is None
    # a run with no card: no device event
    no_card = GROUPS if name in GROUP_READERS else FRAMES
    assert _reader(name).read(_run(Trace([], no_card.host, 3.0, {}))) is None
    assert _reader(name).read(_run(None)) is None
    other = FRAMES if name in GROUP_READERS else GROUPS
    assert _reader(name).read(_run(other)) is None


def _totals(**stream_s):
    out = {"serve.group": dict(count=4, host_s=1.0, stream_s=0.2)}
    for stage, s in stream_s.items():
        out[f"model.{stage}"] = dict(count=3, host_s=0.5, stream_s=s)
    return out


@pytest.mark.parametrize("stage", STAGES)
def test_stage_ms_a_group(stage, monkeypatch):
    monkeypatch.setattr(spans, "program_span_totals", lambda: _totals(**{stage: 0.06}))
    assert _reader(f"{stage}_stage_ms").read(_run(GROUPS)) == pytest.approx(1e3 * 0.06 / 4)


@pytest.mark.parametrize("stage", STAGES)
def test_stage_ms_reads_nothing_without_its_spans(stage, monkeypatch):
    reader = _reader(f"{stage}_stage_ms")
    for totals in (None, {}, _totals(), _totals(**{stage: None}),
                   {f"model.{stage}": dict(count=3, host_s=0.5, stream_s=0.06)}):
        monkeypatch.setattr(spans, "program_span_totals", lambda totals=totals: totals)
        assert reader.read(_run(GROUPS)) is None
    monkeypatch.setattr(spans, "program_span_totals", lambda: _totals(**{stage: 0.06}))
    assert reader.read(_run(None)) is None


def test_program_span_totals_is_the_programs():
    from accel_tpu_torch.utils import profiler

    profiler.clear_spans()
    assert spans.program_span_totals() == {}
