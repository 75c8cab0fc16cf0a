"""``accel_tpu_torch/core/graphs.py`` on the CPU.

``capturable`` admits a call on a CUDA tensor and refuses one on a CPU
tensor, while the current stream captures, while ``torch.compile`` or
``torch.export`` traces, under ``spatial_sharding`` and under an int8
scale group. ``CallGraphs``, with the CUDA capture replaced by a stand-in
(``graph_stand_in.py``): the first call of a signature runs eagerly, the
second captures and replays, later ones replay on their own inputs and
return copies the next call leaves alone; a failed capture serves the
signature eagerly for good and is counted; an in-place write to a watched
tensor starts the signature again from the eager call; a replay is the
span ``serve.replay``. The whole-model cases (``push_group`` on the CPU
makes no graph; through the stand-in it gives ``clip_predictions``' maps)
run in ``test_torch_spans.py``'s module-scoped models. A call of several
tensors that returns a dict (``push_frame``'s steps) takes the same path:
its signature is every input's, each output is a copy, and an output that
is one of the inputs comes back as the caller's own input.
"""

from types import SimpleNamespace

import graph_stand_in
import pytest
import torch
from torch import nn

from accel_tpu_torch.core import graphs
from accel_tpu_torch.core.graphs import REPLAY, CallGraphs, capturable
from accel_tpu_torch.ops import quant
from accel_tpu_torch.parallel import spatial
from accel_tpu_torch.utils.profiler import clear_spans, span, span_records


def _on_card():
    """A stand-in for a CUDA tensor: ``capturable`` reads only ``is_cuda``."""
    return SimpleNamespace(is_cuda=True)


@pytest.fixture
def not_capturing(monkeypatch):
    # this build of torch has no CUDA: its capture query raises
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)


def test_capturable_admits_a_cuda_call(not_capturing):
    assert capturable(_on_card())


def test_capturable_refuses_a_cpu_tensor():
    assert not capturable(torch.zeros(2))


@pytest.mark.parametrize("why", ["capturing", "compiling"])
def test_capturable_refuses_while_capturing_or_compiling(why, not_capturing, monkeypatch):
    if why == "capturing":
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    else:
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert not capturable(_on_card())


def test_capturable_refuses_under_spatial_sharding(not_capturing):
    mesh = SimpleNamespace(data=1, spatial=2, group=None, spatial_group=None,
                           spatial_index=0)
    with spatial.spatial_sharding(mesh, nn.Conv2d(3, 3, 3)) as shard:
        assert shard is not None and not capturable(_on_card())
    assert capturable(_on_card())


def test_capturable_refuses_under_an_int8_scale_group(not_capturing):
    with quant.sharing(quant.ScaleGroup(lambda t: t)):
        assert not capturable(_on_card())
    assert capturable(_on_card())


class _Counted:
    """``x * w`` as uint8, counting its calls."""

    def __init__(self):
        self.w = torch.full((1,), 2.0)
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        return (x * self.w).to(torch.uint8)


def _frames(seed, shape=(2, 3)):
    return torch.randint(0, 50, shape, generator=torch.Generator().manual_seed(seed)).float()


def test_first_call_eager_second_captures_later_replay(monkeypatch):
    stand_in = graph_stand_in.use(monkeypatch)
    fn = _Counted()
    call = CallGraphs(fn, watched=[fn.w])
    x1, x2, x3 = _frames(1), _frames(2), _frames(3)
    out1 = call(x1)
    assert fn.calls == 1 and stand_in.recorded == 0 and stand_in.replays == 0
    out2 = call(x2)
    assert stand_in.recorded == 1 and stand_in.replays == 1 and call.captures == 1
    out3 = call(x3)
    assert stand_in.recorded == 1 and stand_in.replays == 2
    # each call its own frames' maps, each a copy the next call leaves alone
    for x, out in ((x1, out1), (x2, out2), (x3, out3)):
        assert torch.equal(out, (x * 2).to(torch.uint8))
    assert out2.data_ptr() != out3.data_ptr()
    # another signature starts with its own eager call
    replays = stand_in.replays
    x4 = _frames(4, (3, 3))
    assert torch.equal(call(x4), (x4 * 2).to(torch.uint8))
    assert stand_in.recorded == 1 and stand_in.replays == replays
    assert call.capture_failures == 0


def test_failed_capture_serves_eagerly_for_good(monkeypatch):
    stand_in = graph_stand_in.use(monkeypatch, fail=True)
    fn = _Counted()
    call = CallGraphs(fn)
    xs = [_frames(s) for s in range(4)]
    with pytest.warns(RuntimeWarning, match="capture .* failed"):
        outs = [call(x) for x in xs]
    for x, out in zip(xs, outs, strict=True):
        assert torch.equal(out, (x * 2).to(torch.uint8))
    assert stand_in.recorded == 1 and stand_in.replays == 0
    assert call.capture_failures == 1 and call.captures == 0


def test_in_place_write_to_a_watched_tensor_starts_again(monkeypatch):
    stand_in = graph_stand_in.use(monkeypatch)
    fn = _Counted()
    call = CallGraphs(fn, watched=[fn.w])
    for s in range(3):
        call(_frames(s))
    assert stand_in.recorded == 1 and stand_in.replays == 2
    with torch.no_grad():
        fn.w.copy_(torch.full((1,), 3.0))
    x = _frames(5)
    calls = fn.calls
    assert torch.equal(call(x), (x * 3).to(torch.uint8))
    assert fn.calls == calls + 1 and stand_in.recorded == 1  # eager again
    assert torch.equal(call(x), (x * 3).to(torch.uint8))
    assert stand_in.recorded == 2 and call.captures == 2


def test_a_replay_is_the_span_serve_replay(monkeypatch):
    graph_stand_in.use(monkeypatch)
    call = CallGraphs(_Counted())
    clear_spans()
    try:
        with torch.profiler.profile():
            for s in range(3):
                with span("serve.group"):
                    call(_frames(s))
        records = span_records()
    finally:
        clear_spans()
    groups = [r for r in records if r.name == "serve.group"]
    replays = [r for r in records if r.name == REPLAY]
    assert len(groups) == 3 and len(replays) == 2
    assert {r.parent for r in replays} == {g.id for g in groups[1:]}


def _step(frame, anchor, prop):
    """A cur step's shape: a new map and anchor, the carried tensor as it is."""
    return {"pred": (frame + prop).to(torch.uint8), "anchor_small": frame * 2, "prop": prop}


def test_a_tuple_in_and_a_dict_out(monkeypatch):
    stand_in = graph_stand_in.use(monkeypatch)
    call = CallGraphs(_step)
    calls = [tuple(_frames(3 * s + i) for i in range(3)) for s in range(4)]
    outs = [call(*xs) for xs in calls[:3]]
    kept = {name: t.clone() for name, t in outs[1].items()}
    assert stand_in.recorded == 1 and stand_in.replays == 2 and call.captures == 1
    for xs, out in zip(calls, outs, strict=False):
        want = _step(*xs)
        assert out.keys() == want.keys()
        for name in want:
            assert torch.equal(out[name], want[name])
        # the carried tensor is the caller's own, the others copies
        assert out["prop"] is xs[2]
    assert all(out["pred"].data_ptr() != outs[2]["pred"].data_ptr() for out in outs[:2])
    call(*calls[3])
    for name, t in kept.items():
        assert torch.equal(outs[1][name], t)
    # any input's shape is part of the signature: a new one starts eagerly
    replays = stand_in.replays
    frame, anchor, _ = calls[3]
    prop = _frames(99, (2, 1))
    out = call(frame, anchor, prop)
    assert torch.equal(out["pred"], (frame + prop).to(torch.uint8))
    assert stand_in.replays == replays and stand_in.recorded == 1


def test_graphs_module_runs_no_capture_on_the_cpu():
    fn = _Counted()
    call = CallGraphs(fn, watched=[fn.w])
    for s in range(3):
        x = _frames(s)
        assert torch.equal(call(x), fn(x))
    assert call.captures == 0 and call.capture_failures == 0 and not graphs.capturable(x)
