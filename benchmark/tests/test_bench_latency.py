"""The live cells' latency percentiles: over every frame due in the
window, from its due time, failed frames included."""

from types import SimpleNamespace

from benchmark import spec


def _run(records, window_s=1.0, drain_s=60.0):
    return SimpleNamespace(records=records, window_s=window_s,
                           traffic=dict(drain_s=drain_s))


def _steady(n=100, service=0.005, period=0.01):
    return [dict(due=i * period, done=i * period + service, start=i * period, kind="cur",
                 failed=False) for i in range(n)]


def test_percentiles_count_every_due_frame_from_its_due_time():
    live = spec.load_module(spec.HERE / "traffic" / "live_streams.py")
    e2e = live.end_to_end(_run(_steady()))
    assert abs(e2e["latency_p50_ms"] - 5.0) < 1e-9
    assert abs(e2e["latency_p95_ms"] - 5.0) < 1e-9


def test_a_stalled_frame_moves_the_p95():
    live = spec.load_module(spec.HERE / "traffic" / "live_streams.py")
    records = _steady()
    # one frame stalls 200 ms; the 9 due behind it wait for it
    for r in records[50:60]:
        r["done"] = records[50]["due"] + 0.2
    before = live.end_to_end(_run(_steady()))
    after = live.end_to_end(_run(records))
    assert after["latency_p95_ms"] > 50.0 > before["latency_p95_ms"]
    assert after["latency_p50_ms"] == before["latency_p50_ms"]


def test_a_failed_frame_counts_to_the_end_of_the_drain():
    live = spec.load_module(spec.HERE / "traffic" / "live_streams.py")
    records = _steady(20)
    records[-1] = dict(due=records[-1]["due"], stream=0, failed=True)
    run = _run(records, window_s=0.2, drain_s=1.0)
    assert live.counts(run) == (20, 1)
    assert live.latencies_ms(run)[-1] == (1.2 - records[-1]["due"]) * 1e3


def test_nearest_rank_percentile():
    live = spec.load_module(spec.HERE / "traffic" / "live_streams.py")
    values = sorted(float(v) for v in range(1, 101))
    assert live.percentile(values, 95) == 95.0
    assert live.percentile(values, 50) == 50.0
    assert live.percentile([3.0], 95) == 3.0
