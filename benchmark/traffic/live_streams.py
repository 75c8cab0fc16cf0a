"""Open loop: live camera streams served frame by frame through
``VideoSegmenter.push_frame``.

``streams`` independent cameras each send a frame every 1/``fps`` seconds.
Each stream has its own ``VideoSegmenter`` (its own keyframe schedule and
propagation state) over the one shared model. One serving thread takes the
frames in order of their due times, each as soon as it is due and the
previous one is done (it polls the clock while it waits); a frame is
served when its class map is on the host, and its latency runs from its
due time, so a frame queued behind another stream's keyframe pays the
wait.

Every seed gets the same arrivals and the same keyframe pattern: stream
slot i sends its first frame at ``i / (streams * fps)`` seconds and stands
at position ``i * key_interval // streams`` of its keyframe cycle when the
window opens; the seed shuffles which scene takes which slot and draws the
scenes. A stream's scene is a panning clip of ``clip_frames`` frames (a
multiple of the keyframe interval, so every keyframe group pans
smoothly), played in a loop.

The window takes the frames due in ``--seconds``; they are all served,
for up to ``drain_s`` past the window's end (the rest count as failed).
The traced segment serves the next ``trace_seconds`` of arrivals.

Each class map is copied into one of a few pinned host buffers (the
caller's); before the window the seed draws ``check_frames`` of the
frames due in it, half of them the last of their keyframe group (the
longest propagation), and the maps of those are kept for the reference.

Workload parameters: ``streams``, ``fps``, ``clip_frames``, ``drain_s``,
``trace_seconds``, ``check_frames``.
"""

from __future__ import annotations

import math
import random
import time

import torch

from benchmark import frames as frames_mod
from benchmark.weights import derive


def prepare(run) -> None:
    p, c = run.traffic, run.config
    n, k = p["streams"], c["key_interval"]
    if p["clip_frames"] % k:
        raise ValueError("clip_frames must be a multiple of the keyframe interval")
    slots = list(range(n))
    random.Random(derive(run.seed, "slots")).shuffle(slots)
    run.phase = [slots[s] / (n * p["fps"]) for s in range(n)]
    # frames pushed before the window: a whole cycle, then the slot's position
    run.pushed0 = [k + slots[s] * k // n for s in range(n)]
    run.clips = [frames_mod.panning_clip(p["clip_frames"], tuple(c["frame_hw"]),
                                         derive(run.seed, f"stream{s}"), run.device)[0]
                 for s in range(n)]
    run.ring = [torch.empty(tuple(c["frame_hw"]), dtype=torch.uint8,
                            pin_memory=run.device.type == "cuda") for _ in range(4)]


def calibration_pair(run) -> torch.Tensor:
    return frames_mod.nchw(run.clips[0][:2])


def _frame(run, s: int, index: int) -> torch.Tensor:
    """Stream ``s``'s frame at push ``index`` (1, H, W, 3)."""
    return run.clips[s][index % run.traffic["clip_frames"]][None]


def warm(run) -> None:
    from accel_tpu_torch.core.serving import VideoSegmenter

    c = run.config
    run.segmenters = [VideoSegmenter(run.model, c["key_interval"], propagate=c["propagate"])
                      for _ in run.clips]
    for s, seg in enumerate(run.segmenters):
        for i in range(run.pushed0[s]):
            seg.push_frame(_frame(run, s, i)).cpu()
    run.pushed = list(run.pushed0)


def _schedule(run, t_from: float, t_to: float) -> list:
    """(due, stream) of every frame due in [t_from, t_to), by due time."""
    fps = run.traffic["fps"]
    out = []
    for s, phase in enumerate(run.phase):
        j = max(0, math.ceil((t_from - phase) * fps - 1e-9))
        while phase + j / fps < t_to:
            out.append((phase + j / fps, s))
            j += 1
    return sorted(out)


def _serve(run, schedule: list, t_zero: float, deadline: float, records: list,
           keep=frozenset()) -> None:
    """Serve ``schedule`` in order against the clock ``t_zero``; frames
    not started by ``deadline`` (on that clock) fail. The maps of the
    frames at the positions in ``keep`` are kept."""
    for i, (due, s) in enumerate(schedule):
        now = time.perf_counter() - t_zero
        if now >= deadline:
            records.append(dict(due=due, stream=s, failed=True))
            continue
        slept = now < due
        # the thread polls for the next frame rather than sleeping, so its
        # core neither idles down nor pays a wake-up between frames
        while time.perf_counter() - t_zero < due:
            pass
        start = time.perf_counter() - t_zero
        seg = run.segmenters[s]
        index = run.pushed[s]
        kind = "key" if seg.is_keyframe_next else "cur"
        pred = seg.push_frame(_frame(run, s, index))
        host = run.ring[i % len(run.ring)]
        host.copy_(pred[0])
        done = time.perf_counter() - t_zero
        run.pushed[s] += 1
        records.append(dict(due=due, stream=s, index=index, kind=kind, start=start, done=done,
                            late=start - due if slept else None, failed=False,
                            map=host.clone() if i in keep else None))


def _keep(run, schedule: list) -> set:
    """The positions in ``schedule`` whose maps the reference checks: half
    the last frames of their keyframe group, half any others."""
    k, n = run.config["key_interval"], run.traffic["check_frames"]
    index = list(run.pushed)
    last, rest = [], []
    for i, (_, s) in enumerate(schedule):
        (last if index[s] % k == k - 1 else rest).append(i)
        index[s] += 1
    rng = random.Random(derive(run.seed, "check"))
    picked = rng.sample(last, min(n // 2, len(last)))
    return set(picked + rng.sample(rest, min(n - len(picked), len(rest))))


def serve(run, seconds: float) -> None:
    run.window_s = seconds
    schedule = _schedule(run, 0.0, seconds)
    keep = _keep(run, schedule)
    t_zero = time.perf_counter() + 0.01
    _serve(run, schedule, t_zero, seconds + run.traffic["drain_s"], run.records, keep)
    run.t_zero = t_zero


def traced_segment(run, frames: dict) -> None:
    t0 = run.window_s
    now = time.perf_counter() - run.t_zero
    # the next arrivals, on a clock moved so that the first is due now
    shift = now - t0
    records: list = []
    _serve(run, _schedule(run, t0, t0 + run.traffic["trace_seconds"]), run.t_zero + shift,
           math.inf, records)
    for kind in ("key", "cur"):
        frames[kind] = sum(1 for r in records if r.get("kind") == kind)
    frames["frame"] = frames["key"] + frames["cur"]


def latencies_ms(run) -> list[float]:
    """Every due frame's latency from its due time; a failed frame's runs
    to the end of the drain."""
    end = run.window_s + run.traffic["drain_s"]
    return sorted(1e3 * ((end if r["failed"] else r["done"]) - r["due"]) for r in run.records)


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile of sorted ``values``."""
    return values[max(0, math.ceil(q / 100 * len(values)) - 1)]


def counts(run) -> tuple[int, int]:
    return len(run.records), sum(r["failed"] for r in run.records)


def end_to_end(run) -> dict:
    lat = latencies_ms(run)
    return dict(latency_p95_ms=percentile(lat, 95), latency_p50_ms=percentile(lat, 50))


def service_ms(run, kind: str) -> list[float]:
    return sorted(1e3 * (r["done"] - r["start"]) for r in run.records
                  if not r["failed"] and r["kind"] == kind)


def report(run) -> list:
    late = sorted(1e3 * r["late"] for r in run.records if r.get("late") is not None)
    served = [r for r in run.records if not r["failed"]]
    return [dict(frames_due=len(run.records), frames_served=len(served),
                 keyframes=sum(r["kind"] == "key" for r in served),
                 last_done_s=max((r["done"] for r in served), default=None),
                 generator_late_ms=dict(n=len(late), p50=percentile(late, 50) if late else None,
                                        p99=percentile(late, 99) if late else None,
                                        max=late[-1] if late else None))]


def sample(run, rng: random.Random):
    """(frames from the frame's keyframe to it (n,3,H,W), n, its served map
    (1,H,W)) of each kept frame that was served (the seed drew them before
    the window, ``_keep``; ``rng`` is not needed)."""
    k = run.config["key_interval"]
    for r in run.records:
        if r["failed"] or r["map"] is None:
            continue
        pos = r["index"] % k
        key = r["index"] - pos
        frames = torch.cat([_frame(run, r["stream"], key + i) for i in range(pos + 1)])
        yield frames_mod.nchw(frames), pos + 1, r["map"][None]
