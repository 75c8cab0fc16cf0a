"""Model step, as one CUDA graph a frame (the span ``serve.replay`` inside
``serve.key`` or ``serve.cur``: the graph of the step ``push_frame``
replays, ``accel_tpu_torch/core/graphs.py``): the replays' stream ms
summed over the traced segment and divided by its ``serve.key`` and
``serve.cur`` spans. The stages run inside the graph with no host gap
between their launches, so this is a frame's device time, keyframes and
non-key frames in the segment's mix. None where no frame replayed (a
program that serves ``push_frame`` eagerly) or the replays have no stream
time (no card). Moves ``latency_p50_ms``."""

from benchmark.program_spans import program_span_records
from benchmark.spans import FRAME


def read(run):
    if run.trace is None:
        return None
    records = program_span_records() or []
    frames = {r.id for r in records if r.name in FRAME}
    replays = [r for r in records if r.name == "serve.replay" and r.parent in frames]
    if not replays or any(r.stream_s is None for r in replays):
        return None
    return 1e3 * sum(r.stream_s for r in replays) / len(frames)
