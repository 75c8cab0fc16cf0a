"""Serving (the spans ``serve.key``/``serve.cur`` and ``serve.replay``:
``VideoSegmenter.push_frame`` and the CUDA graph of its key or cur step,
``accel_tpu_torch/core/graphs.py``): the share (%) of the traced segment's
``serve.key`` and ``serve.cur`` spans that hold a ``serve.replay``. Under
100 where a frame ran eagerly: a step's first call of a signature, or
every call of a signature whose capture failed. None where no frame
replayed (a program that serves ``push_frame`` eagerly), the spans did
not run or the trace holds no device event (no card). Moves
``latency_p50_ms``: a replayed frame is one launch."""

from benchmark.program_spans import program_span_records
from benchmark.spans import FRAME


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    records = program_span_records() or []
    frames = {r.id for r in records if r.name in FRAME}
    replayed = {r.parent for r in records if r.name == "serve.replay" and r.parent in frames}
    if not replayed:
        return None
    return 100.0 * len(replayed) / len(frames)
