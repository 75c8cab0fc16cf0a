"""Serving (the spans ``serve.group`` and ``serve.replay``:
``VideoSegmenter.push_group`` and the CUDA graph it replays,
``accel_tpu_torch/core/graphs.py``): the share (%) of the traced segment's
``serve.group`` spans that replayed a graph. Under 100 where a group ran
eagerly: the first group of a shape, or every group of a shape whose
capture failed. None where the program serves no group from a graph (it
has no ``core/graphs.py``), its spans did not run or the trace holds no
device event (no card). Moves
``frames_per_s``: a replayed group is one launch."""

from benchmark import spans

REPLAY = "serve.replay"


def program_replays() -> bool:
    """Whether the program serves groups from CUDA graphs."""
    try:
        from accel_tpu_torch.core import graphs  # noqa: F401
    except ImportError:
        return False
    return True


def read(run):
    if run.trace is None or not run.trace.device or not program_replays():
        return None
    totals = spans.program_span_totals()
    groups = (totals or {}).get(spans.GROUP[0], {}).get("count", 0)
    if not groups:
        return None
    return 100.0 * totals.get(REPLAY, {}).get("count", 0) / groups
