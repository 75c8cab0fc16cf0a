"""Serving (the spans ``serve.key`` and ``serve.cur``: a ``push_frame`` that
runs the key or the cur predictor): the kernel-launch calls whose host
interval lies inside those ranges of the traced segment, a frame (as
``launches_per_group`` counts them). Moves ``latency_p50_ms``."""

from benchmark.spans import FRAME, launches_inside


def read(run):
    got = launches_inside(run.trace, FRAME)
    return None if got is None else got[0]
