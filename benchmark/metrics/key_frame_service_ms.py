"""Serving layer (``core/serving.py`` ``VideoSegmenter.push_frame`` on a
keyframe: the key predictor of ``core/predictor.py``): the median host
time from a keyframe's ``push_frame`` call to its class map on the host,
over the window's keyframes. Moves ``latency_p95_ms``: a keyframe costs
the most and frames queue behind it."""

import statistics


def read(run):
    ms = run.cell.driver.service_ms(run, "key")
    return statistics.median(ms) if ms else None
