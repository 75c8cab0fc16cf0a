"""Serving layer (``core/serving.py`` ``VideoSegmenter.push_frame`` on a
non-key frame: the cur predictor of ``core/predictor.py``): the median
host time from the call to the class map on the host, over the window's
non-key frames. Moves ``latency_p50_ms``: most frames are non-key."""

import statistics


def read(run):
    ms = run.cell.driver.service_ms(run, "cur")
    return statistics.median(ms) if ms else None
