"""Device, inside the serving call (the spans ``serve.key`` and
``serve.cur``): the share of those ranges' time in the traced segment in
which no device event ran; the wait for arrivals and the caller's map
copy fall outside. Moves ``latency_p50_ms``."""

from benchmark.spans import FRAME, idle_share


def read(run):
    return idle_share(run.trace, FRAME)
