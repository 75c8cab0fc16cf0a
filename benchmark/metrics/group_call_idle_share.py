"""Device, inside the serving call (the span ``serve.group``): the share of
the traced segment's ``serve.group`` ranges' time in which no device event
ran. The idle time inside the program's own calls, which fewer launches
(CUDA graphs) would remove; ``device_idle_share`` adds the time between
calls. Moves ``frames_per_s``."""

from benchmark.spans import GROUP, idle_share


def read(run):
    return idle_share(run.trace, GROUP)
