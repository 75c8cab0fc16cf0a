"""Serving (the span ``serve.group``): the host ms spent inside the launch
calls that ``launches_per_group`` counts, a group. Moves
``frames_per_s``."""

from benchmark.spans import GROUP, launches_inside


def read(run):
    got = launches_inside(run.trace, GROUP)
    return None if got is None else 1e3 * got[1]
