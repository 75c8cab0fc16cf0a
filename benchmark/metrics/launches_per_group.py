"""Serving (the span ``serve.group``: ``VideoSegmenter.push_group``): the
kernel-launch calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``; a
``cudaGraphLaunch`` counts one) whose host interval lies inside a
``serve.group`` range of the traced segment, a group. Moves
``frames_per_s``: each launch costs the host time the card may wait."""

from benchmark.spans import GROUP, launches_inside


def read(run):
    got = launches_inside(run.trace, GROUP)
    return None if got is None else got[0]
