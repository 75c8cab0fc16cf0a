"""Device: the share of the traced segment's wall time in which no
operation ran on the card (1 - the union of the device events' intervals
over the segment). Moves ``frames_per_s``: the host's launches and copies
hold the card back for that share."""


def read(run):
    trace = run.trace
    if trace is None or not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
