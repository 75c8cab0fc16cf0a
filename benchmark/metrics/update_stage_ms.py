"""Model step (the span ``model.update``: the update branch, R18; Accel only):
the stream ms of the stage a group, summed over the traced segment's
``model.update`` spans and divided by its ``serve.group`` spans. A span's
stream time runs from the current stream's event at its entry to the one at
its exit, so idle time while the stage's launches come in counts. Moves
``frames_per_s``."""

from benchmark.spans import stage_ms


def read(run):
    return stage_ms(run, "model.update")
