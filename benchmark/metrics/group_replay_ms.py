"""Model step, as one CUDA graph (the span ``serve.replay`` inside
``serve.group``: the graph ``VideoSegmenter.push_group`` replays,
``accel_tpu_torch/core/graphs.py``): the replay's stream ms a group, summed
over the traced segment's ``serve.replay`` spans and divided by its
``serve.group`` spans. The stages run inside the graph with no host gap
between their launches, so this is the group's device time. None where no
group replayed (a program without graphs). Moves ``frames_per_s``."""

from benchmark.spans import stage_ms


def read(run):
    return stage_ms(run, "serve.replay")
