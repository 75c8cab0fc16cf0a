"""Kernels: the serving tail ``kernels/upsample_argmax.cu`` (through
``ops/upsample_argmax.py``): the least time the card could take for the
traced segment's frames, each an upsample of C f32 logit maps at feature
stride to the frame and an argmax (per class: a row pass of one FMA per
input row and output column, a column pass of one lerp per output pixel,
a compare per output pixel, at the f32 peak; bytes: the logits read, the
uint8 map written), as a share of the device time of the kernel's events.
Moves ``frames_per_s``."""

from benchmark.roofline import bound_s, feature_hw, share


def read(run):
    trace = run.trace
    if trace is None:
        return None
    c = run.config
    H, W = c["frame_hw"]
    h, _ = feature_hw(c)
    C = c["num_classes"]
    ops = C * (2 * h * W + 3 * H * W)
    n_bytes = C * h * feature_hw(c)[1] * 4 + H * W
    return share(trace.frames["frame"] * bound_s(n_bytes, ops, "f32"),
                 trace.kernel_s("upsample_argmax"))
