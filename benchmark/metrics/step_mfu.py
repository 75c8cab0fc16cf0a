"""Model step (``core/pipeline.py``'s group step through
``models/{resnet,deeplab,flownet,accel}.py``): the share of the card's
bf16 peak (989 TFLOP/s) that the window's groups reach, their operations
counted on the plain reference (``benchmark/flops.py``) and divided by the
window's host-clock seconds. Moves ``frames_per_s``."""

from benchmark import flops
from benchmark.roofline import PEAK_OPS_PER_S


def read(run):
    groups = getattr(run, "groups_served", 0) * run.traffic["batch"]
    if not groups or run.device.type != "cuda":
        return None
    ops = flops.group_flops(run.config) * groups
    return 100.0 * ops / (run.window_s * PEAK_OPS_PER_S["bf16"])
