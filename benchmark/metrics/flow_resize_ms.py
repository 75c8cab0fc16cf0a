"""Kernels: FlowNet-S's 2x bilinear resizes (its decoder's four feature
resizes and four flow resizes a pair, ``models/flownet.py``): the device ms
a FlowNet pair, the traced segment's resize events over its non-key frames
(one pair each). The events are the 2x upsample kernel's
(``kernels/upsample2x.cu``, ``upsample2x_kernel``) or, in a program
without it, PyTorch's ``upsample_bilinear2d`` (forward); an antialiased
downscale (``upsample_gen2d_aa``) is not counted. In the benchmark's
cells FlowNet-S is the only caller of an exact 2x upscale, and every other
resize there is an antialiased downscale or the tail's own kernel. None
without a trace or where no resize ran. Moves ``frames_per_s``."""

KERNEL = "upsample2x_kernel"
LIBRARY = "upsample_bilinear2d"


def is_flow_resize(name: str) -> bool:
    """Whether a device event is a 2x resize: the port's kernel (its
    function name, or the mangled name's ``_upsample2x_cu_``) or the
    library's bilinear forward."""
    if KERNEL in name or "_upsample2x_cu_" in name:
        return True
    return LIBRARY in name and "backward" not in name


def read(run):
    trace = run.trace
    if trace is None or not trace.frames.get("cur"):
        return None
    seconds = sum(e - s for name, s, e in trace.device if is_flow_resize(name))
    if seconds == 0:
        return None
    return 1e3 * seconds / trace.frames["cur"]
