"""Kernels: DFF's feature warp ``kernels/warp_onehot.cu`` (#4, through
``ops/warp_onehot.py``): the least time the card could take for the
traced segment's non-key frames, each one warp of the keyframe's fc6
features with the scale field multiplied in (bytes: the features, the
scale field and the f32 flow read, the warped features written; 8
operations an output element at the f32 peak), as a share of the device
time of the kernel's events. Moves ``frames_per_s``."""

from benchmark.roofline import bound_s, dtype_bytes, feature_hw, share


def read(run):
    trace = run.trace
    if trace is None:
        return None
    c = run.config
    h, w = feature_hw(c)
    elem = 4 if c["network"]["warp_dtype"] == "f32" else dtype_bytes(c)
    out = c["network"]["head_channels"] * h * w
    n_bytes = 3 * out * elem + 2 * h * w * 4
    return share(trace.frames["cur"] * bound_s(n_bytes, 8 * out, "f32"),
                 trace.kernel_s("warp_onehot"))
