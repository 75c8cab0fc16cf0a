"""The card's peaks and the least time a piece of work could take on it.

Published peaks of one NVIDIA H100 SXM (data sheet, dense rates): 989
TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in f32 on the CUDA cores,
3.35 TB/s of HBM. A bound counts each input byte read once and each output
byte written once, whatever a kernel reads again, and the operations the
algorithm needs for its inputs.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}


def bound_s(n_bytes: float, ops: float, kind: str) -> float:
    """The larger of bytes at the HBM rate and ``ops`` at the peak of
    ``kind``."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


def share(bound: float, measured_s: float) -> float | None:
    """``bound`` as a percentage of ``measured_s``; None where nothing was
    measured."""
    return None if measured_s <= 0 else 100.0 * bound / measured_s


def feature_hw(config: dict) -> tuple[int, int]:
    h, w = config["frame_hw"]
    s = config["network"]["feat_stride"]
    return h // s, w // s


def dtype_bytes(config: dict) -> int:
    return {"bfloat16": 2, "float32": 4}[config["network"]["dtype"]]
