"""PNG reading for the datasets, through ``cv2.imread`` as the reference
reads them (``accel_tpu/data/cityscapes.py``, ``camvid.py``). ``cv2`` is
imported on the first read, not with the module.

Flags follow ``cv2``: ``IMREAD_UNCHANGED`` gives (H, W) for gray, (H, W, 3)
BGR for RGB and (H, W, 4) BGRA for RGBA; ``IMREAD_COLOR`` gives (H, W, 3)
BGR always (gray repeated, alpha dropped).
"""

from __future__ import annotations

import numpy as np

IMREAD_UNCHANGED = -1  # cv2.IMREAD_UNCHANGED
IMREAD_COLOR = 1  # cv2.IMREAD_COLOR


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """``cv2.imread(path, flags)`` for ``IMREAD_UNCHANGED`` and
    ``IMREAD_COLOR``; raises ``FileNotFoundError`` where ``cv2`` returns
    None (a missing or unreadable file)."""
    import cv2

    if flags not in (IMREAD_UNCHANGED, IMREAD_COLOR):
        raise ValueError(f"unsupported imread flags {flags}")
    im = cv2.imread(path, flags)
    if im is None:
        raise FileNotFoundError(path)
    return im
