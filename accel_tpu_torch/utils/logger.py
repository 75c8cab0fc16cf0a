"""Per-experiment logger factory (counterpart of ``accel_tpu/utils/logger.py``).

Creates the experiment's output directory and a logger that writes to a
timestamped file there and to the console.
"""

from __future__ import annotations

import logging
import os
import time


def create_logger(output_path: str, cfg_name: str, image_set: str = "",
                  rank: int = 0) -> tuple[logging.Logger, str]:
    """Create the output dir and a file + console logger named
    ``accel_tpu_torch.<cfg_name>``; returns (logger, final_output_path).
    A data-parallel rank other than 0 gets a logger with no handlers of
    its own (``accel_tpu_torch.<cfg_name>.rank<rank>``, not propagating),
    whose warnings reach stderr through logging's last resort: only rank 0
    writes the log."""
    final_output_path = (os.path.join(output_path, cfg_name, image_set) if image_set
                         else os.path.join(output_path, cfg_name))
    os.makedirs(final_output_path, exist_ok=True)
    if rank:
        logger = logging.getLogger(f"accel_tpu_torch.{cfg_name}.rank{rank}")
        logger.setLevel(logging.INFO)
        logger.propagate = False
        return logger, final_output_path
    log_file = os.path.join(
        final_output_path, "{}_{}.log".format(cfg_name, time.strftime("%Y-%m-%d-%H-%M")))
    logger = logging.getLogger(f"accel_tpu_torch.{cfg_name}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    # idempotent: no second pair of handlers on a repeated call
    if not logger.handlers:
        fmt = logging.Formatter("%(asctime)s %(message)s")
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(fh)
        logger.addHandler(sh)
    return logger, final_output_path
