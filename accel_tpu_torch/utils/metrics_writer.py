"""Scalar metrics to JSONL (counterpart of
``accel_tpu/utils/metrics_writer.py``): one JSON object per line with the
step, the seconds since the writer opened and the metrics.
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def write(self, step: int, **metrics):
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
