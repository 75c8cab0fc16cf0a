"""Train, then test, with the same arguments (counterpart of
``experiments/train_test.py``).

    python3 -m accel_tpu_torch.experiments.train_test --cfg experiments/cfgs/accel18_cityscapes.yaml

Runs ``python3 -m accel_tpu_torch.experiments.train`` and then
``...experiments.test``, each in its own process with every argument given
here, and stops with the first nonzero exit code. Both must take the
arguments (``--cfg``, ``--device``, ``--set-network``).
"""

from __future__ import annotations

import subprocess
import sys


def main(argv=None) -> int:
    """Returns 0, or the exit code of the first step that failed."""
    args = sys.argv[1:] if argv is None else list(argv)
    for step in ("train", "test"):
        cmd = [sys.executable, "-m", f"accel_tpu_torch.experiments.{step}", *args]
        print("+", " ".join(cmd), flush=True)
        rc = subprocess.call(cmd)
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
