"""The port imports neither JAX, optax, PyYAML nor the JAX package: the
machine with the card has no JAX, and the port keeps clear of the others.
Every module of ``accel_tpu_torch`` and ``chip_smoke.py`` must import with
those blocked, and with ``cv2`` blocked too: the PNG reader imports it on
its first read."""

import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "yaml", "accel_tpu", "cv2")
for blocked in BLOCKED:
    sys.modules[blocked] = None
import accel_tpu_torch
names = [m.name for m in pkgutil.walk_packages(accel_tpu_torch.__path__, "accel_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m, v in sys.modules.items()
                if v is not None and m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # ops (11), models (4), core (10), config (2), data (7), utils (5),
    # experiments (5), parallel (mesh, spatial and the package init), native (one
    # package), kernels, convert and seven package inits
    assert int(out.stdout.strip()) == 57
