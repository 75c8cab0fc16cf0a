"""The port imports neither JAX, PyYAML nor the JAX package: the machine
with the card has none of them. Every module of ``accel_tpu_torch`` and
``chip_smoke.py`` must import with those blocked."""

import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
for blocked in ("jax", "jaxlib", "flax", "yaml", "accel_tpu"):
    sys.modules[blocked] = None
import accel_tpu_torch
names = [m.name for m in pkgutil.walk_packages(accel_tpu_torch.__path__, "accel_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = sorted(m for m, v in sys.modules.items()
                if v is not None and m.split(".")[0] in ("jax", "jaxlib", "flax", "yaml", "accel_tpu"))
assert not loaded, loaded
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # ops (7), models (4), core (3), kernels, convert and three package inits
    assert int(out.stdout.strip()) == 19
