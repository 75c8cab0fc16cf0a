#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on this machine's card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up makes the weights and frames from the
seed on the card, builds the program (``accel_tpu_torch``; its CUDA kernels
compile into ``accel_tpu_torch/kernels/_build/`` on a checkout's first run)
and serves the cell's shapes once; then the window serves the cell's
traffic for ``--seconds``. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, from a traced segment of the
same traffic after the window. Every run then checks a sample of the
window's class maps against the plain f32 reference. The last line of
standard output is the result's JSON; standard error ends with each
number compared and its limit. Exits 2 without the cards the cell needs,
3 when the run loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# compile caches at fixed paths inside the checkout
CACHE = ROOT / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(CACHE / sub)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # the checkout's root, not this directory, on the import path
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
