#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from, in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--seconds 2]

Runs the cell (``--trace 0``) once a seed, as ``benchmark/run.py`` does,
then, on ``--control-seeds``, the control: the same cell with the
configuration's ``control`` settings in place of its program settings
(the program's own lower-precision path, int8). One JSON line a run with
the gap numbers (``benchmark/correctness.py``), then a summary: each
number's largest program reading (the lower reading) and least control
reading (the upper one). The benchmark's own runs never run the control.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]
    sys.path.insert(0, str(ROOT))
    from benchmark import harness, spec

    cell = spec.load_cell(args.workload)
    control = dict(cell.config["network"], **cell.config["control"])
    readings = {"program": [], "control": []}
    for side, seeds, network in (("program", args.seeds, None),
                                 ("control", args.control_seeds, control)):
        for seed in (int(s) for s in seeds.split(",") if s):
            t = time.perf_counter()
            res = harness.execute(cell, seed, args.seconds, False, network=network,
                                  emit=lambda line: None)
            readings[side].append(res["gaps"])
            print(json.dumps(harness.finite(dict(
                workload=args.workload, side=side, seed=seed, correct=res["correct"],
                gaps=res["gaps"], metrics=res["metrics"], attempted=res["attempted"],
                failed=res["failed"], run_s=time.perf_counter() - t))), flush=True)
    summary = {}
    for name in readings["program"][0] if readings["program"] else []:
        lower = max(r[name] for r in readings["program"])
        upper = min((r[name] for r in readings["control"]), default=None)
        summary[name] = dict(lower=lower, upper=upper,
                             ratio=None if upper is None or lower == 0 else upper / lower)
    print(json.dumps(harness.finite(dict(workload=args.workload, summary=summary,
                                         seconds=time.perf_counter() - T0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
