#!/usr/bin/env python3
"""Find a live cell's knee: its traffic at each number of streams.

    python3 benchmark/sweep.py --workload <live cell> --streams 2,3,4,... \
        [--seconds 8] [--seed 1]

Runs the cell (``--trace 0``) once for each number of streams, in one
process, with everything else as its workload file sets it, and prints one
line each: the aggregate frame rate, p50 and p95 latency from due times,
the frame interval (1/fps), and whether the backlog grew (the window's last
frame was served more than a frame interval after the window closed, or
a frame failed). The knee is the highest rate whose p95 is within one frame
interval and whose backlog did not grow; a cell takes the whole number of
streams nearest 0.8 x knee / fps.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--streams", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]
    sys.path.insert(0, str(ROOT))
    from benchmark import harness, spec

    base = spec.load_cell(args.workload)
    fps = base.workload["fps"]
    knee = None
    for n in (int(s) for s in args.streams.split(",")):
        cell = copy.copy(base)
        cell.workload = dict(base.workload, streams=n)
        lines = []
        res = harness.execute(cell, args.seed, args.seconds, False, emit=lines.append)
        report = next(r for r in map(json.loads, lines) if "last_done_s" in r)
        m = res["metrics"]
        interval_ms = 1e3 / fps
        row = dict(streams=n, rate=n * fps, p50_ms=m["latency_p50_ms"]["value"],
                   p95_ms=m["latency_p95_ms"]["value"], interval_ms=interval_ms,
                   late_drain_s=report["last_done_s"] - args.seconds,
                   correct=res["correct"], failed=res["failed"])
        row["backlog_grew"] = bool(row["late_drain_s"] > 1 / fps or res["failed"])
        row["within"] = row["p95_ms"] <= interval_ms and not row["backlog_grew"]
        if row["within"]:
            knee = row["rate"]
        print(json.dumps(row), flush=True)
    print(json.dumps(dict(workload=args.workload, knee_frames_per_s=knee,
                          streams=None if knee is None else round(0.8 * knee / fps),
                          seconds=time.perf_counter() - T0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
