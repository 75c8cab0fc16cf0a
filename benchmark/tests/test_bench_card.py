"""Each cell run as the benchmark's command runs it, on the card: a short
window, untraced and traced, must end with a correct result that holds
every metric of the cell. Marked ``card``; skipped without one (run with
``python3 -m pytest benchmark/tests -m card`` on a machine that has one)."""

import json
import subprocess
import sys

import pytest

from benchmark import spec

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_is_correct_and_complete(name, trace, card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          str(2**31 + 99), "--seconds", "2", "--trace", str(trace)],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=900, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    cell = spec.load_cell(name)
    want = ({m["name"] for m, _ in cell.per_layer} if trace
            else {m["name"] for m in cell.end_to_end})
    assert res["correct"] is True, res["compared"]
    assert set(res["metrics"]) == want
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == cell.chips
    assert list(res)[-1] == "compared"
