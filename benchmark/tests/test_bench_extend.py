"""A later change adds a configuration, a cell and a per-layer metric by
adding files and ``BENCHMARK.json`` entries alone: in a throwaway copy of
the benchmark, with no file of it edited, the new cell runs (here on the
CPU, at a tiny size) and reports the new metric."""

import hashlib
import json
import shutil
import subprocess
import sys

from conftest import tiny_config

from benchmark import spec

METRIC = '''"""Serving: the slowest group of the window, host clock."""


def read(run):
    return max(1e3 * (r["done"] - r["start"]) for r in run.records)
'''

RUN = """
import json, sys
sys.path.insert(0, ".")
from benchmark import harness, spec
res = harness.execute(spec.load_cell("tiny-accel-offline"), 3, 0.2, trace=True, device="cpu",
                      emit=lambda line: None)
print(json.dumps(harness.finite(res)))
"""


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_config_and_metric_added_by_files_alone(tmp_path):
    co = tmp_path / "checkout"
    shutil.copytree(spec.HERE, co / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", co / "BENCHMARK.json")
    (co / "accel_tpu_torch").symlink_to(spec.ROOT / "accel_tpu_torch")
    before = _digests(co / "benchmark")

    config = tiny_config(json.loads((spec.HERE / "configs" / "accel18-cityscapes.json")
                                    .read_text()))
    config["name"] = "tiny-accel"
    (co / "benchmark" / "configs" / "tiny-accel.json").write_text(json.dumps(config))
    workload = dict(json.loads((spec.HERE / "workloads" / "accel18-offline.json").read_text()),
                    clips=2, warm_groups=1, trace_groups=1, check_clips=1)
    (co / "benchmark" / "workloads" / "tiny-accel-offline.json").write_text(json.dumps(workload))
    (co / "benchmark" / "metrics" / "group_ms_max.py").write_text(METRIC)
    bench = json.loads((co / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="tiny-accel", source="https://arxiv.org/abs/1807.06667",
                                 file="benchmark/configs/tiny-accel.json", reduced=[],
                                 why="a throwaway tiny Accel"))
    bench["workloads"].append(dict(name="tiny-accel-offline", config="tiny-accel",
                                   traffic="closed-loop-groups-b1", chips=1, why="throwaway"))
    for m in bench["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("tiny-accel-offline")
    bench["per_layer"].append(dict(name="group_ms_max", unit="ms", better="lower",
                                   source="host_clock", layer="serving", moves="frames_per_s",
                                   workloads=["tiny-accel-offline"]))
    (co / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", RUN], cwd=co, capture_output=True, text=True,
                         timeout=600, check=True).stdout
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["group_ms_max"]["value"] > 0
    after = _digests(co / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
