"""Finding a cell's pieces by name.

Everything that belongs to one configuration, one cell or one per-layer
metric sits in files of its own, found from ``BENCHMARK.json``:

- a configuration: the file its entry names (``benchmark/configs/``), whose
  ``reference`` names its plain reference, ``benchmark/reference/<name>.py``;
- a cell's traffic and its correctness limits: ``benchmark/workloads/<cell>.json``,
  whose ``driver`` names the traffic generator, ``benchmark/traffic/<driver>.py``;
- a per-layer metric: its reader, ``benchmark/metrics/<metric>.py``.

A new configuration, cell or metric is added by adding files and entries;
no file here names one.
"""

from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@functools.cache
def load_module(path: Path):
    """The Python file at ``path`` as a module (its name need not be an
    identifier)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = "benchmark_" + "_".join(path.relative_to(HERE).with_suffix("").parts)
    mod_spec = importlib.util.spec_from_file_location(name.replace("-", "_").replace(".", "_"),
                                                      path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    workload: dict
    end_to_end: list = field(default_factory=list)   # BENCHMARK.json entries
    per_layer: list = field(default_factory=list)    # (entry, reader module)

    @property
    def driver(self):
        return load_module(HERE / "traffic" / f"{self.workload['driver']}.py")


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    workload file, end-to-end metrics and per-layer readers."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[entry["config"]]["file"]).read_text())
    workload = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [(m, load_module(HERE / "metrics" / f"{m['name']}.py"))
                 for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name, int(entry["chips"]), config, workload, e2e, per_layer)


def reference_model(config: dict, dtype, device):
    """The configuration's plain reference (``benchmark/reference/<name>.py``,
    its ``build(config, dtype, device)``): on the meta device in the
    serving dtype it gives the weights' layout; in f32 it computes."""
    module = load_module(HERE / "reference" / f"{config['reference']}.py")
    return module.build(config, dtype, device)
