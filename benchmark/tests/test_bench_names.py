"""``BENCHMARK.json`` against the benchmark's contract: names, units and
single-line texts of the allowed characters, the keys each entry may
have, and a file for every piece a cell is found by."""

import json
import re

import pytest

from benchmark import spec
from benchmark.correctness import NUMBERS

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _text_ok(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(_text_ok(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("section", list(KEYS))
def test_entries(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _text_ok(e[key]), (key, e[key])


def test_metric_names_across_sections_are_unique_and_bounds_in_range():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["name"].endswith("_roofline") == (m["unit"] == "%" and "roofline" in m["name"])


def test_every_cell_is_found_by_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = spec.load_cell(w["name"])
        assert (spec.HERE / "traffic" / f"{cell.workload['driver']}.py").is_file()
        assert cell.workload["limits"] and set(cell.workload["limits"]) <= set(NUMBERS)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m, _ in cell.per_layer:
            assert m["moves"] in e2e
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    for c in configs.values():
        config = json.loads((spec.ROOT / c["file"]).read_text())
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert config["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert (spec.HERE / "reference" / f"{config['reference']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
