"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the program."""

import ast
import json
import subprocess
import sys

from benchmark import spec

RUN_TINY = """
import json, sys
sys.path.insert(0, {tests!r})
from conftest import tiny_cell
from benchmark import harness
for name in {names!r}:
    harness.execute(tiny_cell(name), 11, 0.2, trace=False, device="cpu", emit=lambda line: None)
print(json.dumps(harness.forbidden_modules()))
"""


def test_a_run_of_every_cell_loads_no_jax():
    names = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())[
        "workloads"]]
    out = subprocess.run([sys.executable, "-c", RUN_TINY.format(
        tests=str(spec.HERE / "tests"), names=names)], cwd=spec.ROOT, capture_output=True,
        text=True, timeout=600, check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []


def test_forbidden_modules_compare_whole_top_level_names():
    from benchmark import harness

    sys.modules.setdefault("accel_tpu_torch_lookalike", sys)
    try:
        assert "accel_tpu_torch_lookalike" not in harness.forbidden_modules()
        sys.modules["accel_tpu.fake"] = sys
        assert harness.forbidden_modules() == ["accel_tpu.fake"]
    finally:
        sys.modules.pop("accel_tpu.fake", None)
        sys.modules.pop("accel_tpu_torch_lookalike", None)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((spec.HERE / "reference").glob("*.py"))
    assert files
    for path in files:
        found = set(_imports(path)) & {"accel_tpu_torch", "accel_tpu", "jax", "jaxlib", "flax"}
        assert not found, (path.name, found)
