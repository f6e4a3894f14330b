"""No run loads JAX or the JAX package, and the reference imports nothing
of the program under test."""

import ast
import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.conftest import WORKLOADS


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert harness.PROGRAM not in tops, path.name
        assert not tops & set(harness.FORBIDDEN), path.name


def test_no_benchmark_file_imports_jax():
    for path in harness.HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_dry_run_loads_no_jax(workload):
    """Each traffic's CPU path at the tiny size, in a fresh process; then
    every loaded module's top-level name, compared whole."""
    code = f"""
import json, sys, time
sys.path.insert(0, {str(harness.ROOT)!r})
from portbench import harness, run
from portbench.tests.conftest import tiny
res, _ = run.run_cell({workload!r}, 12345, 0.5, 0, device="cpu", overrides=tiny({workload!r}),
                      t_start=time.perf_counter())
print(json.dumps({{"correct": res["correct"], "found": harness.jax_modules(),
                  "program": harness.PROGRAM in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["found"] == [] and res["program"] and res["correct"]
