"""What the measured process may load: nothing that ``gpubench/run.py``
runs imports JAX or the JAX package, and ``gpubench/reference/`` imports
nothing of the program.  Module names are compared whole by their
top-level part: ``lsqrrecipes_tpu_torch`` is not ``lsqrrecipes_tpu``."""

import ast
import json
import shutil
import subprocess
import sys

import pytest

from gpubench.lib import guard, runner

BENCH_DIR = runner.BENCH_DIR
ROOT = runner.ROOT
PROGRAM = "lsqrrecipes_tpu_torch"


def imported_top_levels(path):
    """Top-level names of every absolute import in a Python file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {guard.top_level(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(guard.top_level(node.module))
    return out


def _sources(*parts):
    return sorted(p for p in BENCH_DIR.joinpath(*parts).rglob("*.py") if "tests" not in p.parts)


def test_top_level_names_are_compared_whole():
    assert guard.forbidden_loaded(["lsqrrecipes_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(["lsqrrecipes_tpu.ops.vote", "jax.numpy", "flax"]) == [
        "flax", "jax", "lsqrrecipes_tpu"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_harness_sources_import_no_jax(path):
    assert not imported_top_levels(path) & set(guard.FORBIDDEN)


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported_top_levels(path)
    assert PROGRAM not in names and not names & set(guard.FORBIDDEN)
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("gpubench"):
            assert node.module.startswith("gpubench.reference"), node.module


_RUN_SMALL = """
import json, sys
sys.path.insert(0, {root!r})
from gpubench.lib import guard, runner
cell = runner.Cell(runner.load_benchmark(), {cell!r},
                   {{"hypotheses": 512, "data": {{"n": 128}},
                     "traffic": {{"pool": 1, "warmup_fits": 1, "check_fits": 1, "trace_fits": 1}}}})
result = runner.run(cell, 5, 0.05, {trace}, "cpu", 0.0)
print(json.dumps({{"correct": result["correct"], "loaded": guard.forbidden_loaded(),
                  "program": "lsqrrecipes_tpu_torch" in sys.modules}}))
"""


@pytest.mark.parametrize("cell,trace", [("sphere3d.geometric", True),
                                        ("crosswire.analytic", False)])
def test_a_run_loads_no_jax(cell, trace):
    """A whole run in a fresh process, then its modules."""
    code = _RUN_SMALL.format(root=str(ROOT), cell=cell, trace=trace)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "loaded": [], "program": True}


_REFERENCE_ALONE = """
import json, sys, torch
sys.path.insert(0, {root!r})
from gpubench.reference import judge, sphere3d, crosswire
pts = torch.randn(128, 3, dtype=torch.float64) * 0.01
pts = 25.0 * pts / pts.norm(dim=-1, keepdim=True)
judge.reference_fit(sphere3d, pts, 1.0, 3, 256, "geometric", "cpu", torch.float64)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}} & {{"lsqrrecipes_tpu_torch",
      "lsqrrecipes_tpu", "jax", "jaxlib", "flax"}})))
"""


def test_the_reference_runs_without_the_program():
    proc = subprocess.run([sys.executable, "-c", _REFERENCE_ALONE.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "sphere3d.algebraic",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout == ""


def test_run_outside_a_checkout_prints_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "sphere3d.algebraic",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
    assert PROGRAM in proc.stderr
