"""The metrics that read the program's own tracing (``gpubench/lib/program.py``):
in a fresh process, as ``run.py`` runs a cell, an untraced run leaves
program tracing off, and a small traced run on the CPU reads each of them
where its entry in BENCHMARK.json applies (``host_syncs`` reads the CUDA
runtime's calls, so only on the card; its counting is checked on a made-up
profile)."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from gpubench.lib import runner
from lsqrrecipes_tpu_torch.utils import profiling

BENCH = runner.load_benchmark()
NEW = ("host_syncs", "host_wait_ms", "sweep_prep_ms", "lm_step_host_us", "lm_live_share")

_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from gpubench.lib import runner
from lsqrrecipes_tpu_torch.utils import profiling
cell = runner.Cell(runner.load_benchmark(), {cell!r},
                   {{"hypotheses": 512, "data": {{"n": 128}},
                     "traffic": {{"pool": 1, "warmup_fits": 1, "check_fits": 1, "trace_fits": 1}}}})
plain = runner.run(cell, 2**31 + 11, 0.05, False, "cpu", 0.0)
untraced = len(profiling.records())
traced = runner.run(cell, 2**31 + 12, 0.05, True, "cpu", 0.0)
print(json.dumps({{"correct": [plain["correct"], traced["correct"]], "untraced": untraced,
                  "metrics": {{k: v["value"] for k, v in traced["metrics"].items()}}}}))
"""


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_run_reads_the_programs_tracing(name):
    proc = subprocess.run([sys.executable, "-c", _RUN.format(root=str(runner.ROOT), cell=name)],
                          capture_output=True, text=True, timeout=300, cwd=runner.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"] == [True, True] and got["untraced"] == 0
    applies = {m["name"] for m in runner.Cell(BENCH, name).per_layer} & set(NEW)
    assert applies == (set(NEW) if name.endswith(("geometric", "iterative")) else
                       {"host_syncs", "host_wait_ms", "sweep_prep_ms"})
    read = {k: v for k, v in got["metrics"].items() if k in NEW}
    assert set(read) == applies - {"host_syncs"}
    assert read["host_wait_ms"] > 0 and read["sweep_prep_ms"] > 0
    if "lm_live_share" in read:
        assert 0 < read["lm_live_share"] <= 100 and read["lm_step_host_us"] > 0


@pytest.fixture
def metrics():
    """``host_syncs`` and the helper, imported with program tracing left as
    it was."""
    was = profiling.set_tracing(False)
    from gpubench.lib import program
    profiling.set_tracing(was)
    return program, runner.load_file(runner.BENCH_DIR / "metrics" / "host_syncs.py")


def _profile(shift_us=-1.9e6):
    """A window fit, then two profiled fits, each a harness ``fit`` span
    (seconds) around the program's ``engine.fit`` (ns); the profile's clock
    is the program's in us plus ``shift_us``, and each ``lsqr.`` range
    opens half a microsecond before its record starts."""
    rec = profiling.Record
    recs = [rec("span", "engine.fit", 1_001_000_000, 1_090_000_000, None, 1, None, None),
            rec("span", "engine.fit", 2_001_000_000, 2_080_000_000, None, 2, None, None),
            rec("leaf", "sweep.prep", 2_002_000_000, 2_003_000_000, 0, 2, None, None),
            rec("leaf", "wait.count", 2_050_000_000, 2_051_000_000, 0, 2, None, None),
            rec("span", "engine.fit", 3_001_000_000, 3_080_000_000, None, 3, None, None),
            rec("leaf", "wait.count", 3_050_000_000, 3_051_000_000, 4, 3, None, None)]

    def at(ns):
        return 1e-3 * ns + shift_us

    host = [(at(r.start_ns) - 0.5, at(r.end_ns), "lsqr." + r.name) for r in recs
            if r.kind == "leaf"]
    host += [(at(t), at(t) + 5.0, name) for t, name in [
        (1_050_000_000, "cudaStreamSynchronize"),      # the window's fit: not profiled
        (2_002_500_000, "cudaStreamSynchronize"),
        (2_050_500_000, "cudaStreamSynchronize"),
        (2_040_000_000, "cudaDeviceSynchronize"),      # the harness's own
        (2_085_000_000, "cudaStreamSynchronize"),      # the harness's read-back
        (3_050_500_000, "cudaStreamSynchronize")]]
    run = SimpleNamespace(
        spanned=1, spans=SimpleNamespace(log={"fit": [(1.0, 1.1), (2.0, 2.1), (3.0, 3.1)]}),
        trace=SimpleNamespace(dev=[(0.0, 1.0, "kernel", 0.0)],
                              host=sorted(host, key=lambda h: (h[0], -h[1]))))
    return recs, run


def test_host_syncs_counts_the_syncs_inside_each_profiled_fit(metrics, monkeypatch):
    program, host_syncs = metrics
    recs, run = _profile()
    monkeypatch.setattr(program.profiling, "records", lambda: recs)
    assert [r.fit for r in program.window_records(run)] == [1]
    assert {r.fit for r in program.profiled_records(run)} == {2, 3}
    assert host_syncs.read(run) == 1.5
    # Ranges that do not match the records, or no device, read nothing.
    recs, run = _profile()
    run.trace.host = [h for h in run.trace.host if h[2] != "lsqr.sweep.prep"]
    assert host_syncs.read(run) is None
    recs, run = _profile()
    run.trace.dev = []
    assert host_syncs.read(run) is None
