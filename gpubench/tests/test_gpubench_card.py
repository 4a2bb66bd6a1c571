"""Whole runs on the card at a reduced size: the check passes, the traced
run reads every per-layer metric and a breakdown.  Run on the card with

    python -m pytest gpubench/tests -m cuda
"""

import pytest
import torch

from gpubench.lib import runner

BENCH = runner.load_benchmark()
CELLS = tuple(w["name"] for w in BENCH["workloads"])
REDUCED = {"hypotheses": 65536, "traffic": {"pool": 2, "warmup_fits": 1, "check_fits": 2,
                                            "trace_fits": 2}}
# The per-layer metrics only a fused sweep feeds: a cell that runs none is
# left out of their lists.
FUSED_ONLY = ("engine_self_ms", "sweep_ms", "sweep_roofline", "sweep_prep_ms")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


def runs_and_reads(cell, card):
    plain = runner.run(cell, 2**31 + 5, 0.5, False, card, 0.0)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {m["name"] for m in cell.end_to_end}
    traced = runner.run(cell, 2**31 + 6, 0.5, True, card, 0.0)
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < traced["device"]["busy_s"] < traced["device"]["window_s"]
    assert traced["breakdown"]["device_ops"] and traced["breakdown"]["idle_gaps"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(card, name):
    runs_and_reads(runner.Cell(BENCH, name, REDUCED), card)


@pytest.mark.cuda
def test_a_structured_sweep_runs_on_the_card(card):
    """``sphere3d.algebraic`` as a cell whose estimator no fused kernel
    serves (the plane phantom's path): ``ransac_fused_sweep`` falls back to
    ``ransac_structured`` inside its own span, and the check rebuilds the
    structured design.  Declared as such a cell is, left out of the fused-only
    metrics' lists, its traced run reads exactly the metrics that admit it."""
    name = "sphere3d.algebraic"
    bench = runner.load_benchmark()
    for m in bench["per_layer"]:
        if m["name"] in FUSED_ONLY:
            m["workloads"].remove(name)
    cell = runner.Cell(bench, name, {**REDUCED, "sampling": "structured"})
    make = cell.module.estimator

    def estimator(cfg, ls_type):
        est = make(cfg, ls_type)
        est.fused_family = None
        return est

    cell.module.estimator = estimator
    runs_and_reads(cell, card)
