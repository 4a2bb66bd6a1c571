"""Whole runs on the card at a reduced size: the check passes, the traced
run reads every per-layer metric and a breakdown.  Run on the card with

    python -m pytest gpubench/tests -m cuda
"""

import pytest
import torch

from gpubench.lib import runner

CELLS = ("sphere3d.geometric", "crosswire.iterative", "sphere3d.algebraic", "crosswire.analytic")
REDUCED = {"hypotheses": 65536, "traffic": {"pool": 2, "warmup_fits": 1, "check_fits": 2,
                                            "trace_fits": 2}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(card, name):
    bench = runner.load_benchmark()
    cell = runner.Cell(bench, name, REDUCED)
    plain = runner.run(cell, 2**31 + 5, 0.5, False, card, 0.0)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {m["name"] for m in cell.end_to_end}
    traced = runner.run(cell, 2**31 + 6, 0.5, True, card, 0.0)
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < traced["device"]["busy_s"] < traced["device"]["window_s"]
    assert traced["breakdown"]["device_ops"] and traced["breakdown"]["idle_gaps"]
