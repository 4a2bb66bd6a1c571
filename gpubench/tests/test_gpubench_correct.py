"""The check that decides ``correct``: sound runs pass it, and the control
and each fault a cell can have fail it.

Every case drives a whole run of a cell (set-up, window, check) on the CPU
at a small size, through the program's plain versions, past the harness's
look for a card; the faults are planted in the program underneath.
"""

import math

import pytest
import torch

from gpubench.lib import runner
from gpubench.lib.faults import ALL_CELLS as CELLS, FAULTS
from gpubench.lib.window import derive_seed, POOL, WINDOW
from gpubench.reference import judge

SMALL = {"hypotheses": 1024, "data": {"n": 128},
         "traffic": {"pool": 2, "warmup_fits": 1, "check_fits": 3, "trace_fits": 2}}
SEED = 2**31 + 977


def small_cell(name):
    return runner.Cell(runner.load_benchmark(), name, SMALL)


def run_small(name, seed=SEED, seconds=0.3):
    return runner.run(small_cell(name), seed, seconds, False, "cpu", 0.0)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = run_small(name)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in the precision below the configuration's, put in the
    program's place, fails at least one limit on each of three seeds."""
    cell = small_cell(name)
    for seed in (11, 12, 13):
        got = runner.control_readings(cell, seed, 3, cell.cfg["control_dtype"], "cpu")
        assert any(got[k] > cell.limits[k] for k in judge.NUMBERS), got


@pytest.mark.parametrize("fault,name", [(f, c) for f, (_, cells) in FAULTS.items() for c in cells])
def test_fault_is_not_correct(monkeypatch, fault, name):
    FAULTS[fault][0](monkeypatch.setattr)
    result = run_small(name)
    assert not result["correct"], result["checks"]


def test_limits_sit_between_their_readings():
    """Every limit is finite and positive or 0, and each cell's control
    reading (tested above) lies above it; here: the limits files name
    exactly the compared numbers."""
    for name in CELLS:
        limits = small_cell(name).limits
        assert set(limits) == set(judge.NUMBERS)
        assert all(math.isfinite(v) and v >= 0 for v in limits.values())


def test_reference_rebuilds_the_seeded_pool_and_hypotheses():
    """The pool and each fit's generator come from the run's seed alone."""
    cell = small_cell("sphere3d.algebraic")
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(derive_seed(SEED, POOL, 0))
    g2.manual_seed(derive_seed(SEED, POOL, 0))
    a = cell.module.make_pool(cell.cfg, 2, g1, torch.device("cpu"))
    b = cell.module.make_pool(cell.cfg, 2, g2, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert derive_seed(SEED, WINDOW, 3) != derive_seed(SEED, WINDOW, 4)
