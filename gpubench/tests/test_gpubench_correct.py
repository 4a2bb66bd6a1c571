"""The check that decides ``correct``: sound runs pass it, and the control
and each fault a cell can have fail it.

Every case drives a whole run of a cell (set-up, window, check) on the CPU
at a small size, through the program's plain versions, past the harness's
look for a card; the faults are planted in the program underneath.  The
``structured`` cases run two cells through ``ransac_structured`` and have
the check rebuild the structured sampling design, as a cell whose
estimator no fused kernel serves is run and checked.
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
STRUCTURED = {"entry": "lsqrrecipes_tpu_torch.ransac.engine.ransac_structured",
              "sampling": "structured"}
STRUCTURED_CELLS = ("sphere3d.algebraic", "crosswire.analytic")


def small_cell(name, structured=False):
    return runner.Cell(runner.load_benchmark(), name,
                       {**SMALL, **STRUCTURED} if structured else SMALL)


def run_small(cell, seed=SEED, seconds=0.3):
    return runner.run(cell, seed, seconds, False, "cpu", 0.0)


def cases(names):
    """Each name as the cell runs it, then the structured cases among them."""
    return ([pytest.param(n, False, id=n) for n in names]
            + [pytest.param(n, True, id=f"{n}-structured") for n in names
               if n in STRUCTURED_CELLS])


@pytest.fixture
def designs(monkeypatch):
    """The sampling designs the check rebuilds hypothesis sets in."""
    seen = []
    design = judge.design

    def recorded(sampling="fused"):
        seen.append(sampling)
        return design(sampling)

    monkeypatch.setattr(judge, "design", recorded)
    return seen


@pytest.mark.parametrize("name,structured", cases(CELLS))
def test_sound_run_is_correct(designs, name, structured):
    cell = small_cell(name, structured)
    result = run_small(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(designs) == {"structured" if structured else "fused"}


@pytest.mark.parametrize("name,structured", cases(CELLS))
def test_control_is_not_correct(designs, name, structured):
    """The reference in the precision below the configuration's, put in the
    program's place, fails at least one limit on each of three seeds."""
    cell = small_cell(name, structured)
    for seed in (11, 12, 13):
        got = runner.control_readings(cell, seed, 3, cell.cfg["control_dtype"], "cpu")
        assert any(got[k] > cell.limits[k] for k in judge.NUMBERS), got
    assert set(designs) == {cell.sampling}


@pytest.mark.parametrize("fault,name,structured", [
    pytest.param(f, *c.values, id=f"{f}-{c.id}") for f, (_, cells) in FAULTS.items()
    for c in cases(cells)])
def test_fault_is_not_correct(monkeypatch, fault, name, structured):
    cell = small_cell(name, structured)
    FAULTS[fault][0](monkeypatch.setattr, cell)
    result = run_small(cell)
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
