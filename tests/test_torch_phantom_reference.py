"""The plane phantom (k = 31) against the benchmark's plain reference,
``gpubench/reference/phantom.py``, on the CPU at n = 64 and 8 groups of the
structured sampling design, on data drawn by ``gpubench/configs/phantom.py``
(its model at the cell's shape, a small pool) from fixed seeds.

* minimal fits: the estimator's float64 ``minimal_fit`` on the hypothesis
  set that ``reference/sampling_structured.py`` rebuilds from the sweep's
  seed equals the reference's, validity included, to 1e-9 of ``max(|p|,
  1)`` (both are float64 SVD null vectors of the same 31 x 31 systems; they
  meet to ~4e-14);
* the fast path (``structured_sweep``: the float32 subspace, a float64
  Rayleigh-Ritz, a float32 vote) against the reference's float64 fits and
  votes: on hypotheses with a unique null direction (``s[29] >= 4 s[30]``)
  each count within 2 border points, the best counts equal, and the best
  hypotheses' params within 1e-4 up to the null vector's sign, which the
  fast path leaves as the subspace gives it (the winner is judged through
  ``agree`` alone);
* the winner's ``agree`` mask and count through ``ransac_fused_sweep``
  equal the reference's agreement with the winner;
* ANALYTIC and ITERATIVE refits of the consensus: within 1e-12 (two f64
  SVDs of the same rows) and 1e-8 (two Levenberg-Marquardt loops whose stop
  tests differ: they end 1e-15 to 7e-10 apart on these seeds) of the
  reference; the same refit of the data rounded to float32 lies 9e-8 or
  more away and fails those tolerances;
* the sign rule: ``R1_row3[2] >= 0`` in every refit, the minimal fit and the
  reference alike.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench.configs import phantom as config
from gpubench.reference import phantom as ref
from gpubench.reference import sampling_structured
from lsqrrecipes_tpu_torch.estimators.us_calibration import (
    ANALYTIC,
    ITERATIVE,
    PlanePhantomUSCalibrationEstimator,
)
from lsqrrecipes_tpu_torch.geometry import Frame
from lsqrrecipes_tpu_torch.ransac import ransac_fused_sweep

torch.set_num_threads(2)

CFG = json.loads((Path(__file__).resolve().parents[1] / "gpubench" / "configs"
                  / "phantom.json").read_text())
N, GROUPS, DELTA = 64, 8, CFG["delta"]
SEEDS = (2**31 + 77, 2**31 + 78, 2**31 + 79)
MINIMAL_TOL = 1e-9
REFIT_TOL = {ANALYTIC: 1e-12, ITERATIVE: 1e-8}
BORDER = 2
WINNER_TOL = 1e-4


@pytest.fixture(scope="module")
def pool():
    assert CFG["data"]["n"] == N
    g = torch.Generator().manual_seed(2**31 + 3)
    return config.make_pool(CFG, len(SEEDS), g, torch.device("cpu"))


def _indices(seed):
    return torch.cat(list(sampling_structured.hypothesis_indices(
        seed, N, ref.K, GROUPS * N, "cpu", 1 << 26)))


def _gap(p, q):
    return ((p - q).abs() / q.abs().clamp_min(1.0)).amax(dim=-1)


def _signed(params):
    """``params [..., 41]`` mirrored where ``R1_row3[2] < 0``: ``t1_z`` and
    the 30 derived entries change sign (the angles are left out of the
    comparison)."""
    flip = params[..., 40:41] < 0
    out = params.clone()
    out[..., 2:3] = torch.where(flip, -params[..., 2:3], params[..., 2:3])
    out[..., 11:41] = torch.where(flip, -params[..., 11:41], params[..., 11:41])
    return out


@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_minimal_fits_equal_the_reference_on_the_rebuilt_hypotheses(pool, i):
    data = pool[i]
    frames, q = config.program_data(data)
    idx = _indices(SEEDS[i])
    assert idx.shape == (GROUPS * N, ref.K)
    want, want_ok = ref.minimal_fit(ref.features(data)[idx])
    got, got_ok = PlanePhantomUSCalibrationEstimator(DELTA).minimal_fit(
        (Frame(frames.r[idx], frames.t[idx]), q[idx]))
    assert torch.equal(got_ok, want_ok) and bool(want_ok.any())
    assert float(_gap(got, want)[want_ok].max()) < MINIMAL_TOL
    assert bool((got[want_ok, 40] >= 0).all()) and bool((want[want_ok, 40] >= 0).all())


@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_fast_path_counts_and_winners_match_the_reference(pool, i):
    data = pool[i]
    idx = _indices(SEEDS[i])
    feats = ref.features(data)
    want, want_ok = ref.minimal_fit(feats[idx])
    want_counts = torch.where(want_ok, ref.vote_counts(want, data, DELTA), -1)
    est = PlanePhantomUSCalibrationEstimator(DELTA)
    counts, params = est.structured_sweep(config.program_data(data),
                                          torch.Generator().manual_seed(SEEDS[i]), GROUPS)
    s = torch.linalg.svdvals(feats[idx])
    unique = want_ok & (counts >= 0) & (s[:, 29] >= 4 * s[:, 30])
    assert int(unique.sum()) > GROUPS * N // 4
    assert int((counts - want_counts)[unique].abs().max()) <= BORDER
    assert int(counts.max()) == int(want_counts.max())
    best = want_counts == want_counts.max()
    assert float(_gap(_signed(params[best])[:, 2:], want[best][:, 2:]).max()) < WINNER_TOL


@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_the_winners_agreement_equals_the_reference(pool, i):
    data = pool[i]
    res = ransac_fused_sweep(PlanePhantomUSCalibrationEstimator(DELTA, ls_type=ANALYTIC),
                             config.program_data(data), torch.Generator().manual_seed(SEEDS[i]),
                             num_hypotheses=GROUPS * N)
    mask = ref.agree(res.minimal_params.double(), data, DELTA)
    assert torch.equal(res.consensus, mask)
    assert int(res.best_count) == int(mask.sum()) >= N - N // 10 - 2


def _consensus(data, i):
    res = ransac_fused_sweep(PlanePhantomUSCalibrationEstimator(DELTA, ls_type=ANALYTIC),
                             config.program_data(data), torch.Generator().manual_seed(SEEDS[i]),
                             num_hypotheses=GROUPS * N)
    return res.consensus


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ls_type", [ANALYTIC, ITERATIVE])
@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_refits_match_the_reference_and_a_float32_refit_does_not(pool, i, ls_type, dtype):
    data = pool[i]
    mask = _consensus(data, i)
    want, want_ok = ref.refit(data, mask, ls_type)
    frames, q = config.program_data(data)
    got, got_ok = PlanePhantomUSCalibrationEstimator(DELTA, ls_type=ls_type).lsq_fit(
        (Frame(frames.r.to(dtype), frames.t.to(dtype)), q.to(dtype)), mask)
    assert bool(got_ok) and want_ok
    gap = float(_gap(got.double(), want))
    if dtype == torch.float64:
        assert gap < REFIT_TOL[ls_type]
        assert float(got[40]) >= 0 and float(want[40]) >= 0
        truth = np.array(config.truth(CFG))
        assert np.abs(got[:11].numpy() - truth).max() < 1.0     # mm, rad, mm per pixel
    else:
        assert gap > REFIT_TOL[ls_type]


def test_the_reference_holds_its_refit_to_the_sign_rule():
    """A start whose plane is mirrored (``R1_row3[2] < 0``) ends mirrored
    back: the reference's LM result obeys the rule as the program's does."""
    x = torch.tensor([0.35, -0.6 + np.pi, 42.0, 1.0, 2.0, 3.0, 2.3, 0.5, 1.2, 0.14, 0.13],
                     dtype=torch.float64)
    y = ref._signed(x)
    assert float(torch.cos(y[0]) * torch.cos(y[1])) > 0
    assert torch.allclose(y[:3], torch.tensor([-0.35, -0.6, -42.0], dtype=torch.float64))
    assert torch.equal(y[3:], x[3:]) and torch.equal(ref._signed(y), y)
