"""Port parity: ``lsqrrecipes_tpu_torch.ransac`` vs ``lsqrrecipes_tpu.ransac``,
the slice as a whole, and the port's import hygiene.

The engine is fed JAX's own sample indices / permutations (the two
frameworks' generators differ): float64 data gives the same best count and
hypothesis, and the refit on the same consensus agrees to rtol 1e-9.  The
drivers with the port's own generator pass the checks of the JAX package's
``test_engine_fused_driver``.
"""

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu.estimators import ALGEBRAIC as J_ALGEBRAIC
from lsqrrecipes_tpu.estimators import Line2DEstimator as JLine2D
from lsqrrecipes_tpu.estimators import LineEstimator as JLine
from lsqrrecipes_tpu.estimators import PlaneEstimator as JPlane
from lsqrrecipes_tpu.estimators import SphereEstimator as JSphere
from lsqrrecipes_tpu.linalg import LMConfig as JLMConfig
from lsqrrecipes_tpu.ransac import engine as jengine
from lsqrrecipes_tpu.ransac import sampling as jsampling
from lsqrrecipes_tpu_torch import interop
from lsqrrecipes_tpu_torch.estimators import (
    ALGEBRAIC,
    Line2DEstimator,
    LineEstimator,
    PlaneEstimator,
    SphereEstimator,
)
from lsqrrecipes_tpu_torch.ops import fused_sweep as fs
from lsqrrecipes_tpu_torch.ops import planar_points, sphere_lm, sphere_ransac, vote
from lsqrrecipes_tpu_torch.ransac import engine, sampling

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cloud(seed, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    n_in = n * 4 // 5
    d = rng.normal(size=(n_in, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inl = np.array([5.0, -2.0, 11.0]) + 25.0 * d + 0.3 * rng.normal(size=(n_in, 3))
    out = rng.uniform(-40.0, 40.0, size=(n - n_in, 3))
    return np.concatenate([inl, out]).astype(dtype)


def _ests(delta=1.0):
    return JSphere(delta, 3, J_ALGEBRAIC), SphereEstimator(delta, 3, ALGEBRAIC)


# ------------------------------------------------------------------ sampling


@pytest.mark.parametrize("n,k,groups", [(256, 4, 3), (1000, 4, 8), (64, 3, 5)])
def test_structured_shift_table_identical(n, k, groups):
    np.testing.assert_array_equal(
        sampling.structured_shift_table(n, k, groups),
        jsampling.structured_shift_table(n, k, groups),
    )


def test_structured_samples_identical_for_jax_permutation():
    pts = _cloud(1, 96)
    key = jax.random.PRNGKey(4)
    sj = jsampling.structured_samples(key, jnp.asarray(pts), 4, 3)
    perm = np.asarray(jax.random.permutation(key, 96))
    st = sampling.structured_samples(None, torch.as_tensor(pts), 4, 3, perm=perm)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("exact", [True, False])
def test_samplers_shape_range_distinct(exact):
    gen = torch.Generator().manual_seed(0)
    draw = sampling.sample_k_subsets if exact else sampling.sample_k_with_replacement
    idx = draw(gen, 50, 4, 300)
    assert idx.shape == (300, 4) and idx.dtype == torch.int64
    assert int(idx.min()) >= 0 and int(idx.max()) < 50
    if exact:
        assert all(len(set(row)) == 4 for row in idx.tolist())
    again = draw(torch.Generator().manual_seed(0), 50, 4, 300)
    assert torch.equal(idx, again)


@pytest.mark.parametrize("args", [(0.99, 0.5, 4, 10**6), (0.999, 0.8, 3, 50), (0.99, 0.0, 4, 7)])
def test_num_tries_and_choose_match_jax(args):
    assert sampling.num_tries(*args) == jsampling.num_tries(*args)
    assert sampling.choose(args[3] // 1000 + 5, 4) == jsampling.choose(args[3] // 1000 + 5, 4)
    assert sampling.choose(3, 5) == jsampling.choose(3, 5)


# -------------------------------------------------------------------- engine


def test_hypothesize_and_vote_matches_jax_on_jax_indices():
    pts = _cloud(2, 256)
    jest, test = _ests()
    idx = np.array(jsampling.sample_k_subsets(jax.random.PRNGKey(1), 256, 4, 1024))
    cj, mj, pj = jengine.hypothesize_and_vote(jest, jnp.asarray(pts), jnp.asarray(idx))
    ct, mt, pt = engine.hypothesize_and_vote(test, torch.as_tensor(pts), torch.as_tensor(idx))
    assert int(ct) == int(cj)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-10)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    rj, vj = jengine.consensus_refit(jest, jnp.asarray(pts), mj)
    rt, vt = engine.consensus_refit(test, torch.as_tensor(pts), mt)
    assert bool(vt) == bool(vj)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-9)


def test_argmax_ties_go_to_lowest_index():
    pts = _cloud(3, 64)
    _, test = _ests()
    base = np.asarray(jsampling.sample_k_subsets(jax.random.PRNGKey(2), 64, 4, 8))
    idx = np.concatenate([base, base])          # every count appears twice
    counts = test.vote_counts(test.minimal_fit(torch.as_tensor(pts)[torch.as_tensor(idx)])[0],
                              torch.as_tensor(pts))
    ct, _, pt = engine.hypothesize_and_vote(test, torch.as_tensor(pts), torch.as_tensor(idx))
    first = int(torch.argmax(counts))
    assert first < 8 and int(ct) == int(counts[first])


def test_structured_vote_matches_jax_on_jax_permutation():
    pts = _cloud(4, 128)
    jest, test = _ests()
    key = jax.random.PRNGKey(6)
    cj, mj, pj = jengine.hypothesize_and_vote_structured(jest, jnp.asarray(pts), key, 2)
    perm = np.asarray(jax.random.permutation(key, 128))
    ct, mt, pt = engine.hypothesize_and_vote_structured(test, torch.as_tensor(pts), None, 2, perm=perm)
    assert int(ct) == int(cj)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-10)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


# ------------------------------------------------------ the slice as a whole


DRIVERS = {
    "fused_sweep": lambda est, pts, gen: engine.ransac_fused_sweep(est, pts, gen, 1024, device="cpu"),
    "gather": lambda est, pts, gen: engine.ransac(est, pts, gen, 1024, device="cpu"),
    "structured": lambda est, pts, gen: engine.ransac_structured(est, pts, gen, 1024, device="cpu"),
    "fused_gps_subsample": lambda est, pts, gen: engine.ransac_fused_sweep(
        est, pts, gen, 1024, groups_per_step=4, vote_subsample=128, device="cpu"),
}


@pytest.mark.parametrize("driver", sorted(DRIVERS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_driver_recovers_sphere(driver, dtype):
    pts = _cloud(11, 256, dtype)
    est = SphereEstimator(1.0, 3, ALGEBRAIC)
    result = DRIVERS[driver](est, pts, torch.Generator().manual_seed(1))
    assert bool(result.valid)
    assert float(result.inlier_fraction) > 0.6
    refit_inliers = int(est.agree(result.params, torch.as_tensor(pts)).sum())
    assert refit_inliers >= int(0.9 * float(result.best_count))
    assert result.params.dtype == torch.from_numpy(pts).dtype
    assert np.abs(result.params.double().numpy() - [5.0, -2.0, 11.0, 25.0]).max() < 0.3


def test_fused_driver_falls_back_for_large_clouds():
    pts = _cloud(12, 4200, np.float32)
    est = SphereEstimator(1.0, 3, ALGEBRAIC)
    result = engine.ransac_fused_sweep(est, pts, torch.Generator().manual_seed(2), 4200, device="cpu")
    assert bool(result.valid) and float(result.inlier_fraction) > 0.6


def test_too_few_points_is_invalid():
    est = SphereEstimator(1.0, 3, ALGEBRAIC)
    result = engine.ransac(est, np.zeros((3, 3)), None, 64, device="cpu")
    assert not bool(result.valid) and int(result.best_count) == -1


# ------------------------------------------- the GEOMETRIC sphere refit


def _inlier_mask(pts, delta=1.0):
    d = np.abs(np.linalg.norm(pts - [5.0, -2.0, 11.0], axis=1) - 25.0)
    return d < delta


@pytest.mark.parametrize("masked", [False, True])
def test_geometric_lsq_fit_matches_jax(masked):
    pts = _cloud(13, 128)
    mask = _inlier_mask(pts) if masked else None
    pj, vj = JSphere(1.0, 3).lsq_fit(jnp.asarray(pts), None if mask is None else jnp.asarray(mask))
    est = SphereEstimator(1.0, 3)
    assert est.ls_type == "geometric" and est.lm_config.max_iters == 500
    pt, vt = est.lsq_fit(torch.as_tensor(pts), None if mask is None else torch.as_tensor(mask))
    assert bool(vt) == bool(vj) and bool(vt)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-8, atol=1e-8)
    # The refit beats the algebraic start on the geometric cost.
    alg, _ = SphereEstimator(1.0, 3, ALGEBRAIC).lsq_fit(
        torch.as_tensor(pts), None if mask is None else torch.as_tensor(mask))
    keep = slice(None) if mask is None else torch.as_tensor(mask)
    geo_cost = (est.distance_statistics(pt, torch.as_tensor(pts))[0][keep] ** 2).sum()
    alg_cost = (est.distance_statistics(alg, torch.as_tensor(pts))[0][keep] ** 2).sum()
    assert float(geo_cost) <= float(alg_cost)


def test_geometric_lsq_fit_invalid_start_keeps_algebraic_params():
    # Three points: too few for the algebraic fit, so the refit is invalid
    # and returns the start, as the JAX package does.
    pts = _cloud(14, 128)[:3]
    pj, vj = JSphere(1.0, 3).lsq_fit(jnp.asarray(pts))
    pt, vt = SphereEstimator(1.0, 3).lsq_fit(torch.as_tensor(pts))
    assert not bool(vt) and not bool(vj)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-8, atol=1e-8)


def test_distance_statistics_matches_jax():
    pts = _cloud(15, 96)
    params = np.array([5.1, -2.2, 10.9, 24.8])
    want = JSphere(1.0, 3).distance_statistics(jnp.asarray(params), jnp.asarray(pts))
    got = SphereEstimator(1.0, 3).distance_statistics(torch.as_tensor(params), torch.as_tensor(pts))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


def test_geometric_ransac_matches_jax_on_jax_indices(monkeypatch):
    pts = _cloud(16, 200)
    key = jax.random.PRNGKey(17)
    rj = jengine.ransac(JSphere(1.0, 3), jnp.asarray(pts), key, num_hypotheses=1024)
    monkeypatch.setattr(engine, "_sample", lambda gen, n, k, b, sampler="auto", device="cpu":
                        torch.as_tensor(np.array(jengine._sample(key, n, k, b, sampler)),
                                        dtype=torch.int64))
    rt = engine.ransac(SphereEstimator(1.0, 3), pts, None, num_hypotheses=1024, device="cpu")
    assert int(rt.best_count) == int(rj.best_count) and bool(rt.valid) == bool(rj.valid)
    np.testing.assert_array_equal(rt.consensus.numpy(), np.asarray(rj.consensus))
    np.testing.assert_allclose(rt.params.numpy(), np.asarray(rj.params), rtol=1e-8, atol=1e-8)


def test_geometric_structured_matches_jax_on_jax_permutation(monkeypatch):
    pts = _cloud(18, 160)
    key = jax.random.PRNGKey(19)
    rj = jengine.ransac_structured(JSphere(1.0, 3), jnp.asarray(pts), key, num_hypotheses=480)
    perm = np.asarray(jax.random.permutation(key, 160)).copy()
    real = sampling.structured_samples
    monkeypatch.setattr(engine, "structured_samples",
                        lambda gen, data, k, groups, perm_=None: real(gen, data, k, groups, perm))
    rt = engine.ransac_structured(SphereEstimator(1.0, 3), pts, None, num_hypotheses=480,
                                  device="cpu")
    assert int(rt.best_count) == int(rj.best_count) and bool(rt.valid) and bool(rj.valid)
    np.testing.assert_array_equal(rt.consensus.numpy(), np.asarray(rj.consensus))
    np.testing.assert_allclose(rt.params.numpy(), np.asarray(rj.params), rtol=1e-8, atol=1e-8)


GEOMETRIC_DRIVERS = dict(DRIVERS, adaptive=lambda est, pts, gen: engine.ransac_adaptive(
    est, pts, gen, batch_size=512, device="cpu"))


@pytest.mark.parametrize("driver", sorted(GEOMETRIC_DRIVERS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_geometric_driver_recovers_sphere(driver, dtype):
    pts = _cloud(20, 256, dtype)
    est = SphereEstimator(1.0, 3)
    result = GEOMETRIC_DRIVERS[driver](est, pts, torch.Generator().manual_seed(2))
    assert bool(result.valid) and float(result.inlier_fraction) > 0.6
    assert result.params.dtype == torch.from_numpy(pts).dtype
    assert np.abs(result.params.double().numpy() - [5.0, -2.0, 11.0, 25.0]).max() < 0.3
    # The same consensus refit by the algebraic fit lies no closer to it.
    mask = result.consensus
    alg, _ = SphereEstimator(1.0, 3, ALGEBRAIC).lsq_fit(torch.as_tensor(pts), mask)
    geo_res = est.distance_statistics(result.params, torch.as_tensor(pts))[0][mask]
    alg_res = est.distance_statistics(alg, torch.as_tensor(pts))[0][mask]
    assert float((geo_res.double() ** 2).sum()) <= float((alg_res.double() ** 2).sum()) * (1 + 1e-5)


def test_interop_carries_lm_config():
    jest = JSphere(2.0, 3, lm_config=JLMConfig(max_iters=77, gtol=1e-9))
    est = interop.sphere_estimator_from_attrs(jest)
    assert est.ls_type == "geometric" and est.lm_config.max_iters == 77
    assert est.lm_config.gtol == 1e-9
    assert interop.estimator_from_attrs(jest).lm_config == est.lm_config


# ------------------------------------------------------------ the fleet


def _fleet(seed, num, n, dtype=np.float64):
    return np.stack([_cloud(seed + d, n, dtype) for d in range(num)])


@pytest.mark.parametrize("ls_type", ["geometric", "algebraic"])
def test_ransac_batched_matches_jax_fleet(ls_type):
    data = _fleet(30, 3, 128)
    keys = jax.random.split(jax.random.PRNGKey(31), 3)
    rj = jengine.ransac_batched(JSphere(1.0, 3, ls_type), jnp.asarray(data), keys,
                                num_hypotheses=256)
    perms = np.stack([np.asarray(jax.random.permutation(k, 128)) for k in keys])
    rt = engine.ransac_batched(SphereEstimator(1.0, 3, ls_type), data, None, 256,
                               perms=perms, device="cpu")
    assert rt.params.shape == (3, 4) and rt.consensus.shape == (3, 128)
    np.testing.assert_array_equal(rt.best_count.numpy(), np.asarray(rj.best_count))
    np.testing.assert_array_equal(rt.consensus.numpy(), np.asarray(rj.consensus))
    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
    np.testing.assert_allclose(rt.params.numpy(), np.asarray(rj.params), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(rt.minimal_params.numpy(), np.asarray(rj.minimal_params),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(rt.inlier_fraction.numpy(), np.asarray(rj.inlier_fraction))


def test_ransac_batched_equals_per_dataset_structured():
    # f32 at groups * n = 512: each dataset's vote is the sphere vote path.
    data = _fleet(40, 4, 128, np.float32)
    gens = [torch.Generator().manual_seed(d) for d in range(4)]
    fleet = engine.ransac_batched(SphereEstimator(1.0, 3), data, gens, 512, device="cpu")
    for d in range(4):
        one = engine.ransac_structured(SphereEstimator(1.0, 3), data[d],
                                       torch.Generator().manual_seed(d), 512, device="cpu")
        assert int(fleet.best_count[d]) == int(one.best_count)
        assert torch.equal(fleet.consensus[d], one.consensus)
        assert bool(fleet.valid[d]) == bool(one.valid)
        assert torch.equal(fleet.params[d], one.params)
        assert torch.equal(fleet.minimal_params[d], one.minimal_params)
    assert fleet.inlier_fraction.dtype == torch.float64
    assert bool(fleet.valid.all()) and float(fleet.inlier_fraction.min()) > 0.6


def test_ransac_batched_rejects_bad_fleets():
    with pytest.raises(ValueError, match="generators"):
        engine.ransac_batched(SphereEstimator(1.0, 3), _fleet(50, 2, 64), [None], 64, device="cpu")
    with pytest.raises(ValueError, match="at least k"):
        engine.ransac_batched(SphereEstimator(1.0, 3), np.zeros((2, 3, 3)), None, 64, device="cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: numpy input legitimately goes to the card")
    est = SphereEstimator(1.0, 3, ALGEBRAIC)
    pts = _cloud(14, 128)
    for fn in (engine.ransac, engine.ransac_fused_sweep, engine.ransac_structured,
               engine.ransac_adaptive):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(est, pts, None, 256)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.ransac_exhaustive(Line2DEstimator(1.0), pts[:10, :2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.ransac_batched(est, np.stack([pts, pts]), None, 256)
    pts32 = pts.astype(np.float32)
    packed = vote.pack_points(torch.as_tensor(pts32))[:2]
    coords2 = np.zeros((12, 256), np.float32)
    calls = [
        lambda: sphere_lm.sphere_lm_batch(pts32[None], np.zeros((1, 4), np.float32)),
        lambda: sphere_lm.sphere_lm_batch_f64(pts[None], np.zeros((1, 4))),
        lambda: sphere_ransac.planar_sphere_samples(None, pts32, 2),
        lambda: sphere_ransac.sphere_fit_and_vote_planar(np.zeros((12, 8), np.float32), *packed, 1.0),
        lambda: sphere_ransac.megakernel_call(np.zeros((1, 4)), coords2, *packed, 1.0),
        lambda: sphere_ransac.fast_sphere_ransac_step(pts32, *packed, None, 2, 1.0),
        lambda: sphere_ransac.fast_sphere_ransac_sweep(pts32, *packed, None, 2, 2, 1.0),
        lambda: sphere_ransac.reference_mega_samples(pts32, None, 2),
        lambda: planar_points.sphere3d_planar_sweep(pts, None, 2, 1.0),
        lambda: planar_points.planar_samples_reference(pts, None, 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_interop_round_trip():
    jest, _ = _ests(2.5)
    est = interop.sphere_estimator_from_attrs(jest)
    assert (est.delta, est.dim, est.ls_type) == (2.5, 3, J_ALGEBRAIC)
    pts = interop.to_torch(_cloud(15, 128, np.float32), device="cpu")
    assert pts.dtype == torch.float32
    result = engine.ransac(est, pts, torch.Generator().manual_seed(3), 512)
    out = interop.result_to_numpy(result)
    assert isinstance(out.params, np.ndarray) and out.consensus.shape == (128,)
    assert out.consensus.dtype == np.bool_


# ------------------------------------- plane, line and 2D line end to end


def _structure(kind, seed, n):
    """The chip gate's data model at a small size: 80% inliers with
    N(0, 0.2) noise on the plane / 3D line / 2D line of
    ``scripts/chip_check.py``, 20% uniform outliers in [-40, 40]^d."""
    rng = np.random.default_rng(seed)
    n_in = n - n // 5
    if kind == "plane":
        e1 = np.array([1.0, 0.0, 0.5]) / np.sqrt(1.25)
        e2 = np.array([0.0, 1.0, -0.2]) / np.linalg.norm([0.0, 1.0, -0.2])
        uv = rng.uniform(-30, 30, (n_in, 2))
        inl = np.array([2.0, -1.0, 4.0]) + uv[:, :1] * e1 + uv[:, 1:] * e2
    elif kind == "line":
        u = np.array([0.6, -0.64, 0.48]) / np.linalg.norm([0.6, -0.64, 0.48])
        inl = np.array([1.0, 2.0, -3.0]) + rng.uniform(-40, 40, (n_in, 1)) * u
    else:
        inl = np.array([-2.0, 5.0]) + rng.uniform(-40, 40, (n_in, 1)) * np.array([0.8, 0.6])
    inl = inl + 0.2 * rng.normal(size=inl.shape)
    return np.concatenate([inl, rng.uniform(-40, 40, (n - n_in, inl.shape[1]))])


LINEAR = {  # kind: (JAX estimator, port estimator, sign-free leading params of the refit)
    "plane": (lambda: JPlane(1.0, 3), lambda: PlaneEstimator(1.0, 3), 3),
    "line": (lambda: JLine(1.0, 3), lambda: LineEstimator(1.0, 3), 3),
    "line2d": (lambda: JLine2D(1.0), lambda: Line2DEstimator(1.0), 0),
}


def _same_refit(got, want, n_signed):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if n_signed and np.dot(got[:n_signed], want[:n_signed]) < 0:
        got = np.concatenate([-got[:n_signed], got[n_signed:]])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def _same_result(rt, rj, n_signed):
    """Same best count, winning hypothesis and consensus; refit to 1e-9."""
    assert int(rt.best_count) == int(rj.best_count)
    assert bool(rt.valid) == bool(rj.valid)
    np.testing.assert_allclose(rt.minimal_params.numpy(), np.asarray(rj.minimal_params),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(rt.consensus.numpy(), np.asarray(rj.consensus))
    _same_refit(rt.params.numpy(), rj.params, n_signed)
    assert float(rt.inlier_fraction) == pytest.approx(float(rj.inlier_fraction))


@pytest.mark.parametrize("kind", sorted(LINEAR))
def test_hypothesize_and_vote_new_estimators_match_jax(kind):
    jmake, tmake, n_signed = LINEAR[kind]
    jest, test = jmake(), tmake()
    pts = _structure(kind, 40, 200)
    idx = np.array(jsampling.sample_k_subsets(jax.random.PRNGKey(41), 200, test.k, 700))
    cj, mj, pj = jengine.hypothesize_and_vote(jest, jnp.asarray(pts), jnp.asarray(idx))
    ct, mt, pt = engine.hypothesize_and_vote(test, torch.as_tensor(pts), torch.as_tensor(idx))
    assert int(ct) == int(cj) and int(ct) > 120
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    rj, vj = jengine.consensus_refit(jest, jnp.asarray(pts), mj)
    rt, vt = engine.consensus_refit(test, torch.as_tensor(pts), mt)
    assert bool(vt) == bool(vj)
    _same_refit(rt.numpy(), rj, n_signed)


def test_agree_fallback_chunks_without_changing_counts(monkeypatch):
    test = PlaneEstimator(1.0, 3)
    pts = torch.as_tensor(_structure("plane", 42, 150))
    idx = torch.as_tensor(np.array(jsampling.sample_k_subsets(jax.random.PRNGKey(43), 150, 3, 300)))
    params, valid = test.minimal_fit(pts[idx])
    whole = engine._vote(test, params, valid, pts)
    monkeypatch.setattr(engine, "_AGREE_CELLS", 11 * 150 * 3)       # 28 chunks
    chunked = engine._vote(test, params, valid, pts)
    assert torch.equal(chunked, whole)
    want = torch.where(valid, test.agree(params, pts).sum(-1), -1)
    assert torch.equal(whole, want)


@pytest.mark.parametrize("kind", sorted(LINEAR))
def test_structured_vote_new_estimators_match_jax(kind):
    jmake, tmake, _ = LINEAR[kind]
    jest, test = jmake(), tmake()
    pts = _structure(kind, 44, 128)
    key = jax.random.PRNGKey(45)
    cj, mj, pj = jengine.hypothesize_and_vote_structured(jest, jnp.asarray(pts), key, 2)
    perm = np.asarray(jax.random.permutation(key, 128))
    ct, mt, pt = engine.hypothesize_and_vote_structured(test, torch.as_tensor(pts), None, 2, perm=perm)
    assert int(ct) == int(cj)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def _jax_sample_feed(monkeypatch, key, sampler="auto"):
    """Make the port's ``_sample`` return, call by call, the indices the
    JAX engine draws from ``key`` (the adaptive driver splits it per round)."""
    state = {"key": key}

    def sample(generator, n, k, b, sampler_=sampler, device="cpu"):
        state["key"], sub = jax.random.split(state["key"])
        return torch.as_tensor(np.array(jengine._sample(sub, n, k, b, sampler_)), dtype=torch.int64)

    monkeypatch.setattr(engine, "_sample", sample)


def _jax_perm_feed(monkeypatch, key, per_round):
    """Make the port's slot-plane permutations those that JAX's fused sweep
    draws from ``key`` (split first when ``per_round``, as the adaptive
    driver does)."""
    state = {"key": key}

    def draw(n, k_slots, generator=None, device="cpu"):
        if per_round:
            state["key"], sub = jax.random.split(state["key"])
        else:
            sub = state["key"]
        keys = jax.random.split(sub, 4 * k_slots)
        return torch.as_tensor(np.stack([np.array(jax.random.permutation(keys[i], n))
                                         for i in range(4 * k_slots)]))

    monkeypatch.setattr(fs, "draw_slot_perms", draw)


def test_ransac_plane_matches_jax_on_jax_indices(monkeypatch):
    jmake, tmake, n_signed = LINEAR["plane"]
    pts = _structure("plane", 46, 200)
    key = jax.random.PRNGKey(47)
    rj = jengine.ransac(jmake(), jnp.asarray(pts), key, num_hypotheses=1024)
    state = {"done": False}

    def sample(generator, n, k, b, sampler="auto", device="cpu"):
        assert not state["done"]
        state["done"] = True
        return torch.as_tensor(np.array(jengine._sample(key, n, k, b, sampler)), dtype=torch.int64)

    monkeypatch.setattr(engine, "_sample", sample)
    rt = engine.ransac(tmake(), pts, None, num_hypotheses=1024, device="cpu")
    _same_result(rt, rj, n_signed)


def test_ransac_structured_line_matches_jax_on_jax_permutation(monkeypatch):
    jmake, tmake, n_signed = LINEAR["line"]
    pts = _structure("line", 48, 160)
    key = jax.random.PRNGKey(49)
    rj = jengine.ransac_structured(jmake(), jnp.asarray(pts), key, num_hypotheses=480)
    perm = np.asarray(jax.random.permutation(key, 160)).copy()
    real = sampling.structured_samples
    monkeypatch.setattr(engine, "structured_samples",
                        lambda gen, data, k, groups, perm_=None: real(gen, data, k, groups, perm))
    rt = engine.ransac_structured(tmake(), pts, None, num_hypotheses=480, device="cpu")
    _same_result(rt, rj, n_signed)


@pytest.mark.parametrize("kind", sorted(LINEAR))
def test_ransac_fused_sweep_new_families_match_jax(monkeypatch, kind):
    jmake, tmake, n_signed = LINEAR[kind]
    pts = _structure(kind, 50, 256).astype(np.float32)
    key = jax.random.PRNGKey(51)
    rj = jengine.ransac_fused_sweep(jmake(), jnp.asarray(pts), key, num_hypotheses=1536)
    _jax_perm_feed(monkeypatch, key, per_round=False)
    rt = engine.ransac_fused_sweep(tmake(), pts, None, num_hypotheses=1536, device="cpu")
    # f32 refit on the same consensus: float32 eigh/sums, not 1e-9.
    assert int(rt.best_count) == int(rj.best_count)
    np.testing.assert_array_equal(rt.consensus.numpy(), np.asarray(rj.consensus))
    np.testing.assert_allclose(rt.minimal_params.numpy(), np.asarray(rj.minimal_params),
                               rtol=1e-5, atol=1e-5)
    rt64, _ = engine.consensus_refit(tmake(), torch.as_tensor(pts, dtype=torch.float64), rt.consensus)
    rj64, _ = jengine.consensus_refit(jmake(), jnp.asarray(pts, jnp.float64), rj.consensus)
    _same_refit(rt64.numpy(), rj64, n_signed)


@pytest.mark.parametrize("path", ["auto", "gather"])
def test_ransac_adaptive_line2d_matches_jax(monkeypatch, path):
    jmake, tmake, n_signed = LINEAR["line2d"]
    dtype = np.float32 if path == "auto" else np.float64
    pts = _structure("line2d", 52, 256).astype(dtype)
    key = jax.random.PRNGKey(53)
    rj = jengine.ransac_adaptive(jmake(), jnp.asarray(pts), key, batch_size=512, path=path)
    if path == "auto":
        _jax_perm_feed(monkeypatch, key, per_round=True)
    else:
        _jax_sample_feed(monkeypatch, key)
    rt = engine.ransac_adaptive(tmake(), pts, None, batch_size=512, path=path, device="cpu")
    assert int(rt.best_count) == int(rj.best_count) > 150
    np.testing.assert_array_equal(rt.consensus.numpy(), np.asarray(rj.consensus))
    tol = dict(rtol=1e-9, atol=1e-9) if path == "gather" else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(rt.minimal_params.numpy(), np.asarray(rj.minimal_params), **tol)
    np.testing.assert_allclose(rt.params.numpy(), np.asarray(rj.params), **tol)


def test_ransac_adaptive_counts_rounds_like_jax(monkeypatch):
    # The budget update and the stop rule: the same number of rounds.
    jmake, tmake, _ = LINEAR["plane"]
    pts = _structure("plane", 54, 120)
    key = jax.random.PRNGKey(55)
    calls = {"jax": 0, "port": 0}
    real_j, real_t = jengine.hypothesize_and_vote, engine.hypothesize_and_vote

    def count_j(*a):
        calls["jax"] += 1
        return real_j(*a)

    def count_t(*a):
        calls["port"] += 1
        return real_t(*a)

    monkeypatch.setattr(jengine, "hypothesize_and_vote", count_j)
    monkeypatch.setattr(engine, "hypothesize_and_vote", count_t)
    _jax_sample_feed(monkeypatch, key)
    rj = jengine.ransac_adaptive(jmake(), jnp.asarray(pts), key, batch_size=64, path="gather",
                                 desired_probability=0.99)
    rt = engine.ransac_adaptive(tmake(), pts, None, batch_size=64, path="gather",
                                desired_probability=0.99, device="cpu")
    assert calls["port"] == calls["jax"] >= 1
    assert int(rt.best_count) == int(rj.best_count)


@pytest.mark.parametrize("kind", ["plane", "line2d"])
def test_ransac_exhaustive_matches_jax(kind):
    jmake, tmake, n_signed = LINEAR[kind]
    pts = _structure(kind, 56, 20)
    rj = jengine.ransac_exhaustive(jmake(), jnp.asarray(pts), batch_size=300)
    rt = engine.ransac_exhaustive(tmake(), pts, batch_size=300, device="cpu")
    _same_result(rt, rj, n_signed)
    assert int(rt.best_count) >= 14


def test_exhaustive_and_adaptive_reject_too_few_points():
    est = PlaneEstimator(1.0, 3)
    for result in (engine.ransac_exhaustive(est, np.zeros((2, 3)), device="cpu"),
                   engine.ransac_adaptive(est, np.zeros((2, 3)), None, device="cpu"),
                   engine.ransac_adaptive(est, np.ones((9, 3)), None, desired_probability=1.0,
                                          device="cpu")):
        assert not bool(result.valid) and int(result.best_count) == -1
        assert result.params.shape == (6,)


@pytest.mark.parametrize("kind", sorted(LINEAR))
@pytest.mark.parametrize("driver", ["fused_sweep", "gather", "structured", "adaptive"])
def test_driver_recovers_new_structures(kind, driver):
    _, tmake, _ = LINEAR[kind]
    est = tmake()
    pts = _structure(kind, 60, 256).astype(np.float32)
    gen = torch.Generator().manual_seed(3)
    if driver == "adaptive":
        result = engine.ransac_adaptive(est, pts, gen, batch_size=512, device="cpu")
    else:
        result = DRIVERS[driver](est, pts, gen)
    assert bool(result.valid) and float(result.inlier_fraction) > 0.7
    params = result.params.double().numpy()
    if kind == "plane":
        truth = np.cross([1.0, 0.0, 0.5], [0.0, 1.0, -0.2])
        anchor_err = abs(np.dot(params[3:] - [2.0, -1.0, 4.0], params[:3]))
    elif kind == "line":
        truth = np.array([0.6, -0.64, 0.48])
        v = params[3:] - [1.0, 2.0, -3.0]
        anchor_err = np.linalg.norm(v - np.dot(v, params[:3]) * params[:3])
    else:
        truth = np.array([-0.6, 0.8])
        anchor_err = abs(np.dot(params[2:] - [-2.0, 5.0], params[:2]))
    truth = truth / np.linalg.norm(truth)
    angle = np.arccos(min(1.0, abs(float(np.dot(params[: len(truth)], truth)))))
    assert angle < 0.01 and anchor_err < 0.1


def test_fused_rounds_launch_the_family_sweep(monkeypatch):
    seen = []
    real = fs.sweep

    def spy(family, *args):
        seen.append(family)
        return real(family, *args)

    monkeypatch.setattr(fs, "sweep", spy)
    engine.ransac_adaptive(Line2DEstimator(1.0), _structure("line2d", 61, 256), None,
                           batch_size=512, device="cpu")
    assert seen and set(seen) == {"line2d"}
    seen.clear()
    engine.ransac_adaptive(LineEstimator(1.0, 2), _structure("line2d", 62, 256), None,
                           batch_size=512, device="cpu")
    assert seen == []                       # no fused family: gathered rounds


# ------------------------------------------------------------------ hygiene


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "lsqrrecipes_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and ROOT / "lsqrrecipes_tpu_torch" / "ops" / "phantom_qr.py" in files
    assert ROOT / "lsqrrecipes_tpu_torch" / "examples" / "sphere_estimation.py" in files
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "lsqrrecipes_tpu"), f"{path}: imports {mod}"
    # Importing the phantom slice, the stats LM, the sharded drivers, the
    # checkpoints and the host layers (synthetic data, utils, io, viz, the
    # CLI and an example) in a fresh interpreter loads neither either.
    code = ("import sys\n"
            "import lsqrrecipes_tpu_torch.ops.phantom_qr, lsqrrecipes_tpu_torch.ops.us_fast\n"
            "import lsqrrecipes_tpu_torch.estimators, lsqrrecipes_tpu_torch.interop\n"
            "import lsqrrecipes_tpu_torch.linalg.stats_lm, lsqrrecipes_tpu_torch.parallel\n"
            "import lsqrrecipes_tpu_torch.ransac.checkpoint\n"
            "import lsqrrecipes_tpu_torch.synthetic, lsqrrecipes_tpu_torch.utils\n"
            "import lsqrrecipes_tpu_torch.io, lsqrrecipes_tpu_torch.viz, lsqrrecipes_tpu_torch.cli\n"
            "import lsqrrecipes_tpu_torch.examples.fused_sweep_showcase\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lsqrrecipes_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


# Paths that exist only in the port, and JAX ``__all__`` names that the port
# exports under another name (the JAX timing helpers ``Timer`` and
# ``throughput`` became the port's ``profiling``, its own spans and counters).
PORT_ONLY = {"interop.py", "device.py", "tree.py", "kernels", "examples"}
RENAMED = {"pallas_available": "kernels_available", "Timer": "profiling",
           "throughput": "profiling"}


def _all_names(path):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return set(ast.literal_eval(node.value))
    return set()


def test_port_covers_every_module_and_export_of_the_jax_package():
    jax_root, port_root = ROOT / "lsqrrecipes_tpu", ROOT / "lsqrrecipes_tpu_torch"
    jax_mods = {p.relative_to(jax_root) for p in jax_root.rglob("*.py")}
    port_mods = {p.relative_to(port_root) for p in port_root.rglob("*.py")}
    assert len(jax_mods) > 40
    assert sorted(map(str, jax_mods - port_mods)) == []
    extra = {m.parts[0] for m in port_mods - jax_mods}
    assert extra == PORT_ONLY
    for mod in sorted(m for m in jax_mods if m.name == "__init__.py"):
        want = {RENAMED.get(name, name) for name in _all_names(jax_root / mod)}
        missing = want - _all_names(port_root / mod)
        assert not missing, f"{mod}: the port does not export {sorted(missing)}"
    from lsqrrecipes_tpu_torch import ops

    assert ops.kernels_available() == torch.cuda.is_available()
