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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu.estimators import ALGEBRAIC as J_ALGEBRAIC
from lsqrrecipes_tpu.estimators import SphereEstimator as JSphere
from lsqrrecipes_tpu.ransac import engine as jengine
from lsqrrecipes_tpu.ransac import sampling as jsampling
from lsqrrecipes_tpu_torch import interop
from lsqrrecipes_tpu_torch.estimators import ALGEBRAIC, SphereEstimator
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


def test_geometric_refit_not_ported_raises():
    est = SphereEstimator(1.0, 3)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        engine.ransac(est, _cloud(13, 128), torch.Generator().manual_seed(0), 256, device="cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: numpy input legitimately goes to the card")
    est = SphereEstimator(1.0, 3, ALGEBRAIC)
    pts = _cloud(14, 128)
    for fn in (engine.ransac, engine.ransac_fused_sweep, engine.ransac_structured):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(est, pts, None, 256)


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
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "lsqrrecipes_tpu"), f"{path}: imports {mod}"
