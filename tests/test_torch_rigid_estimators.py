"""Port parity: the dense linear system, pivot calibration, absolute
orientation and ray intersection estimators of ``lsqrrecipes_tpu_torch`` vs
``lsqrrecipes_tpu``, and the engine on their tree data.

The same float64 data, made with numpy from a seed, goes to both packages as
tensors and as JAX arrays (a ``Frame``, a ``Ray3D`` or a ``(first, second)``
pair).  Minimal fits, least-squares fits, sufficient statistics and
``agree`` agree to 1e-10, relative or absolute (Horn's quaternion up to
its sign, which neither eigensolver fixes).  The engine is fed JAX's own
sample indices and permutations, and gives the same best count, winner and
consensus.  ``interop`` builds each estimator and its data from JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu import estimators as jest_mod
from lsqrrecipes_tpu import geometry as jgeo
from lsqrrecipes_tpu.estimators import dense_linear as jdense
from lsqrrecipes_tpu.ransac import engine as jengine
from lsqrrecipes_tpu.ransac import sampling as jsampling
from lsqrrecipes_tpu_torch import estimators as est_mod
from lsqrrecipes_tpu_torch import interop
from lsqrrecipes_tpu_torch.device import as_tensor
from lsqrrecipes_tpu_torch.geometry import Frame, Ray3D, rotations
from lsqrrecipes_tpu_torch.ransac import engine
from lsqrrecipes_tpu_torch.tree import tree_leaves

torch.set_num_threads(2)

TOL = 1e-10


def _rotations(rng, m):
    q = rng.normal(size=(m, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return rotations.matrix_from_quaternion(torch.as_tensor(q)).numpy()


def make_data(kind, seed, n):
    """numpy data of the JAX tests' models: 80% inliers, 20% outliers."""
    rng = np.random.default_rng(seed)
    n_in = n - n // 5
    if kind == "pivot_calibration":
        r = _rotations(rng, n)
        t = np.array([100.0, 50.0, -30.0]) - r @ np.array([10.0, -5.0, 2.0])
        t += 0.05 * rng.normal(size=t.shape)
        t[n_in:] = rng.uniform(-200, 200, (n - n_in, 3))
        return ("frame", r, t)
    if kind == "absolute_orientation":
        first = rng.uniform(-100, 100, (n, 3))
        second = first @ _rotations(rng, 1)[0].T + np.array([12.0, -7.0, 30.0])
        second += 0.1 * rng.normal(size=second.shape)
        second[n_in:] = rng.uniform(-100, 100, (n - n_in, 3))
        return ("pair", first, second)
    if kind == "ray_intersection":
        p = rng.uniform(-100, 100, (n, 3))
        d = np.array([20.0, -10.0, 35.0]) + 0.1 * rng.normal(size=(n, 3)) - p
        d[n_in:] = rng.normal(size=(n - n_in, 3))
        return ("ray", p, d / np.linalg.norm(d, axis=1, keepdims=True))
    width = int(kind.split("_")[-1])                     # "dense_linear_<n>"
    a = rng.uniform(-10, 10, (n, width))
    b = a @ np.linspace(-2.0, 3.0, width) + 0.05 * rng.normal(size=n)
    b[n_in:] += rng.uniform(5, 50, n - n_in)
    return ("rows", np.concatenate([a, b[:, None]], axis=1))


def to_torch(data):
    kind, *arrays = data
    arrays = [torch.as_tensor(a) for a in arrays]
    return {"frame": lambda: Frame(*arrays), "pair": lambda: tuple(arrays),
            "ray": lambda: Ray3D(*arrays), "rows": lambda: arrays[0]}[kind]()


def to_jax(data):
    kind, *arrays = data
    arrays = [jnp.asarray(a) for a in arrays]
    return {"frame": lambda: jgeo.Frame(*arrays), "pair": lambda: tuple(arrays),
            "ray": lambda: jgeo.Ray3D(*arrays), "rows": lambda: arrays[0]}[kind]()


ESTIMATORS = {  # kind: (JAX estimator, port estimator)
    "pivot_calibration": (lambda: jest_mod.PivotCalibrationEstimator(1.0),
                          lambda: est_mod.PivotCalibrationEstimator(1.0)),
    "absolute_orientation": (lambda: jest_mod.AbsoluteOrientationEstimator(1.0),
                             lambda: est_mod.AbsoluteOrientationEstimator(1.0)),
    "ray_intersection": (lambda: jest_mod.RayIntersectionEstimator(1.0, 0.05),
                         lambda: est_mod.RayIntersectionEstimator(1.0, 0.05)),
    "dense_linear_6": (lambda: jest_mod.DenseLinearSystemEstimator(1.0, 6),
                       lambda: est_mod.DenseLinearSystemEstimator(1.0, 6)),
    "dense_linear_3": (lambda: jest_mod.DenseLinearSystemEstimator(1.0, 3),
                       lambda: est_mod.DenseLinearSystemEstimator(1.0, 3)),
}
KINDS = sorted(ESTIMATORS)


def _gather_np(data, idx):
    kind, *arrays = data
    return (kind, *(a[idx] for a in arrays))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _same_params(kind, got, want, tol=TOL):
    """Params equal, a quaternion up to its sign."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if kind == "absolute_orientation":
        sign = np.sign(np.sum(got[..., :4] * want[..., :4], axis=-1, keepdims=True))
        got = np.concatenate([got[..., :4] * sign, got[..., 4:]], axis=-1)
    _close(got, want, tol)


def test_registry_names_and_sizes():
    for name in ("dense_linear", "pivot_calibration", "absolute_orientation", "ray_intersection"):
        assert name in est_mod.names()
        assert est_mod.get(name).registry_name == name
    assert est_mod.DenseLinearSystemEstimator(1.0, 6).fused_family == "dense_linear6"
    assert est_mod.DenseLinearSystemEstimator(1.0, 4).fused_family is None
    for kind in KINDS:
        jest, test = (make() for make in ESTIMATORS[kind])
        assert (test.k, test.nparams) == (jest.k, jest.nparams)
        assert getattr(test, "fused_family", None) == getattr(jest, "fused_family", None)


def test_ray_gate_is_the_jax_estimators():
    jest, test = (make() for make in ESTIMATORS["ray_intersection"])
    assert test.cross_eps == jest.cross_eps
    assert test.fused_delta == jest.fused_delta
    same = est_mod.RayIntersectionEstimator(1.0, cross_eps=jest.cross_eps)
    assert same.fused_delta == jest.fused_delta
    with pytest.raises(ValueError):
        est_mod.RayIntersectionEstimator(1.0)


@pytest.mark.parametrize("kind", KINDS)
def test_minimal_fit_matches_jax(kind):
    jest, test = (make() for make in ESTIMATORS[kind])
    data = make_data(kind, 1, 64)
    idx = np.array(jsampling.sample_k_subsets(jax.random.PRNGKey(2), 64, test.k, 200))
    samples = _gather_np(data, idx)
    pj, vj = jax.vmap(jest.minimal_fit)(to_jax(samples))
    pt, vt = test.minimal_fit(to_torch(samples))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert bool(vt.all()) or kind == "ray_intersection"
    _close(pt.numpy(), pj)


@pytest.mark.parametrize("kind", ["pivot_calibration", "absolute_orientation"])
def test_minimal_fit_flags_degenerate_samples(kind):
    jest, test = (make() for make in ESTIMATORS[kind])
    data = make_data(kind, 3, 8)
    idx = np.array([[0, 0, 0], [0, 1, 2]])     # one repeated observation, one proper
    samples = _gather_np(data, idx)
    _, vj = jax.vmap(jest.minimal_fit)(to_jax(samples))
    _, vt = test.minimal_fit(to_torch(samples))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert vt.tolist() == [False, True]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_lsq_fit_and_stats_match_jax(kind, masked):
    jest, test = (make() for make in ESTIMATORS[kind])
    data = make_data(kind, 4, 100)
    mask = (np.arange(100) < 80) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.as_tensor(mask)
    pj, vj = jest.lsq_fit(to_jax(data), jm)
    pt, vt = test.lsq_fit(to_torch(data), tm)
    assert bool(vt) == bool(vj) is True
    _same_params(kind, pt.numpy(), pj)
    sj = jest.lsq_stats(to_jax(data), jm)
    st = test.lsq_stats(to_torch(data), tm)
    for got, want in zip(st, sj):
        _close(got.numpy(), want, 1e-9)
    ps, vs = test.lsq_solve_stats(st)
    assert bool(vs)
    _same_params(kind, ps.numpy(), pt.numpy() if kind != "dense_linear_6" else pj, 1e-8)


@pytest.mark.parametrize("kind", KINDS)
def test_agree_matches_jax_batched(kind):
    jest, test = (make() for make in ESTIMATORS[kind])
    data = make_data(kind, 5, 100)
    params, _ = jest.lsq_fit(to_jax(data), jnp.asarray(np.arange(100) < 80))
    rng = np.random.default_rng(6)
    batch = np.asarray(params) + rng.normal(0, 0.3, (16, len(params)))
    batch[0] = np.asarray(params)
    want = jax.vmap(lambda p: jest.agree(p, to_jax(data)))(jnp.asarray(batch))
    got = test.agree(torch.as_tensor(batch), to_torch(data))
    assert got.shape == (16, 100)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 60 < int(got[0].sum()) < 100


@pytest.mark.parametrize("kind", KINDS)
def test_hypothesize_and_vote_on_jax_indices(kind):
    jest, test = (make() for make in ESTIMATORS[kind])
    data = make_data(kind, 7, 128)
    idx = np.array(jsampling.sample_k_subsets(jax.random.PRNGKey(8), 128, test.k, 300))
    cj, mj, pj = jengine.hypothesize_and_vote(jest, to_jax(data), jnp.asarray(idx))
    ct, mt, pt = engine.hypothesize_and_vote(test, to_torch(data), torch.as_tensor(idx))
    assert int(ct) == int(cj) and int(ct) > 80
    _close(pt.numpy(), pj)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    rj, vj = jengine.consensus_refit(jest, to_jax(data), mj)
    rt, vt = engine.consensus_refit(test, to_torch(data), mt)
    assert bool(vt) == bool(vj)
    _same_params(kind, rt.numpy(), rj)


@pytest.mark.parametrize("kind", KINDS)
def test_structured_vote_on_jax_permutation(kind):
    jest, test = (make() for make in ESTIMATORS[kind])
    data = make_data(kind, 9, 128)
    key = jax.random.PRNGKey(10)
    cj, mj, pj = jengine.hypothesize_and_vote_structured(jest, to_jax(data), key, 2)
    perm = np.asarray(jax.random.permutation(key, 128))
    ct, mt, pt = engine.hypothesize_and_vote_structured(test, to_torch(data), None, 2, perm=perm)
    assert int(ct) == int(cj)
    _close(pt.numpy(), pj)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


@pytest.mark.parametrize("kind", ["pivot_calibration", "ray_intersection"])
def test_ransac_on_jax_indices(kind, monkeypatch):
    jest, test = (make() for make in ESTIMATORS[kind])
    data = make_data(kind, 11, 150)
    key = jax.random.PRNGKey(12)
    rj = jengine.ransac(jest, to_jax(data), key, num_hypotheses=512)

    def sample(generator, n, k, b, sampler="auto", device="cpu"):
        return torch.as_tensor(np.array(jengine._sample(key, n, k, b, sampler)), dtype=torch.int64)

    monkeypatch.setattr(engine, "_sample", sample)
    rt = engine.ransac(test, to_torch(data), None, num_hypotheses=512, device="cpu")
    assert int(rt.best_count) == int(rj.best_count) and bool(rt.valid) == bool(rj.valid)
    np.testing.assert_array_equal(rt.consensus.numpy(), np.asarray(rj.consensus))
    _close(rt.minimal_params.numpy(), rj.minimal_params)
    _same_params(kind, rt.params.numpy(), rj.params)


def test_dense_linear_generic_width_runs_the_structured_path():
    # n = 3 has no fused sweep: ransac_fused_sweep falls back to the
    # structured sweep on the port's own permutation and recovers x.
    test = est_mod.DenseLinearSystemEstimator(1.0, 3)
    rows = to_torch(make_data("dense_linear_3", 13, 200))
    res = engine.ransac_fused_sweep(test, rows, torch.Generator().manual_seed(0),
                                    num_hypotheses=1000)
    assert bool(res.valid) and float(res.inlier_fraction) > 0.75
    _close(res.params.numpy(), np.linspace(-2.0, 3.0, 3), 0.05)


def test_invalid_result_follows_the_data():
    frames = Frame(torch.zeros((2, 3, 3), dtype=torch.float64), torch.zeros((2, 3), dtype=torch.float64))
    res = engine.ransac(est_mod.PivotCalibrationEstimator(1.0), frames, None)
    assert not bool(res.valid) and int(res.best_count) == -1
    assert res.params.dtype == torch.float64 and res.consensus.shape == (2,)
    res = engine.ransac_fused_sweep(est_mod.AbsoluteOrientationEstimator(1.0),
                                    (torch.zeros((1, 3)), torch.zeros((1, 3))), None)
    assert res.params.dtype == torch.float32 and res.minimal_params.shape == (7,)


def test_augmented_rows_matches_jax():
    rng = np.random.default_rng(14)
    a, b = rng.normal(size=(10, 6)), rng.normal(size=10)
    got = est_mod.augmented_rows(a, b, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdense.augmented_rows(a, b)))
    with pytest.raises(ValueError):
        est_mod.augmented_rows(a, b[:5], device="cpu")


def test_tree_data_goes_to_one_device():
    data = as_tensor(Frame(np.zeros((4, 3, 3)), np.zeros((4, 3))), "cpu", torch.float32)
    assert isinstance(data, Frame) and data.r.dtype == torch.float32
    pair = as_tensor((np.zeros((4, 3)), torch.ones((4, 3))), "cpu")
    assert isinstance(pair, tuple) and all(isinstance(x, torch.Tensor) for x in pair)


@pytest.mark.parametrize("kind", KINDS)
def test_interop_builds_the_estimator_and_its_data(kind):
    jest, test = (make() for make in ESTIMATORS[kind])
    got = interop.estimator_from_attrs(jest)
    assert type(got) is type(test)
    assert (got.delta, got.k, got.nparams) == (jest.delta, jest.k, jest.nparams)
    assert getattr(got, "fused_family", None) == getattr(jest, "fused_family", None)
    if kind == "ray_intersection":
        assert got.cross_eps == jest.cross_eps and got.fused_delta == jest.fused_delta
    data = make_data(kind, 15, 40)
    tdata = interop.data_to_torch(to_jax(data), device="cpu")
    want = to_torch(data)
    assert type(tdata) is type(want)
    for a, b in zip(tree_leaves(tdata), tree_leaves(want)):
        assert torch.equal(a, b)
    # The same estimator on the same data: the same least-squares fit.
    _same_params(kind, got.lsq_fit(tdata)[0].numpy(), jest.lsq_fit(to_jax(data))[0])


@pytest.mark.parametrize("kind", ["absolute_orientation", "ray_intersection"])
def test_exhaustive_matches_jax_and_adaptive_recovers(kind):
    # Exhaustive enumeration is deterministic: both packages evaluate every
    # C(n, k) subset of the same tree data in the same order.
    jest, test = (make() for make in ESTIMATORS[kind])
    data = make_data(kind, 16, 14)
    rj = jengine.ransac_exhaustive(jest, to_jax(data), batch_size=64)
    rt = engine.ransac_exhaustive(test, to_torch(data), batch_size=64, device="cpu")
    assert int(rt.best_count) == int(rj.best_count)
    np.testing.assert_array_equal(rt.consensus.numpy(), np.asarray(rj.consensus))
    _close(rt.minimal_params.numpy(), rj.minimal_params)
    _same_params(kind, rt.params.numpy(), rj.params)
    # The adaptive driver's fused rounds on the same kind of data.
    big = to_torch(make_data(kind, 17, 256))
    res = engine.ransac_adaptive(test, big, torch.Generator().manual_seed(5))
    assert bool(res.valid) and float(res.inlier_fraction) > 0.75
