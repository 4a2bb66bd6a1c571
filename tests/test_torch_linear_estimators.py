"""Port parity: the plane, kD line and 2D line estimators of
``lsqrrecipes_tpu_torch`` vs ``lsqrrecipes_tpu`` on the CPU, float64.

Same numpy inputs through both packages: ``minimal_fit`` params and
``valid`` to rtol 1e-12, ``agree`` masks exactly equal, ``lsq_fit`` on the
same mask to rtol 1e-9, ``Line2DEstimator.vote_counts`` exactly equal.  A
normal or direction that comes from ``eigh`` or an SVD is compared up to its
sign, which neither package fixes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu.estimators import Line2DEstimator as JLine2D
from lsqrrecipes_tpu.estimators import LineEstimator as JLine
from lsqrrecipes_tpu.estimators import PlaneEstimator as JPlane
from lsqrrecipes_tpu_torch import interop
from lsqrrecipes_tpu_torch.estimators import (
    Line2DEstimator,
    LineEstimator,
    PlaneEstimator,
    get,
    names,
)

torch.set_num_threads(2)

TOL = dict(rtol=1e-12, atol=1e-12)
REFIT_TOL = dict(rtol=1e-9, atol=1e-9)

# (name, JAX estimator, port estimator, dim)
ESTIMATORS = [
    ("line2d", lambda: JLine2D(1.5), lambda: Line2DEstimator(1.5), 2),
    ("line-2", lambda: JLine(1.5, 2), lambda: LineEstimator(1.5, 2), 2),
    ("line-3", lambda: JLine(1.5, 3), lambda: LineEstimator(1.5, 3), 3),
    ("line-4", lambda: JLine(1.5, 4), lambda: LineEstimator(1.5, 4), 4),
    ("plane-2", lambda: JPlane(1.5, 2), lambda: PlaneEstimator(1.5, 2), 2),
    ("plane-3", lambda: JPlane(1.5, 3), lambda: PlaneEstimator(1.5, 3), 3),
    ("plane-4", lambda: JPlane(1.5, 4), lambda: PlaneEstimator(1.5, 4), 4),
]
IDS = [e[0] for e in ESTIMATORS]


def _signed_part(name, dim, minimal):
    """How many leading components come from eigh or an SVD null vector
    (sign free): the kD line's refit, the plane's refit, and the plane's
    exact fit outside 3D."""
    if name == "line2d":
        return 0
    if name.startswith("line"):
        return 0 if minimal else dim
    return 0 if (minimal and dim == 3) else dim


def _assert_params(got, want, n_signed, **tol):
    got, want = np.atleast_2d(got), np.atleast_2d(want)
    if n_signed:
        dot = np.sum(got[:, :n_signed] * want[:, :n_signed], axis=-1, keepdims=True)
        got = got.copy()
        got[:, :n_signed] *= np.where(dot < 0, -1.0, 1.0)
    np.testing.assert_allclose(got, want, **tol)


def _structure(name, dim, seed, n=120):
    """80% points on a line (``line*``) or hyperplane (``plane*``) with
    sigma 0.3 noise + 20% uniform outliers in [-40, 40]^dim."""
    rng = np.random.default_rng(seed)
    n_in = n * 4 // 5
    anchor = rng.uniform(-10, 10, dim)
    if name.startswith("plane"):
        normal = rng.normal(size=dim)
        normal /= np.linalg.norm(normal)
        raw = rng.uniform(-30, 30, (n_in, dim))
        inl = raw - ((raw - anchor) @ normal)[:, None] * normal
    else:
        u = rng.normal(size=dim)
        u /= np.linalg.norm(u)
        inl = anchor + rng.uniform(-40, 40, (n_in, 1)) * u
    inl = inl + 0.3 * rng.normal(size=inl.shape)
    return np.concatenate([inl, rng.uniform(-40, 40, (n - n_in, dim))])


def _samples(est, dim, seed, b=200):
    """``[b, k, dim]`` minimal samples, uniform in [-30, 30]^dim."""
    return np.random.default_rng(seed).uniform(-30, 30, size=(b, est.k, dim))


@pytest.mark.parametrize("name,jmake,tmake,dim", ESTIMATORS, ids=IDS)
def test_minimal_fit_matches_jax(name, jmake, tmake, dim):
    jest, test = jmake(), tmake()
    s = _samples(test, dim, 40 + dim)
    exact_gate = not name.startswith("plane") or dim == 3
    if exact_gate:
        s[::4, -1] = s[::4, 0]                       # coincident points
        s[1::4, -1] = s[1::4, 0] + 0.5               # closer than delta
        if name == "plane-3":
            s[2::4, 2] = 2.0 * s[2::4, 1] - s[2::4, 0]   # collinear
    pj, vj = jest.minimal_fit(jnp.asarray(s))
    pt, vt = test.minimal_fit(torch.as_tensor(s))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    if exact_gate:
        assert not vt.numpy()[::4].any() and vt.numpy()[3::4].all()
    else:
        assert vt.numpy().all()
    ok = np.asarray(vj)
    _assert_params(pt.numpy()[ok], np.asarray(pj)[ok], _signed_part(name, dim, True), **TOL)


@pytest.mark.parametrize("name,jmake,tmake,dim", ESTIMATORS, ids=IDS)
def test_agree_matches_jax(name, jmake, tmake, dim):
    jest, test = jmake(), tmake()
    data = _structure(name, dim, 50 + dim)
    params = np.asarray(jest.minimal_fit(jnp.asarray(_samples(test, dim, 60 + dim, 64)))[0])
    good = np.asarray(jest.lsq_fit(jnp.asarray(data))[0])
    params = np.concatenate([params, good[None]])
    mj = np.asarray(jest.agree(jnp.asarray(params), jnp.asarray(data)))
    mt = test.agree(torch.as_tensor(params), torch.as_tensor(data)).numpy()
    np.testing.assert_array_equal(mt, mj)
    assert mt.shape == (65, data.shape[0])


@pytest.mark.parametrize("name,jmake,tmake,dim", ESTIMATORS, ids=IDS)
@pytest.mark.parametrize("masked", [False, True])
def test_lsq_fit_matches_jax(name, jmake, tmake, dim, masked):
    jest, test = jmake(), tmake()
    data = _structure(name, dim, 70 + dim)
    mask = None
    if masked:
        mask = np.zeros(data.shape[0], bool)
        mask[: data.shape[0] * 4 // 5] = True         # the structure's points
    pj, vj = jest.lsq_fit(jnp.asarray(data), None if mask is None else jnp.asarray(mask))
    pt, vt = test.lsq_fit(torch.as_tensor(data), None if mask is None else torch.as_tensor(mask))
    assert bool(vt) == bool(vj)
    _assert_params(pt.numpy(), np.asarray(pj), _signed_part(name, dim, False), **REFIT_TOL)


@pytest.mark.parametrize("name,jmake,tmake,dim", ESTIMATORS, ids=IDS)
def test_lsq_stats_compose_to_lsq_fit(name, jmake, tmake, dim):
    test = tmake()
    data = torch.as_tensor(_structure(name, dim, 80 + dim))
    mask = torch.arange(data.shape[0]) % 3 != 0
    assert test.has_stats
    direct = test.lsq_fit(data, mask)
    composed = test.lsq_solve_stats(test.lsq_stats(data, mask))
    assert torch.equal(direct[0], composed[0]) and bool(direct[1]) == bool(composed[1])


@pytest.mark.parametrize("case", ["vertical", "coincident", "too_few"])
def test_line2d_refit_branches_match_jax(case):
    if case == "vertical":
        data = np.stack([np.full(10, 7.0), np.linspace(0, 9, 10)], axis=1)
        mask = None
    elif case == "coincident":
        data = np.tile([[3.0, 4.0]], (10, 1))
        mask = None
    else:
        data = np.random.default_rng(3).uniform(-5, 5, (10, 2))
        mask = np.zeros(10, bool)
        mask[4] = True
    jest, test = JLine2D(0.5), Line2DEstimator(0.5)
    pj, vj = jest.lsq_fit(jnp.asarray(data), None if mask is None else jnp.asarray(mask))
    pt, vt = test.lsq_fit(torch.as_tensor(data), None if mask is None else torch.as_tensor(mask))
    assert bool(vt) == bool(vj) == (case == "vertical")
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **REFIT_TOL)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_line2d_vote_counts_match_jax(dtype):
    jest, test = JLine2D(1.5), Line2DEstimator(1.5)
    data = _structure("line2d", 2, 90).astype(dtype)
    params = np.asarray(jest.minimal_fit(jnp.asarray(_samples(test, 2, 91, 300)))[0]).astype(dtype)
    cj = np.asarray(jest.vote_counts(jnp.asarray(params), jnp.asarray(data)))
    ct = test.vote_counts(torch.as_tensor(params), torch.as_tensor(data)).numpy()
    if dtype == np.float64:
        np.testing.assert_array_equal(ct, cj)
    else:   # f32 products may round a border point the other way
        assert np.abs(ct - cj).max() <= 1
    # ... and they are the agree counts.
    agree = test.agree(torch.as_tensor(params), torch.as_tensor(data)).sum(-1).numpy()
    assert np.abs(ct - agree).max() <= (0 if dtype == np.float64 else 1)


def test_line2d_vote_counts_chunk_and_keep_tf32_flag(monkeypatch):
    from lsqrrecipes_tpu_torch.estimators import line2d

    test = Line2DEstimator(1.5)
    data = torch.as_tensor(_structure("line2d", 2, 92))
    params = test.minimal_fit(torch.as_tensor(_samples(test, 2, 93, 100)))[0]
    whole = test.vote_counts(params, data)
    monkeypatch.setattr(line2d, "_VOTE_CELLS", 7 * data.shape[0])   # 15 chunks
    before = torch.backends.cuda.matmul.allow_tf32
    assert torch.equal(test.vote_counts(params, data), whole)
    assert torch.backends.cuda.matmul.allow_tf32 == before


@pytest.mark.parametrize("name,jmake,tmake,dim", ESTIMATORS, ids=IDS)
def test_interop_builds_the_same_estimator(name, jmake, tmake, dim):
    jest = jmake()
    est = interop.estimator_from_attrs(jest)
    want = tmake()
    assert type(est) is type(want) and est.registry_name == jest.registry_name
    assert (est.delta, est.k, est.nparams) == (want.delta, want.k, want.nparams)
    assert getattr(est, "fused_family", None) == getattr(jest, "fused_family", None)
    assert getattr(est, "dim", None) == getattr(jest, "dim", None)


def test_registry_names_the_new_estimators():
    assert {"plane", "line", "line2d", "sphere"} <= set(names())
    assert get("plane") is PlaneEstimator and get("line2d") is Line2DEstimator
