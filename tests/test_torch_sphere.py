"""Port parity: the sphere estimator of ``lsqrrecipes_tpu_torch`` vs
``lsqrrecipes_tpu`` on the CPU, float64.

minimal_fit params to rtol 1e-10 (valid masks exactly equal), agree masks
exactly equal, the algebraic refit on a JAX-made mask to rtol 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu.estimators import ALGEBRAIC as J_ALGEBRAIC
from lsqrrecipes_tpu.estimators import SphereEstimator as JSphere
from lsqrrecipes_tpu_torch.estimators import (
    ALGEBRAIC,
    GEOMETRIC,
    SphereEstimator,
    get,
    names,
)

torch.set_num_threads(2)


def _cloud(seed, n, dim=3):
    """80% inliers on a radius-25 sphere (sigma 0.3) + 20% uniform outliers."""
    rng = np.random.default_rng(seed)
    n_in = n * 4 // 5
    d = rng.normal(size=(n_in, dim))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    center = np.array([5.0, -2.0, 11.0, 3.0][:dim])
    inl = center + 25.0 * d + 0.3 * rng.normal(size=(n_in, dim))
    out = rng.uniform(-40.0, 40.0, size=(n - n_in, dim))
    return np.concatenate([inl, out])


def _samples(seed, b, dim):
    rng = np.random.default_rng(seed)
    s = rng.uniform(-30.0, 30.0, size=(b, dim + 1, dim))
    s[::7, 1] = s[::7, 0]                # duplicate point: degenerate
    return s


@pytest.mark.parametrize("dim", [2, 3, 4])
def test_minimal_fit_matches_jax(dim):
    s = _samples(dim, 200, dim)
    pj, vj = JSphere(1.0, dim, J_ALGEBRAIC).minimal_fit(jnp.asarray(s))
    pt, vt = SphereEstimator(1.0, dim, ALGEBRAIC).minimal_fit(torch.as_tensor(s))
    vj = np.asarray(vj)
    np.testing.assert_array_equal(vt.numpy(), vj)
    assert vj.sum() > 150
    live = vj.copy()
    if dim in (2, 3):                   # Cramer: det of a zero row is 0
        assert (~vj).sum() >= 200 // 7
    else:
        # The SVD of a zero row leaves a ~1e-15 singular value above EPS in
        # both packages, so those lanes pass the rank gate with a solution
        # that is all rounding noise: compare the well-posed lanes only.
        live[::7] = False
    np.testing.assert_allclose(pt.numpy()[live], np.asarray(pj)[live], rtol=1e-10)


def test_agree_matches_jax():
    pts = _cloud(1, 300)
    params = np.array([[5.0, -2.0, 11.0, 25.0], [4.0, -1.0, 10.0, 24.0], [0.0, 0.0, 0.0, 10.0]])
    j = JSphere(1.0, 3, J_ALGEBRAIC)
    t = SphereEstimator(1.0, 3, ALGEBRAIC)
    mj = np.asarray(j.agree(jnp.asarray(params)[:, None], jnp.asarray(pts)))
    mt = t.agree(torch.as_tensor(params)[:, None], torch.as_tensor(pts)).numpy()
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(
        t.agree(torch.as_tensor(params[0]), torch.as_tensor(pts)).numpy(),
        np.asarray(j.agree(jnp.asarray(params[0]), jnp.asarray(pts))),
    )


@pytest.mark.parametrize("masked", [False, True])
def test_algebraic_fit_matches_jax(masked):
    pts = _cloud(2, 256)
    j = JSphere(1.0, 3, J_ALGEBRAIC)
    t = SphereEstimator(1.0, 3, ALGEBRAIC)
    mask = j.agree(jnp.asarray([5.0, -2.0, 11.0, 25.0]), jnp.asarray(pts)) if masked else None
    pj, vj = j.lsq_fit(jnp.asarray(pts), mask)
    pt, vt = t.lsq_fit(torch.as_tensor(pts), None if mask is None else torch.as_tensor(np.asarray(mask)))
    assert bool(vt) == bool(vj)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-9)


def test_algebraic_fit_rejects_too_few_points():
    pts = _cloud(3, 64)
    mask = np.zeros(64, bool)
    mask[:3] = True
    j = JSphere(1.0, 3, J_ALGEBRAIC)
    _, vj = j.lsq_fit(jnp.asarray(pts), jnp.asarray(mask))
    _, vt = SphereEstimator(1.0, 3, ALGEBRAIC).lsq_fit(torch.as_tensor(pts), torch.as_tensor(mask))
    assert not bool(vt) and not bool(vj)


def test_vote_counts_f64_exact_vs_jax():
    pts = _cloud(4, 300)
    rng = np.random.default_rng(5)
    params = np.concatenate([rng.uniform(-10, 20, (300, 3)), rng.uniform(0.5, 40, (300, 1))], 1)
    cj = JSphere(1.5, 3, J_ALGEBRAIC).vote_counts(jnp.asarray(params), jnp.asarray(pts))
    ct = SphereEstimator(1.5, 3, ALGEBRAIC).vote_counts(torch.as_tensor(params), torch.as_tensor(pts))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_fit_and_vote_matches_jax():
    pts = _cloud(6, 200)
    s = _samples(7, 100, 3)
    cj, pj = JSphere(1.0, 3, J_ALGEBRAIC).fit_and_vote(jnp.asarray(s), jnp.asarray(pts))
    ct, pt = SphereEstimator(1.0, 3, ALGEBRAIC).fit_and_vote(torch.as_tensor(s), torch.as_tensor(pts))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    ok = np.asarray(cj) >= 0
    np.testing.assert_allclose(pt.numpy()[ok], np.asarray(pj)[ok], rtol=1e-10)


def test_geometric_constructs_and_refit_names_the_roadmap():
    # The GEOMETRIC default (ROADMAP Queue 1 item 3) refits as the JAX
    # package does: Levenberg-Marquardt from the algebraic start, f64.
    est = SphereEstimator(1.0)
    assert est.ls_type == GEOMETRIC and est.fused_family == "sphere3d" and est.k == 4
    pts = _cloud(8, 32)
    params, valid = est.lsq_fit(torch.as_tensor(pts))
    jparams, jvalid = JSphere(1.0).lsq_fit(jnp.asarray(pts))
    assert bool(valid) == bool(jvalid)
    np.testing.assert_allclose(params.numpy(), np.asarray(jparams), rtol=1e-8, atol=1e-8)
    with pytest.raises(ValueError):
        SphereEstimator(1.0, 3, "lm")


def test_registry():
    assert "sphere" in names()
    assert get("sphere") is SphereEstimator
