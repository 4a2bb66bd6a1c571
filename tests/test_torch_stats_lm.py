"""Port parity: ``lsqrrecipes_tpu_torch.linalg.stats_lm`` and the ultrasound
estimators' batched refits vs ``lsqrrecipes_tpu``.

The same float64 data, made with numpy from a seed on the reference's data
models (``make_us_data`` for crosswire and pointer, the JAX package's
``make_plane_phantom_data`` model for the plane phantom), goes to both
packages.  The tolerances are those of ``tests/test_stats_lm.py``: the
quadratic forms to rtol 1e-8, the minima (cost rtol 1e-6, x rtol 1e-5 /
atol 1e-6), masked statistics to rtol 1e-12, batched against single to rtol
1e-7; ``lsq_fit_stats_batched`` against the JAX package to 1e-6 relative
and ``lsq_fit_batched`` to rtol 1e-8.  The plane phantom's null vector has
no fixed sign, so where each package starts from its own analytic fit its
parameters are compared up to that sign.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu import geometry as jgeo
from lsqrrecipes_tpu.estimators import line as jline
from lsqrrecipes_tpu.estimators import us_calibration as jus
from lsqrrecipes_tpu.linalg import LMConfig as JLMConfig
from lsqrrecipes_tpu.linalg import stats_lm as jstats
from lsqrrecipes_tpu_torch.estimators import LineEstimator
from lsqrrecipes_tpu_torch.estimators import us_calibration as tus
from lsqrrecipes_tpu_torch.linalg import LMConfig, levenberg_marquardt
from lsqrrecipes_tpu_torch.linalg import stats_lm
from lsqrrecipes_tpu_torch.tree import tree_map
from test_torch_plane_phantom import _close_up_to_sign
from test_torch_us_calibration import M_X, M_Y, euler_np, make_us_data

torch.set_num_threads(2)

KINDS = ("pointer", "crosswire", "plane_phantom")
N_MIN = {"pointer": 8, "crosswire": 11, "plane_phantom": 11}
ESTIMATORS = {
    "pointer": (jus.PointerUSCalibrationEstimator, tus.PointerUSCalibrationEstimator),
    "crosswire": (jus.CrosswireUSCalibrationEstimator, tus.CrosswireUSCalibrationEstimator),
    "plane_phantom": (jus.PlanePhantomUSCalibrationEstimator,
                      tus.PlanePhantomUSCalibrationEstimator),
}
FULL = {
    "pointer": (tus._pointer_residual, tus._pointer_jacobian),
    "crosswire": (tus._crosswire_residual, tus._crosswire_jacobian),
    "plane_phantom": (tus._plane_phantom_residual, tus._plane_phantom_jacobian),
}


def phantom_np(seed, n, sigma=1.0):
    """The JAX package's ``make_plane_phantom_data`` model in numpy:
    ``("plane_phantom", r2, t2, q)``."""
    rng = np.random.default_rng(seed)
    w3 = rng.uniform(0.0, np.pi, 3)
    r3 = euler_np(w3[2], w3[1], w3[0])
    t3 = rng.uniform(-100.0, 100.0, 3)
    wy1, wx1 = rng.uniform(-1.0, 1.0, 2)
    normal = np.array([-np.sin(wy1), np.cos(wy1) * np.sin(wx1), np.cos(wy1) * np.cos(wx1)])
    t1_z = rng.uniform(-100.0, 100.0)
    q = rng.uniform(size=(n, 2)) * np.array([640.0, 480.0])
    w2 = rng.uniform(0.0, np.pi, (n, 3))
    r2 = euler_np(w2[:, 2], w2[:, 1], w2[:, 0])
    img = q[:, 0:1] * (M_X * r3[:, 0]) + q[:, 1:2] * (M_Y * r3[:, 1]) + t3
    mapped = np.einsum("nij,nj->ni", r2, img)
    free = rng.uniform(-100.0, 100.0, (n, 3))
    t2 = free - ((mapped + free) @ normal + t1_z)[:, None] * normal
    return ("plane_phantom", r2, t2, q + sigma * rng.normal(size=q.shape))


def make(kind, seed=3, n=50, sigma=1.0):
    """Inlier-only float64 data of ``kind`` (numpy)."""
    if kind == "plane_phantom":
        return phantom_np(seed, n, sigma)
    return make_us_data(kind, seed, n, sigma=sigma, outliers=0.0)[0]


def to_jax(data):
    _, r, t, *rest = data
    return (jgeo.Frame(jnp.asarray(r), jnp.asarray(t)), *(jnp.asarray(a) for a in rest))


def to_torch(data):
    from lsqrrecipes_tpu_torch.geometry import Frame

    _, r, t, *rest = data
    return (Frame(torch.as_tensor(r), torch.as_tensor(t)), *(torch.as_tensor(a) for a in rest))


def ests(kind, ls_type=tus.ITERATIVE, delta=3.0):
    jcls, tcls = ESTIMATORS[kind]
    return jcls(delta, ls_type), tcls(delta, ls_type)


def analytic_x0(kind, data):
    """The analytic fit (held against the JAX package's in the estimator
    tests), cut to the residual layout: a start both packages are given."""
    _, test = ests(kind, tus.ANALYTIC)
    params, ok = test.lsq_fit(to_torch(data))
    assert bool(ok)
    return params.numpy()[: N_MIN[kind]]


def mixed_masks(n, b, k):
    """Strided masks and spatially offset blocks (``scripts/chip_check.py``'s
    ``check_lm_stats`` mix), each holding at least the first k observations."""
    idx = np.arange(n)
    strided = [idx % max(2, i % 7) != 0 for i in range(b // 2)]
    blocks = [np.roll(idx < n // 2 + i % 8, (i * n) // (b - b // 2)) for i in range(b - b // 2)]
    return np.stack(strided + blocks) | (idx[None, :] < k)


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", KINDS)
def test_objectives_match_jax(kind):
    data = make(kind, n=40)
    wj, sj, fj, cj = jstats._OBJECTIVES[kind]
    wt, st, ft, ct = stats_lm._OBJECTIVES[kind]
    assert ct == cj
    x = np.random.default_rng(1).normal(size=N_MIN[kind])
    close(wt(torch.as_tensor(x)).numpy(), np.asarray(wj(jnp.asarray(x))), 1e-14, 1e-14)
    close(ft(to_torch(data)).numpy(), np.asarray(fj(to_jax(data))), 1e-14, 1e-12)
    gram = np.asarray(sj(to_jax(data)))
    close(st(to_torch(data)).numpy(), gram, 1e-12, 1e-12 * np.abs(gram).max())
    # W takes leading axes: a [2, P] batch is its rows.
    xb = torch.as_tensor(np.stack([x, x + 0.1]))
    assert torch.equal(wt(xb)[1], wt(xb[1]))


@pytest.mark.parametrize("kind", KINDS)
def test_quadratics_match_full_jacobian_and_jax(kind):
    """cost, g, J^T J from H equal the explicit residual and Jacobian forms
    and JAX's ``feature_lm`` normal system."""
    data = make(kind)
    res_fn, jac_fn = FULL[kind]
    wt, st, _, _ = stats_lm._OBJECTIVES[kind]
    wj, sj, _, _ = jstats._OBJECTIVES[kind]
    x = analytic_x0(kind, data) * 1.03 + 0.01           # a generic non-stationary point
    xt = torch.as_tensor(x)
    r, j = res_fn(xt, to_torch(data)), jac_fn(xt, to_torch(data))
    h = st(to_torch(data))
    jtj, g = stats_lm._quadratics(wt, h, xt)
    cost = stats_lm._cost(wt, h, xt)
    c_full = float(0.5 * torch.sum(r * r))
    close(float(cost), c_full, 1e-9, 1e-9 * max(abs(c_full), 1.0))
    gs = float((j.T @ r).abs().max()) + 1.0
    close(g.numpy(), (j.T @ r).numpy(), 1e-8, 1e-9 * gs)
    js = float((j.T @ j).abs().max()) + 1.0
    close(jtj.numpy(), (j.T @ j).numpy(), 1e-8, 1e-9 * js)
    hj, xj = sj(to_jax(data)), jnp.asarray(x)
    tj, w = jax.jacfwd(wj)(xj), wj(xj)
    close(g.numpy(), np.asarray(jnp.einsum("rfp,rf->p", tj, w @ hj)), 1e-8, 1e-9 * gs)
    close(jtj.numpy(), np.asarray(jnp.einsum("rfp,fe,req->pq", tj, hj, tj)), 1e-8, 1e-9 * js)


@pytest.mark.parametrize("kind", KINDS)
def test_minima_match_jax_and_the_full_lm(kind):
    data = make(kind)
    x0 = analytic_x0(kind, data)
    res_fn, jac_fn = FULL[kind]
    config = LMConfig(max_iters=200)
    port = stats_lm.us_feature_lm(kind, to_torch(data), torch.as_tensor(x0), config=config)
    full = levenberg_marquardt(res_fn, jac_fn, torch.as_tensor(x0), to_torch(data), config=config)
    jx = jstats.us_feature_lm(kind, to_jax(data), jnp.asarray(x0), config=JLMConfig(max_iters=200))
    assert bool(port.converged) and bool(full.converged) and bool(jx.converged)
    for want in (full, jx):
        close(float(port.cost), float(want.cost), 1e-6, 1e-9)
        close(port.x.numpy(), np.asarray(want.x), 1e-5, 1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_masked_stats_equal_deleted_rows(kind):
    """A mask-weighted H is the H of the kept subset (consensus-refit semantics)."""
    data = make(kind)
    _, st, _, _ = stats_lm._OBJECTIVES[kind]
    mask = np.arange(50) % 3 != 0
    kept = tree_map(lambda a: a[torch.as_tensor(mask)], to_torch(data))
    close(st(to_torch(data), torch.as_tensor(mask)).numpy(), st(kept).numpy(), 1e-12, 1e-9)


@pytest.mark.parametrize("kind", ["pointer", "crosswire"])
def test_batched_matches_single(kind):
    """``tests/test_stats_lm.py``'s pointer case, and crosswire.  (The plane
    phantom's batched and single minima part by up to 1.4e-7 relative here,
    and by 1e-7 in the JAX package: the two centerings condition the
    31-feature Gram differently; its batched refit is held against the JAX
    package below.)"""
    data = make(kind)
    n = 50
    x0 = torch.as_tensor(analytic_x0(kind, data))
    x0s = torch.stack([x0, x0 * 1.001, x0 * 0.999])
    masks = torch.as_tensor(np.stack([np.ones(n, bool), np.arange(n) % 2 == 0,
                                      np.arange(n) % 5 != 0]))
    config = LMConfig(max_iters=200)
    batched = stats_lm.us_feature_lm_batched(kind, to_torch(data), x0s, masks, config=config)
    for i in range(3):
        single = stats_lm.us_feature_lm(kind, to_torch(data), x0s[i], masks[i], config=config)
        assert bool(batched.converged[i]) == bool(single.converged)
        close(batched.x[i].numpy(), single.x.numpy(), 1e-7, 1e-8)


def test_unmasked_batch_and_planar_shape_check():
    """Without masks every problem shares the one centered Gram; the planar
    solver takes only a ``[B, P]`` start."""
    data = make("pointer")
    x0 = torch.as_tensor(analytic_x0("pointer", data))
    batched = stats_lm.us_feature_lm_batched("pointer", to_torch(data), torch.stack([x0, x0]))
    single = stats_lm.us_feature_lm("pointer", to_torch(data), x0)
    close(batched.x[1].numpy(), single.x.numpy(), 1e-7, 1e-8)
    with pytest.raises(ValueError, match=r"\[B, P\]"):
        stats_lm.feature_lm_planar(stats_lm.pointer_w, torch.eye(6, dtype=torch.float64), x0)


def test_centered_from_gram_matches_centered_problem_and_jax():
    """The one-reduction raw-Gram congruence gives the problem of feature
    centering (up to its eps * raw-scale build perturbation) and JAX's."""
    data = make("pointer", n=48)
    h = stats_lm.pointer_features(to_torch(data))
    wts = torch.ones(48, dtype=torch.float64)
    w_a, gram_a = stats_lm._centered_problem(stats_lm.pointer_w, h, wts, 2)
    g_raw = torch.einsum("ni,nj,n->ij", h, h, wts)
    w_b, gram_b = stats_lm.centered_from_gram(stats_lm.pointer_w, g_raw, 2)
    scale = float(g_raw.abs().max())
    close(gram_b.numpy(), gram_a.numpy(), 0, 1e-9 * scale)
    x = torch.tensor([1.0, -2.0, 3.0, 0.1, -0.2, 0.3, 0.14, 0.14], dtype=torch.float64)
    close(w_b(x).numpy(), w_a(x).numpy(), 0, 1e-12)
    w_j, gram_j = jstats.centered_from_gram(jstats.pointer_w, jnp.asarray(g_raw.numpy()), 2)
    close(gram_b.numpy(), np.asarray(gram_j), 1e-12, 1e-12 * scale)
    close(w_b(x).numpy(), np.asarray(w_j(jnp.asarray(x.numpy()))), 1e-14, 1e-14)


@pytest.mark.parametrize("kind", KINDS)
def test_lsq_fit_stats_batched_matches_jax_and_lsq_fit(kind):
    """Shared data, B = 8 mixed strided and offset-block masks: equal to the
    JAX package to 1e-6 relative, and to the per-problem full-LM
    ``lsq_fit`` well inside the reference tolerances (as the JAX test)."""
    jest, test = ests(kind)
    data = make(kind, seed=5, n=48)
    masks = mixed_masks(48, 8, test.k)
    pt, vt = test.lsq_fit_stats_batched(to_torch(data), torch.as_tensor(masks))
    pj, vj = jest.lsq_fit_stats_batched(to_jax(data), jnp.asarray(masks))
    assert pt.shape == (8, test.nparams_lsq) and pt.dtype == torch.float64
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert bool(vt[:4].all())                    # the strided masks hold >= 32 observations
    ok = vt.numpy()
    if kind == "plane_phantom":
        _close_up_to_sign(pt.numpy()[ok], np.asarray(pj)[ok], 1e-6)
    else:
        close(pt.numpy()[ok], np.asarray(pj)[ok], 1e-6, 1e-6)
    for i in np.flatnonzero(ok)[:3]:
        p1, v1 = test.lsq_fit(to_torch(data), torch.as_tensor(masks[i]))
        assert bool(v1)
        close(pt[i].numpy(), p1.numpy(), 1e-4, 1e-4)


def test_lsq_fit_stats_batched_from_starts_and_its_errors():
    """B starts and no masks: every problem on all the data; neither masks
    nor starts is an error."""
    jest, test = ests("pointer")
    data = make("pointer", seed=6, n=40)
    x0 = analytic_x0("pointer", data)
    x0s = np.stack([x0, x0 + 0.01])
    pt, vt = test.lsq_fit_stats_batched(to_torch(data), x0=torch.as_tensor(x0s))
    pj, vj = jest.lsq_fit_stats_batched(to_jax(data), x0=jnp.asarray(x0s))
    assert bool(vt.all()) and bool(jnp.all(vj))
    close(pt.numpy(), np.asarray(pj), 1e-6, 1e-6)
    with pytest.raises(ValueError, match="masks and/or x0"):
        test.lsq_fit_stats_batched(to_torch(data))


@pytest.mark.parametrize("kind", KINDS)
def test_lsq_fit_batched_matches_per_problem_and_jax(kind):
    """``tests/test_us_calibration.py:358-378`` for each kind: B = 4
    datasets with distinct masks, one batched LM, against B ``lsq_fit``
    calls and the JAX package's vmapped refit (rtol 1e-8)."""
    jest, test = ests(kind)
    n = 32 if kind != "plane_phantom" else 48
    datasets = [make(kind, seed=40 + i, n=n) for i in range(4)]
    stacked = (kind, *(np.stack([d[j] for d in datasets]) for j in range(1, len(datasets[0]))))
    masks = np.stack([np.arange(n) % (i + 3) != 0 for i in range(4)])
    pb, vb = test.lsq_fit_batched(to_torch(stacked), torch.as_tensor(masks))
    jb, jv = jest.lsq_fit_batched(to_jax(stacked), jnp.asarray(masks))
    assert pb.shape == (4, test.nparams_lsq) and bool(vb.all()) and bool(jnp.all(jv))
    for i in range(4):
        p1, v1 = test.lsq_fit(to_torch(datasets[i]), torch.as_tensor(masks[i]))
        assert bool(v1)
        close(pb[i].numpy(), p1.numpy(), 1e-8, 1e-8)
    if kind == "plane_phantom":
        _close_up_to_sign(pb.numpy(), np.asarray(jb), 1e-8)
    else:
        close(pb.numpy(), np.asarray(jb), 1e-8, 1e-8)


def test_lsq_fit_batched_analytic_mode_is_the_batched_start():
    jest, test = ests("crosswire", tus.ANALYTIC)
    datasets = [make("crosswire", seed=50 + i, n=24) for i in range(3)]
    stacked = ("crosswire", *(np.stack([d[j] for d in datasets]) for j in range(1, 4)))
    pb, vb = test.lsq_fit_batched(to_torch(stacked))
    jb, jv = jest.lsq_fit_batched(to_jax(stacked))
    np.testing.assert_array_equal(vb.numpy(), np.asarray(jv))
    close(pb.numpy(), np.asarray(jb), 1e-9, 1e-9)


@pytest.mark.parametrize("kind", ["pointer", "plane_phantom"])
def test_lsq_fit_batched_analytic_mode_equals_per_problem(kind):
    """ANALYTIC ``lsq_fit_batched``, the batched analytic start: B = 3
    datasets with distinct masks, each equal to its own ``lsq_fit`` (the
    crosswire's case is in ``test_torch_us_calibration.py``)."""
    _, test = ests(kind, tus.ANALYTIC)
    n = 32 if kind != "plane_phantom" else 48
    datasets = [make(kind, seed=60 + i, n=n) for i in range(3)]
    stacked = (kind, *(np.stack([d[j] for d in datasets]) for j in range(1, len(datasets[0]))))
    masks = np.stack([np.arange(n) % (i + 3) != 0 for i in range(3)])
    pb, vb = test.lsq_fit_batched(to_torch(stacked), torch.as_tensor(masks))
    assert pb.shape == (3, test.nparams_lsq) and bool(vb.all())
    for i in range(3):
        p1, v1 = test.lsq_fit(to_torch(datasets[i]), torch.as_tensor(masks[i]))
        assert bool(v1)
        close(pb[i].numpy(), p1.numpy(), 1e-10, 1e-10)


def test_lsq_fit_batched_default_loops_over_problems():
    """Estimators without a batched refit loop ``lsq_fit`` over the leading
    axis: a 3D line on B = 3 clouds, against the JAX package's vmap."""
    rng = np.random.default_rng(11)
    t = rng.uniform(-10, 10, (3, 40, 1))
    pts = (np.array([1.0, 2.0, -3.0]) + t * np.array([0.6, -0.64, 0.48])
           + 0.05 * rng.normal(size=(3, 40, 3)))
    masks = rng.uniform(size=(3, 40)) < 0.8
    est = LineEstimator(0.5, 3)
    pb, vb = est.lsq_fit_batched(torch.as_tensor(pts), torch.as_tensor(masks))
    jb, jv = jline.LineEstimator(0.5, 3).lsq_fit_batched(jnp.asarray(pts), jnp.asarray(masks))
    assert pb.shape == (3, 6) and bool(vb.all()) and bool(jnp.all(jv))
    for i in range(3):
        p1, _ = est.lsq_fit(torch.as_tensor(pts[i]), torch.as_tensor(masks[i]))
        assert torch.equal(pb[i], p1)
    direction = np.sign(np.sum(pb.numpy()[:, :3] * np.asarray(jb)[:, :3], axis=1))[:, None]
    close(pb.numpy()[:, :3] * direction, np.asarray(jb)[:, :3], 1e-9, 1e-9)
    close(pb.numpy()[:, 3:], np.asarray(jb)[:, 3:], 1e-9, 1e-9)
