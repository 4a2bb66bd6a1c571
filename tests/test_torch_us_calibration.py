"""Port parity: the crosswire and calibrated-pointer ultrasound calibration
estimators of ``lsqrrecipes_tpu_torch`` vs ``lsqrrecipes_tpu``, and the
engine's drivers on their data.

The same float64 data, made with numpy from a seed on the reference's data
model (``SinglePointTargetUSCalibrationParametersEstimatorTest.cxx:556-667``:
a random calibration, poses with Euler angles uniform in [0, pi), pixels in
640 x 480 with N(0, sigma) noise, the last 20% of the tracked translations or
target points shifted by 30-80), goes to both packages.  Minimal fits agree
to 1e-9, least-squares fits in both modes to 1e-6 relative with the same
``valid``, ``agree`` masks and vote counts exactly, the Jacobians to 1e-12.
The crosswire's closed-form residual and Jacobian equal
``torch.func.jacfwd`` of the residual written out, near the Euler
gimbal too, with a leading problem axis and in float32.  Each of the three
calibrations' refits (crosswire, pointer, plane phantom; one problem and
batched) evaluates its residual or Jacobian once for the LM's first cost
and three times a step, counted on the test's side.  The drivers
recover the planted calibration at the JAX tests' limits
(``tests/test_us_calibration.py:33-36``: translations within 1.0, rotation
within 1 degree, scales within 1.0).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu import geometry as jgeo
from lsqrrecipes_tpu.estimators import us_calibration as jus
from lsqrrecipes_tpu.ransac import engine as jengine
from lsqrrecipes_tpu.ransac import sampling as jsampling
from lsqrrecipes_tpu_torch import estimators as est_mod
from lsqrrecipes_tpu_torch import interop
from lsqrrecipes_tpu_torch.estimators import us_calibration as tus
from lsqrrecipes_tpu_torch.geometry import Frame
from lsqrrecipes_tpu_torch.linalg import LMConfig
from lsqrrecipes_tpu_torch.linalg.lm import _CHECK_EVERY
from lsqrrecipes_tpu_torch.ransac import engine
from lsqrrecipes_tpu_torch.synthetic import make_plane_phantom_data
from lsqrrecipes_tpu_torch.tree import tree_leaves
from lsqrrecipes_tpu_torch.utils import profiling

torch.set_num_threads(2)

M_X, M_Y = 0.143, 0.139
KINDS = ("crosswire", "pointer")


def euler_np(wz, wy, wx):
    """``Rz(wz) Ry(wy) Rx(wx)`` in numpy, ``[..., 3, 3]``."""
    cz, sz, cy, sy, cx, sx = np.cos(wz), np.sin(wz), np.cos(wy), np.sin(wy), np.cos(wx), np.sin(wx)
    return np.stack([
        np.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx], -1),
        np.stack([sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx], -1),
        np.stack([-sy, cy * sx, cy * cx], -1),
    ], -2)


def make_us_data(kind, seed, n, sigma=0.5, outliers=0.2):
    """``((kind, r2, t2, q[, p]), truth)`` on the reference's data model."""
    rng = np.random.default_rng(seed)
    w3 = rng.uniform(0.0, np.pi, 3)
    truth = {"r3": euler_np(w3[2], w3[1], w3[0]), "t3": rng.uniform(-100, 100, 3),
             "t1": rng.uniform(-100, 100, 3)}
    q = rng.uniform(size=(n, 2)) * np.array([640.0, 480.0])
    w2 = rng.uniform(0.0, np.pi, (n, 3))
    r2 = euler_np(w2[:, 2], w2[:, 1], w2[:, 0])
    img = q[:, 0:1] * (M_X * truth["r3"][:, 0]) + q[:, 1:2] * (M_Y * truth["r3"][:, 1]) + truth["t3"]
    n_out = int(n * outliers)
    shift = (30.0 + 50.0 * rng.uniform(size=(n_out, 3))) * np.sign(rng.normal(size=(n_out, 3)))
    q = q + sigma * rng.normal(size=q.shape)
    if kind == "crosswire":
        t2 = truth["t1"] - np.einsum("nij,nj->ni", r2, img)
        t2[n - n_out:] += shift
        return (kind, r2, t2, q), truth
    t2 = rng.uniform(-100, 100, (n, 3))
    p = np.einsum("nij,nj->ni", r2, img) + t2
    p[n - n_out:] += shift
    return (kind, r2, t2, q, p), truth


def to_torch(data, dtype=None):
    _, r, t, *rest = data
    conv = [torch.as_tensor(np.asarray(a)) for a in (r, t, *rest)]
    if dtype is not None:
        conv = [a.to(dtype) for a in conv]
    return (Frame(conv[0], conv[1]), *conv[2:])


def to_jax(data):
    _, r, t, *rest = data
    return (jgeo.Frame(jnp.asarray(r), jnp.asarray(t)), *(jnp.asarray(a) for a in rest))


def gather_np(data, idx):
    kind, *arrays = data
    return (kind, *(a[idx] for a in arrays))


ESTIMATORS = {
    "crosswire": (jus.CrosswireUSCalibrationEstimator, tus.CrosswireUSCalibrationEstimator),
    "pointer": (jus.PointerUSCalibrationEstimator, tus.PointerUSCalibrationEstimator),
}


def make_estimators(kind, ls_type=tus.ITERATIVE, delta=3.0):
    jcls, tcls = ESTIMATORS[kind]
    return jcls(delta, ls_type), tcls(delta, ls_type)


def rotation_angle(r_a, r_b):
    c = (np.trace(r_a.T @ r_b) - 1.0) / 2.0
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def check_truth(kind, params, truth):
    """The JAX tests' limits: translations 1.0, rotation 1 degree, scales 1.0."""
    x = np.asarray(params, np.float64)
    if kind == "crosswire":
        np.testing.assert_allclose(x[0:3], truth["t1"], atol=1.0)
        x = x[3:]
    np.testing.assert_allclose(x[0:3], truth["t3"], atol=1.0)
    assert rotation_angle(euler_np(x[3], x[4], x[5]), truth["r3"]) < np.radians(1.0)
    np.testing.assert_allclose(x[6:8], [M_X, M_Y], atol=1.0)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_registry_and_sizes():
    assert {"us_crosswire", "us_pointer"} <= set(est_mod.names())
    for kind in KINDS:
        jest, test = make_estimators(kind)
        assert (test.k, test.nparams, test.nparams_lsq) == (jest.k, jest.nparams, jest.nparams_lsq)
        assert test.fused_family == jest.fused_family == kind
        assert test.registry_name == jest.registry_name
        assert test.delta_squared == jest.delta_squared
    assert (est_mod.ANALYTIC, est_mod.ITERATIVE) == (jus.ANALYTIC, jus.ITERATIVE)
    assert tus.FLT_EPS == jus.FLT_EPS
    with pytest.raises(ValueError, match="least-squares type"):
        tus.PointerUSCalibrationEstimator(3.0, "geometric")


@pytest.mark.parametrize("kind", KINDS)
def test_minimal_fit_matches_jax_batched(kind):
    jest, test = make_estimators(kind)
    data, truth = make_us_data(kind, 1, 64, sigma=0.0, outliers=0.0)
    idx = np.array(jsampling.sample_k_subsets(jax.random.PRNGKey(2), 64, test.k, 100))
    idx[0] = idx[0, 0]                      # one repeated pose: rank-deficient
    samples = gather_np(data, idx)
    pj, vj = jax.vmap(jest.minimal_fit)(to_jax(samples))
    pt, vt = test.minimal_fit(to_torch(samples))
    assert pt.shape == (100, test.nparams)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert not bool(vt[0]) and bool(vt[1:].all())
    _close(pt[1:].numpy(), np.asarray(pj)[1:], 1e-9, 1e-9)
    check_truth(kind, pt[1].numpy(), truth)


@pytest.mark.parametrize("ls_type", [tus.ANALYTIC, tus.ITERATIVE])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_lsq_fit_matches_jax(kind, masked, ls_type):
    jest, test = make_estimators(kind, ls_type)
    data, truth = make_us_data(kind, 3, 120, outliers=0.2 if masked else 0.0)
    mask = np.arange(120) < 96 if masked else None
    pj, vj = jest.lsq_fit(to_jax(data), None if mask is None else jnp.asarray(mask))
    pt, vt = test.lsq_fit(to_torch(data), None if mask is None else torch.as_tensor(mask))
    assert bool(vt) == bool(vj) is True
    assert pt.shape == (test.nparams,) and pt.dtype == torch.float64
    _close(pt.numpy(), np.asarray(pj), 1e-6, 1e-9)
    check_truth(kind, pt.numpy(), truth)


@pytest.mark.parametrize("kind", KINDS)
def test_lsq_fit_flags_too_few_observations(kind):
    jest, test = make_estimators(kind)
    data, _ = make_us_data(kind, 4, 40)
    mask = np.zeros(40, bool)
    mask[:2] = True                         # fewer observations than unknowns
    _, vj = jest.lsq_fit(to_jax(data), jnp.asarray(mask))
    _, vt = test.lsq_fit(to_torch(data), torch.as_tensor(mask))
    assert bool(vt) == bool(vj) is False


@pytest.mark.parametrize("kind", KINDS)
def test_jacobian_matches_jax(kind):
    data, _ = make_us_data(kind, 5, 30)
    jest, test = make_estimators(kind)
    params, _ = jest.lsq_fit(to_jax(data))
    x = np.asarray(params)[: 11 if kind == "crosswire" else 8] + 0.01
    jres, jjac = ((jus._crosswire_residual, jus._crosswire_jacobian) if kind == "crosswire"
                  else (jus._pointer_residual, jus._pointer_jacobian))
    tres, tjac = ((tus._crosswire_residual, tus._crosswire_jacobian) if kind == "crosswire"
                  else (tus._pointer_residual, tus._pointer_jacobian))
    want = np.asarray(jjac(jnp.asarray(x), to_jax(data)))
    got = tjac(torch.as_tensor(x), to_torch(data)).numpy()
    assert got.shape == (90, len(x))
    _close(got, want, 1e-12, 1e-12)
    _close(tres(torch.as_tensor(x), to_torch(data)).numpy(),
           np.asarray(jres(jnp.asarray(x), to_jax(data))), 1e-12, 1e-12)


def _jacfwd_crosswire_residual(x, data):
    """The crosswire residual as it was differentiated before its closed
    form: one problem, ``torch.func.jacfwd`` of the Euler matrix, image
    points and tracked poses."""
    frames, q = data

    def residual(x):
        r = tus._euler_zyx_matrix(x[6], x[7], x[8])
        img = q[:, 0:1] * (x[9] * r[:, 0]) + q[:, 1:2] * (x[10] * r[:, 1]) + x[3:6]
        return (torch.einsum("nij,nj->ni", frames.r, img) + frames.t - x[0:3]).reshape(-1)

    return residual(x), torch.func.jacfwd(residual)(x)


def _crosswire_point(case, seed, dtype=torch.float64):
    """``(x [11], data)``: the analytic fit of crosswire data moved off it,
    with ``w_y`` 5e-4 from +-pi/2 in the gimbal cases."""
    data, _ = make_us_data("crosswire", seed, 40)
    _, test = make_estimators("crosswire", tus.ANALYTIC)
    x = test.lsq_fit(to_torch(data))[0][:11].clone()
    x += 0.01 * torch.as_tensor(np.random.default_rng(seed).normal(size=11))
    if case != "random":
        x[7] = (1.0 if case == "gimbal_plus" else -1.0) * (np.pi / 2 - 5e-4)
    return x.to(dtype), to_torch(data, dtype)


def _close_to_scale(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", ["random", "gimbal_plus", "gimbal_minus"])
def test_closed_form_crosswire_matches_jacfwd_of_the_residual(case, masked):
    x, data = _crosswire_point(case, 21)
    r_want, j_want = _jacfwd_crosswire_residual(x, data)
    r_got, j_got = tus._crosswire_residual(x, data), tus._crosswire_jacobian(x, data)
    assert r_got.shape == (120,) and j_got.shape == (120, 11)
    assert torch.equal(j_got[:, 0:3], -torch.eye(3, dtype=x.dtype).repeat(40, 1))
    if masked:      # the LM's masking: rows of left-out images are zero in both
        m = torch.repeat_interleave(torch.arange(40) % 5 != 0, 3).to(x.dtype)
        r_want, j_want, r_got, j_got = r_want * m, j_want * m[:, None], r_got * m, j_got * m[:, None]
    _close_to_scale(r_got, r_want, 1e-12)
    _close_to_scale(j_got, j_want, 1e-12)


def test_closed_form_crosswire_takes_a_leading_problem_axis():
    """B = 3 problems at once, on stacked data, equal the three single
    problems."""
    points = [_crosswire_point(case, 22 + i) for i, case in
              enumerate(["random", "gimbal_plus", "gimbal_minus"])]
    xs = torch.stack([x for x, _ in points])
    datas = [d for _, d in points]
    batched = (Frame(torch.stack([d[0].r for d in datas]), torch.stack([d[0].t for d in datas])),
               torch.stack([d[1] for d in datas]))
    r, j = tus._crosswire_residual(xs, batched), tus._crosswire_jacobian(xs, batched)
    assert r.shape == (3, 120) and j.shape == (3, 120, 11)
    for i in range(3):
        _close_to_scale(r[i], tus._crosswire_residual(xs[i], datas[i]), 1e-15)
        _close_to_scale(j[i], tus._crosswire_jacobian(xs[i], datas[i]), 1e-15)


def test_closed_form_crosswire_in_float32():
    x, data = _crosswire_point("random", 23, torch.float32)
    r_want, j_want = _jacfwd_crosswire_residual(x, data)
    r_got, j_got = tus._crosswire_residual(x, data), tus._crosswire_jacobian(x, data)
    assert r_got.dtype == j_got.dtype == torch.float32
    _close_to_scale(r_got, r_want, 1e-5)
    _close_to_scale(j_got, j_want, 1e-5)


@pytest.mark.parametrize("ls_type", [tus.ANALYTIC, tus.ITERATIVE])
def test_crosswire_lsq_fit_batched_equals_per_problem(ls_type):
    """``lsq_fit_batched`` passes the closed form its leading axis (no
    ``vmap``): B = 3 datasets with distinct masks give each ``lsq_fit``."""
    _, test = make_estimators("crosswire", ls_type)
    datasets = [make_us_data("crosswire", 30 + i, 60)[0] for i in range(3)]
    stacked = ("crosswire", *(np.stack([d[j] for d in datasets]) for j in range(1, 4)))
    masks = np.stack([np.arange(60) < 48 - 4 * i for i in range(3)])
    pb, vb = test.lsq_fit_batched(to_torch(stacked), torch.as_tensor(masks))
    assert pb.shape == (3, test.nparams) and bool(vb.all())
    for i in range(3):
        p1, v1 = test.lsq_fit(to_torch(datasets[i]), torch.as_tensor(masks[i]))
        assert bool(v1)
        _close(pb[i].numpy(), p1.numpy(), 1e-10, 1e-10)


def _counted(fn, x, data):
    profiling.count("test.evals", 1)
    return fn(x, data)


def _stack_problems(datasets):
    frames = [d[0] for d in datasets]
    return (Frame(torch.stack([f.r for f in frames]), torch.stack([f.t for f in frames])),
            *(torch.stack(parts) for parts in zip(*(d[1:] for d in datasets))))


@pytest.mark.parametrize("kind,batched,ls_type", [
    ("crosswire", False, tus.ITERATIVE), ("crosswire", True, tus.ITERATIVE),
    ("crosswire", False, tus.ANALYTIC), ("pointer", False, tus.ITERATIVE),
    ("pointer", True, tus.ITERATIVE), ("plane_phantom", False, tus.ITERATIVE),
    ("plane_phantom", True, tus.ITERATIVE)])
def test_the_lm_evaluates_once_then_three_times_a_step(kind, batched, ls_type, monkeypatch):
    """The refit's residual and Jacobian evaluations, counted on the
    test's side around the estimator's own (one problem and batched): the
    LM's first cost, then three a step (the normal system's residual and
    Jacobian, the residual at the trial point), frozen steps included; a
    batched LM evaluates once a call for all its problems; an ANALYTIC
    refit evaluates none."""
    if kind == "plane_phantom":
        est, n = tus.PlanePhantomUSCalibrationEstimator(1.0, ls_type), 64
        datasets = [make_plane_phantom_data(torch.Generator().manual_seed(3 + i), n=n, sigma=0.5,
                                            device="cpu")[0] for i in range(2)]
    else:
        (_, est), n = make_estimators(kind, ls_type), 60
        datasets = [to_torch(make_us_data(kind, 60 + i, n)[0]) for i in range(2)]
    masks = torch.stack([torch.arange(n) % (i + 5) != 0 for i in range(2)])
    cls = type(est)
    for name in ("_residual", "_jacobian", "_residual_batched", "_jacobian_batched"):
        counted = functools.partial(_counted, getattr(cls, name))
        monkeypatch.setattr(cls, name, staticmethod(counted))
    profiling.reset()
    was = profiling.set_tracing(True)
    try:
        if batched:
            est.lsq_fit_batched(_stack_problems(datasets), masks)
        else:
            est.lsq_fit(datasets[0], masks[0])
        recs = profiling.records()
    finally:
        profiling.set_tracing(was)
        profiling.reset()
    evals = [r for r in recs if r.name == "test.evals"]
    steps = [r for r in recs if r.name == "lm.steps"]
    if ls_type == tus.ANALYTIC:
        assert evals == steps == []
        return
    (steps,) = steps
    assert len(evals) == 1 + 3 * steps.value and steps.value >= _CHECK_EVERY
    assert [recs[r.parent].name for r in evals[:4]] == ["lm", "lm.normal", "lm.normal", "lm.trial"]


@pytest.mark.parametrize("kind", KINDS)
def test_agree_votes_and_distances_match_jax(kind):
    jest, test = make_estimators(kind)
    data, _ = make_us_data(kind, 6, 100)
    params, _ = jest.lsq_fit(to_jax(data), jnp.asarray(np.arange(100) < 80))
    rng = np.random.default_rng(7)
    batch = np.asarray(params) + rng.normal(0, 0.02, (32, test.nparams))
    batch[0] = np.asarray(params)
    want = jax.vmap(lambda p: jest.agree(p, to_jax(data)))(jnp.asarray(batch))
    got = test.agree(torch.as_tensor(batch), to_torch(data))
    assert got.shape == (32, 100)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 70 < int(got[0].sum()) <= 100
    counts = test.vote_counts(torch.as_tensor(batch), to_torch(data))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jest.vote_counts(jnp.asarray(batch),
                                                                              to_jax(data))))
    np.testing.assert_array_equal(counts.numpy(), got.sum(-1).numpy())
    dj = jest.distance_statistics(params, to_jax(data))
    dt = test.distance_statistics(torch.as_tensor(np.array(params)), to_torch(data))
    for a, b in zip(dt, dj):
        _close(a.numpy(), np.asarray(b), 1e-12, 1e-12)


@pytest.mark.parametrize("kind", KINDS)
def test_vote_counts_chunk_over_hypotheses(kind, monkeypatch):
    _, test = make_estimators(kind)
    data, _ = make_us_data(kind, 8, 64)
    params, _ = test.lsq_fit(to_torch(data))
    batch = params + 0.05 * torch.as_tensor(np.random.default_rng(9).normal(size=(10, test.nparams)))
    whole = test.vote_counts(batch, to_torch(data))
    monkeypatch.setattr(tus, "_VOTE_CELLS", 3 * 64)         # chunks of 3 hypotheses
    np.testing.assert_array_equal(test.vote_counts(batch, to_torch(data)).numpy(), whole.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_hypothesize_and_vote_and_refit_on_jax_indices(kind):
    jest, test = make_estimators(kind)
    data, truth = make_us_data(kind, 10, 128)
    idx = np.array(jsampling.sample_k_subsets(jax.random.PRNGKey(11), 128, test.k, 300))
    cj, mj, pj = jengine.hypothesize_and_vote(jest, to_jax(data), jnp.asarray(idx))
    ct, mt, pt = engine.hypothesize_and_vote(test, to_torch(data), torch.as_tensor(idx))
    assert int(ct) == int(cj) and int(ct) > 90
    _close(pt.numpy(), np.asarray(pj), 1e-9, 1e-9)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    rj, vj = jengine.consensus_refit(jest, to_jax(data), mj)
    rt, vt = engine.consensus_refit(test, to_torch(data), mt)
    assert bool(vt) == bool(vj) is True
    _close(rt.numpy(), np.asarray(rj), 1e-6, 1e-9)
    check_truth(kind, rt.numpy(), truth)


@pytest.mark.parametrize("kind", KINDS)
def test_ransac_on_jax_indices(kind, monkeypatch):
    jest, test = make_estimators(kind)
    data, truth = make_us_data(kind, 12, 150)
    key = jax.random.PRNGKey(13)
    rj = jengine.ransac(jest, to_jax(data), key, num_hypotheses=256)

    def sample(generator, n, k, b, sampler="auto", device="cpu"):
        return torch.as_tensor(np.array(jengine._sample(key, n, k, b, sampler)), dtype=torch.int64)

    monkeypatch.setattr(engine, "_sample", sample)
    rt = engine.ransac(test, to_torch(data), None, num_hypotheses=256, device="cpu")
    assert int(rt.best_count) == int(rj.best_count) and bool(rt.valid) == bool(rj.valid) is True
    np.testing.assert_array_equal(rt.consensus.numpy(), np.asarray(rj.consensus))
    _close(rt.params.numpy(), np.asarray(rj.params), 1e-6, 1e-9)
    check_truth(kind, rt.params.numpy(), truth)


@pytest.mark.parametrize("kind", KINDS)
def test_drivers_recover_the_planted_calibration(kind):
    _, test = make_estimators(kind)
    data, truth = make_us_data(kind, 14, 256)
    tdata = to_torch(data)
    gen = torch.Generator().manual_seed(15)
    results = {
        "ransac": engine.ransac(test, tdata, gen, num_hypotheses=1024),
        "structured": engine.ransac_structured(test, tdata, gen, num_hypotheses=1024),
        "fused": engine.ransac_fused_sweep(test, tdata, gen, num_hypotheses=1024),
        "adaptive": engine.ransac_adaptive(test, tdata, gen),
    }
    for name, res in results.items():
        assert bool(res.valid), name
        assert float(res.inlier_fraction) > 0.7, name
        assert int(res.best_count) == int(res.consensus.sum()), name
        assert res.params.dtype == torch.float64
        check_truth(kind, res.params.numpy(), truth)


@pytest.mark.parametrize("kind", KINDS)
def test_exhaustive_matches_jax(kind):
    jest, test = make_estimators(kind, tus.ANALYTIC)
    data, _ = make_us_data(kind, 16, 11)
    rj = jengine.ransac_exhaustive(jest, to_jax(data), batch_size=128)
    rt = engine.ransac_exhaustive(test, to_torch(data), batch_size=128, device="cpu")
    assert int(rt.best_count) == int(rj.best_count)
    np.testing.assert_array_equal(rt.consensus.numpy(), np.asarray(rj.consensus))
    _close(rt.minimal_params.numpy(), np.asarray(rj.minimal_params), 1e-9, 1e-9)
    _close(rt.params.numpy(), np.asarray(rj.params), 1e-6, 1e-9)


@pytest.mark.parametrize("kind", KINDS)
def test_interop_builds_the_estimator_and_its_data(kind):
    jest = ESTIMATORS[kind][0](2.5, jus.ANALYTIC, jus.LMConfig(max_iters=50, ftol=1e-12))
    got = interop.estimator_from_attrs(jest)
    assert type(got) is ESTIMATORS[kind][1]
    assert (got.delta, got.ls_type) == (2.5, tus.ANALYTIC)
    assert got.lm_config == LMConfig(max_iters=50, ftol=1e-12)
    data, _ = make_us_data(kind, 17, 30)
    tdata = interop.data_to_torch(to_jax(data), device="cpu")
    want = to_torch(data)
    assert isinstance(tdata, tuple) and isinstance(tdata[0], Frame)
    assert len(tdata) == len(want)
    for a, b in zip(tree_leaves(tdata), tree_leaves(want)):
        assert torch.equal(a, b)
    _close(got.lsq_fit(tdata)[0].numpy(), np.asarray(jest.lsq_fit(to_jax(data))[0]), 1e-9, 1e-9)
