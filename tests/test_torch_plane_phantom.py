"""Port parity: the plane-phantom ultrasound calibration estimator (k = 31)
of ``lsqrrecipes_tpu_torch`` vs ``lsqrrecipes_tpu``, and the drivers on its
data.

Data come from the JAX package's ``make_plane_phantom_data`` (the
reference's model, ``PlanePhantomUSCalibrationParametersEstimatorTest.cxx:
130-160``) and go to the port through ``interop.data_to_torch``, float64.
The homogeneous null vector is defined up to sign, so ``R1_row3`` and
``t1_z`` (and the derived entries that carry ``R1_row3``) are compared up to
one common sign; t3, the R3 angles, the scales, ``valid``, the ``agree``
masks and the vote counts directly.  Minimal and ANALYTIC fits agree with
JAX to 1e-7, ITERATIVE ones to 1e-6; recovery limits are the JAX tests':
1e-5 / 1e-7 rad on clean minimal samples, 3.0 in translation and 5 degrees
on noisy data (``tests/test_us_calibration.py:136-153``).  The f32 fast path
(the plain version of the subspace kernel, a float64 Rayleigh-Ritz) is held
to the f64 ``minimal_fit`` + ``agree`` counts within 2 with equal maxima on
samples with a unique null direction (sigma_30 >= 4 sigma_31), and to the
JAX package's fast path within 1 everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu.estimators import us_calibration as jus
from lsqrrecipes_tpu.geometry import Frame as JFrame
from lsqrrecipes_tpu.ransac import engine as jengine
from lsqrrecipes_tpu.ransac.sampling import structured_samples as jstructured_samples
from lsqrrecipes_tpu.synthetic import make_plane_phantom_data
from lsqrrecipes_tpu_torch import estimators as est_mod
from lsqrrecipes_tpu_torch import interop
from lsqrrecipes_tpu_torch.estimators import us_calibration as tus
from lsqrrecipes_tpu_torch.geometry import Frame
from lsqrrecipes_tpu_torch.linalg import LMConfig
from lsqrrecipes_tpu_torch.ops import us_fast
from lsqrrecipes_tpu_torch.ransac import engine
from lsqrrecipes_tpu_torch.tree import tree_leaves

torch.set_num_threads(2)

M_X, M_Y = 0.143, 0.139
# Entries that carry the null vector's sign: w1_y, w1_x (through R1_row3),
# t1_z and the 30 derived ones; the others (t3, R3 angles, scales) do not.
_SIGNED = np.r_[2, 11:41]
_UNSIGNED = np.r_[3:11]


def _ests(ls_type=tus.ITERATIVE, delta=1.0):
    return jus.PlanePhantomUSCalibrationEstimator(delta, ls_type), \
        tus.PlanePhantomUSCalibrationEstimator(delta, ls_type)


def _torch(data):
    return interop.data_to_torch(data, device="cpu")


def _normal(params):
    w1_y, w1_x = params[..., 0], params[..., 1]
    return np.stack([-np.sin(w1_y), np.cos(w1_y) * np.sin(w1_x),
                     np.cos(w1_y) * np.cos(w1_x)], axis=-1)


def _sign(a, b):
    """+1 / -1 per row: the sign that best aligns the plane normals."""
    return np.where(np.sum(_normal(a) * _normal(b), axis=-1) >= 0, 1.0, -1.0)


def _close_up_to_sign(got, want, tol):
    got, want = np.atleast_2d(got), np.atleast_2d(want)
    s = _sign(got, want)[:, None]
    np.testing.assert_allclose(_normal(got) * s, _normal(want), rtol=0, atol=tol)
    np.testing.assert_allclose(got[:, _SIGNED] * s, want[:, _SIGNED], rtol=tol, atol=tol)
    np.testing.assert_allclose(got[:, _UNSIGNED], want[:, _UNSIGNED], rtol=tol, atol=tol)


def _rotation_angle(r_a, r_b):
    return float(np.arccos(np.clip((np.trace(r_a.T @ r_b) - 1.0) / 2.0, -1.0, 1.0)))


def _check_truth(params, true, trans_eps, ang_eps):
    """The JAX test's ``_check_plane_phantom`` (normal and offset up to sign)."""
    params = np.asarray(params, np.float64)
    normal = _normal(params)
    truth = np.asarray(true["r1_row3"])
    sign = 1.0 if normal @ truth >= 0 else -1.0
    assert float(np.arccos(np.clip(sign * normal @ truth, -1.0, 1.0))) < ang_eps
    np.testing.assert_allclose(sign * params[2], float(true["t1_z"]), atol=trans_eps)
    np.testing.assert_allclose(params[3:6], np.asarray(true["t3"]), atol=trans_eps)
    r_est = tus._euler_zyx_matrix(*(torch.tensor(params[i]) for i in (6, 7, 8))).numpy()
    assert _rotation_angle(r_est, np.asarray(true["r3"])) < ang_eps
    np.testing.assert_allclose(params[9:11], [M_X, M_Y], atol=1.0)


def _outlier_data(key, n, frac, sigma=0.5):
    """The JAX tests' outlier model: the last ``frac`` of the poses shoved
    20-60 along the plane normal with a random sign."""
    noisy, _, true = make_plane_phantom_data(jax.random.PRNGKey(key), n=n, sigma=sigma)
    frames, q = noisy
    n_out = int(n * frac)
    k1, k2 = jax.random.split(jax.random.PRNGKey(key + 1))
    shift = jax.random.uniform(k1, (n_out, 1), minval=20.0, maxval=60.0) * jnp.sign(
        jax.random.normal(k2, (n_out, 1)))
    frames = JFrame(frames.r, frames.t.at[-n_out:].set(frames.t[-n_out:] + shift * true["r1_row3"]))
    return (frames, q), true, n_out


def test_registry_sizes_and_interop():
    jest = jus.PlanePhantomUSCalibrationEstimator(2.5, jus.ANALYTIC, jus.LMConfig(max_iters=50))
    got = interop.estimator_from_attrs(jest)
    assert type(got) is tus.PlanePhantomUSCalibrationEstimator
    assert got is not None and "us_plane_phantom" in est_mod.names()
    assert est_mod.PlanePhantomUSCalibrationEstimator is tus.PlanePhantomUSCalibrationEstimator
    assert (got.k, got.nparams, got.nparams_lsq) == (jest.k, jest.nparams, jest.nparams_lsq) == \
        (31, 41, 41)
    assert (got.delta, got.delta_squared, got.ls_type) == (2.5, 6.25, tus.ANALYTIC)
    assert got.lm_config == LMConfig(max_iters=50)
    assert getattr(got, "fused_family", None) is None     # ransac_fused_sweep falls back
    with pytest.raises(ValueError, match="least-squares type"):
        tus.PlanePhantomUSCalibrationEstimator(1.0, "geometric")
    noisy, _, _ = make_plane_phantom_data(jax.random.PRNGKey(3), n=40)
    tdata = _torch(noisy)
    assert isinstance(tdata[0], Frame)
    for a, b in zip(tree_leaves(tdata), (noisy[0].r, noisy[0].t, noisy[1])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_minimal_fit_clean_recovers_the_truth():
    """JAX's ``test_plane_phantom_minimal_clean`` (1e-5 / 1e-7)."""
    _, clean, true = make_plane_phantom_data(jax.random.PRNGKey(4), n=31)
    _, test = _ests(delta=1.0)
    params, valid = test.minimal_fit(_torch(clean))
    assert bool(valid) and params.shape == (41,)
    _check_truth(params.numpy(), true, 1e-5, 1e-7)
    assert bool(test.agree(params, _torch(clean)).all())


def test_minimal_fit_matches_jax_batched():
    noisy, _, _ = make_plane_phantom_data(jax.random.PRNGKey(6), n=64)
    jest, test = _ests()
    samples = jstructured_samples(jax.random.PRNGKey(7), noisy, 31, 1)
    samples = jax.tree_util.tree_map(lambda a: a[:40], samples)
    pj, vj = jax.vmap(jest.minimal_fit)(samples)
    pt, vt = test.minimal_fit(_torch(samples))
    assert pt.shape == (40, 41)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert bool(vt.all())
    _close_up_to_sign(pt.numpy(), np.asarray(pj), 1e-7)


@pytest.mark.parametrize("ls_type", [tus.ANALYTIC, tus.ITERATIVE])
def test_lsq_fit_noisy_matches_jax_and_the_truth(ls_type):
    """JAX's ``test_plane_phantom_lsq_noisy``: 3.0 / 5 degrees."""
    noisy, _, true = make_plane_phantom_data(jax.random.PRNGKey(5))
    jest, test = _ests(ls_type)
    pj, vj = jest.lsq_fit(noisy)
    pt, vt = test.lsq_fit(_torch(noisy))
    assert bool(vt) == bool(vj) is True
    assert pt.shape == (41,) and pt.dtype == torch.float64
    _close_up_to_sign(pt.numpy(), np.asarray(pj), 1e-7 if ls_type == tus.ANALYTIC else 1e-6)
    _check_truth(pt.numpy(), true, 3.0, np.radians(5.0))


def test_lsq_fit_masked_and_too_few_observations():
    data, true, n_out = _outlier_data(30, 80, 0.15)
    jest, test = _ests()
    mask = np.arange(80) < 80 - n_out
    pj, vj = jest.lsq_fit(data, jnp.asarray(mask))
    pt, vt = test.lsq_fit(_torch(data), torch.as_tensor(mask))
    assert bool(vt) == bool(vj) is True
    _close_up_to_sign(pt.numpy(), np.asarray(pj), 1e-6)
    _check_truth(pt.numpy(), true, 3.0, np.radians(5.0))
    few = np.arange(80) < 20                          # fewer observations than k
    _, vj = jest.lsq_fit(data, jnp.asarray(few))
    _, vt = test.lsq_fit(_torch(data), torch.as_tensor(few))
    assert bool(vt) == bool(vj) is False


def test_jacobian_and_pack_match_jax():
    noisy, _, _ = make_plane_phantom_data(jax.random.PRNGKey(8), n=30)
    jest, _ = _ests(tus.ANALYTIC)
    params, _ = jest.lsq_fit(noisy)
    x = np.asarray(params)[:11] + 0.01
    want = np.asarray(jus._plane_phantom_jacobian(jnp.asarray(x), noisy))
    got = tus._plane_phantom_jacobian(torch.as_tensor(x), _torch(noisy)).numpy()
    assert got.shape == (30, 11)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tus._plane_phantom_residual(torch.as_tensor(x), _torch(noisy)).numpy(),
                               np.asarray(jus._plane_phantom_residual(jnp.asarray(x), noisy)),
                               rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(tus._pack_phantom(torch.as_tensor(x)).numpy(),
                               np.asarray(jus._pack_phantom(jnp.asarray(x))), rtol=1e-12, atol=1e-12)


def test_agree_votes_and_distances_match_jax(monkeypatch):
    data, _, _ = _outlier_data(9, 100, 0.2)
    jest, test = _ests()
    params, _ = jest.lsq_fit(data, jnp.asarray(np.arange(100) < 80))
    rng = np.random.default_rng(7)
    batch = np.asarray(params) + rng.normal(0, 1e-3, (32, 41))
    batch[0] = np.asarray(params)
    want = jax.vmap(lambda p: jest.agree(p, data))(jnp.asarray(batch))
    got = test.agree(torch.as_tensor(batch), _torch(data))
    assert got.shape == (32, 100)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 70 < int(got[0].sum()) <= 100
    counts = test.vote_counts(torch.as_tensor(batch), _torch(data))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(jest.vote_counts(jnp.asarray(batch), data)))
    np.testing.assert_array_equal(counts.numpy(), got.sum(-1).numpy())
    monkeypatch.setattr(tus, "_VOTE_CELLS", 3 * 100)     # chunks of 3 hypotheses
    np.testing.assert_array_equal(test.vote_counts(torch.as_tensor(batch), _torch(data)).numpy(),
                                  counts.numpy())
    dj = jest.distance_statistics(params, data)
    dt = test.distance_statistics(torch.as_tensor(np.array(params)), _torch(data))
    for a, b in zip(dt, dj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)


def test_lm_matches_minpack_lmder():
    """``tests/test_lm_parity.py:104``: from the ANALYTIC start, the port's LM
    lands on MINPACK ``lmder``'s minimum (relative cost within 1e-10)."""
    scipy_opt = pytest.importorskip("scipy.optimize")
    noisy, _, _ = make_plane_phantom_data(jax.random.PRNGKey(4), n=50)
    _, test = _ests(tus.ANALYTIC)
    tdata = _torch(noisy)
    params, ok = test.lsq_fit(tdata)
    assert bool(ok)
    x0 = params[:11]
    tight = LMConfig(ftol=1e-15, xtol=1e-15, gtol=1e-15, max_iters=500)
    ours = tus.levenberg_marquardt(tus._plane_phantom_residual, tus._plane_phantom_jacobian, x0,
                                   tdata, config=tight)
    ref = scipy_opt.least_squares(
        lambda x: tus._plane_phantom_residual(torch.as_tensor(x), tdata).numpy(), x0.numpy(),
        jac=lambda x: tus._plane_phantom_jacobian(torch.as_tensor(x), tdata).numpy(),
        method="lm", ftol=1e-15, xtol=1e-15, gtol=1e-15, max_nfev=5000)
    assert bool(ours.converged)
    assert abs(float(ours.cost) - ref.cost) / max(ref.cost, 1e-30) < 1e-10


def test_fast_path_counts_match_f64_and_jax():
    """JAX's ``test_us_fast_path_counts_match_f64[plane_phantom]``: the f32
    fast path against the f64 ``minimal_fit`` + ``agree`` on one hypothesis
    set, and against JAX's fast path."""
    noisy, _, _ = make_plane_phantom_data(jax.random.PRNGKey(0), n=64)
    jest, test = _ests()
    samples = jstructured_samples(jax.random.PRNGKey(1), noisy, 31, 4)
    tdata, tsamples = _torch(noisy), _torch(samples)
    counts, params = test.fit_and_vote(tsamples, tdata)
    assert counts.shape == (256,) and params.shape == (256, 41)
    p64, v64 = test.minimal_fit(tsamples)
    c64 = torch.where(v64, test.agree(p64, tdata).sum(-1), -1)
    assert int((counts - c64).abs().max()) <= 2
    assert int(counts.max()) == int(c64.max()) > 0
    cj, _ = jest.fit_and_vote(samples, noisy)
    assert int(np.abs(counts.numpy() - np.asarray(cj)).max()) <= 2
    assert int(counts.max()) == int(np.asarray(cj).max())


def test_fast_path_parts_from_f64_only_without_a_unique_null_direction():
    """At 2,048 hypotheses a few samples have sigma_30 ~ sigma_31: their null
    direction is arbitrary to rounding, and the f32 subspace + Rayleigh-Ritz
    may pick another plane than the f64 SVD (by tens of votes).  The JAX
    package's fast path does the same on the same samples: the port stays
    within 1 of it everywhere, and within 2 of the f64 fit wherever
    sigma_30 >= 4 sigma_31."""
    noisy, _, _ = make_plane_phantom_data(jax.random.PRNGKey(31), n=64)
    jest, test = _ests()
    samples = jstructured_samples(jax.random.PRNGKey(32), noisy, 31, 32)
    tdata, tsamples = _torch(noisy), _torch(samples)
    counts, _ = test.fit_and_vote(tsamples, tdata)
    cj, _ = jest.fit_and_vote(samples, noisy)
    assert int(np.abs(counts.numpy() - np.asarray(cj)).max()) <= 1
    p64, v64 = test.minimal_fit(tsamples)
    c64 = torch.where(v64, test.agree(p64, tdata).sum(-1), -1)
    frames, q = tsamples
    a = torch.cat([(q[..., 0, None, None] * frames.r).flatten(-2),
                   (q[..., 1, None, None] * frames.r).flatten(-2), frames.r.flatten(-2),
                   frames.t, torch.ones_like(q[..., :1])], dim=-1)
    sv = torch.linalg.svdvals(a)
    unique = sv[:, 29] >= 4.0 * sv[:, 30]
    assert unique.float().mean() > 0.95
    assert int((counts - c64).abs()[unique].max()) <= 2
    assert int(counts.max()) == int(c64.max())


def test_fast_path_rejects_degenerate_samples():
    """JAX's ``test_plane_phantom_fast_path_rejects_degenerate_samples``: one
    observation repeated 31 times is gated (count -1), params finite."""
    noisy, _, _ = make_plane_phantom_data(jax.random.PRNGKey(29), n=40)
    _, test = _ests()
    tdata = _torch(noisy)
    idx = torch.arange(8)[:, None].expand(8, 31)
    samples = engine._gather(tdata, idx)
    counts, params = test.fit_and_vote(samples, tdata)
    assert bool((counts == -1).all()) and bool(torch.isfinite(params).all())


def test_structured_sweep_matches_jax_on_its_permutation():
    data, true, _ = _outlier_data(40, 64, 0.1)
    jest, test = _ests(delta=2.0)
    key = jax.random.PRNGKey(41)
    jcounts, _ = jest.structured_sweep(data, key, 8)
    perm = np.asarray(jax.random.permutation(key, 64))
    counts, params = test.structured_sweep(_torch(data), None, 8, perm=perm)
    assert counts.shape == (512,) and params.shape == (512, 41)
    both = (counts.numpy() >= 0) & (np.asarray(jcounts) >= 0)
    assert both.mean() > 0.95
    assert np.abs(counts.numpy()[both] - np.asarray(jcounts)[both]).max() <= 2
    assert int(counts.max()) == int(np.asarray(jcounts).max())
    # Chunking over hypotheses changes nothing.
    planes, feats = us_fast.build_sampling_planes("plane_phantom", _torch(data), None, 8, perm=perm)
    c2, p2 = us_fast._fit_and_vote_planes("plane_phantom", test.delta_squared, 128, planes, feats)
    assert torch.equal(c2, counts) and torch.equal(p2, params)


def test_gather_ransac_outliers():
    """JAX's ``test_plane_phantom_ransac_outliers``: 15% outliers, 16,384
    gathered hypotheses (the batched f64 31x31 SVD minimal fit), delta 2."""
    data, true, n_out = _outlier_data(16, 80, 0.15)
    _, test = _ests(delta=2.0)
    res = engine.ransac(test, _torch(data), torch.Generator().manual_seed(18),
                        num_hypotheses=16384)
    assert bool(res.valid) and float(res.inlier_fraction) > 0.7
    assert int(res.consensus[-n_out:].sum()) == 0
    _check_truth(res.params.numpy(), true, 3.0, np.radians(5.0))


def test_structured_and_fused_drivers_recover_the_truth():
    """JAX's ``test_plane_phantom_structured_ransac_outliers`` (16,384
    hypotheses, 15% outliers, delta 2); ``ransac_fused_sweep`` has no
    phantom family and runs the same structured sweep."""
    data, true, n_out = _outlier_data(26, 64, 0.15)
    _, test = _ests(delta=2.0)
    tdata = _torch(data)
    res = engine.ransac_structured(test, tdata, torch.Generator().manual_seed(28),
                                   num_hypotheses=16384)
    assert bool(res.valid) and float(res.inlier_fraction) > 0.7
    assert int(res.consensus[-n_out:].sum()) == 0
    assert int(res.best_count) == int(res.consensus.sum())
    _check_truth(res.params.numpy(), true, 3.0, np.radians(5.0))
    fused = engine.ransac_fused_sweep(test, tdata, torch.Generator().manual_seed(28),
                                      num_hypotheses=16384)
    assert torch.equal(fused.consensus, res.consensus)
    assert torch.equal(fused.params, res.params)


def test_ransac_on_jax_indices_matches_jax():
    data, _, _ = _outlier_data(50, 64, 0.1)
    jest, test = _ests(tus.ANALYTIC, delta=2.0)
    key = jax.random.PRNGKey(51)
    idx = np.array(jengine._sample(key, 64, 31, 256, "auto"))
    cj, mj, pj = jengine.hypothesize_and_vote(jest, data, jnp.asarray(idx))
    ct, mt, pt = engine.hypothesize_and_vote(test, _torch(data), torch.as_tensor(idx))
    assert int(ct) == int(cj) > 40
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    _close_up_to_sign(pt.numpy(), np.asarray(pj), 1e-7)
