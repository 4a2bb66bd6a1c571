"""Port parity: ``lsqrrecipes_tpu_torch.ops.planar_points`` vs
``lsqrrecipes_tpu.ops.planar_points`` (the f64 structured sphere sweep of
the generic engine, no kernel), and ``tests/test_ops.py``'s checks of it
carried over.

Both packages get the same float64 points and JAX's permutation.  The f64
vote counts bit-equal to the estimator's f64 vote, the double-single vote
equal to the f64 one; fits agree to 1e-9 (XLA and PyTorch sum the three
coordinates of ``rhs`` in their own orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu.ops import planar_points as jpp
from lsqrrecipes_tpu_torch.estimators import ALGEBRAIC, SphereEstimator
from lsqrrecipes_tpu_torch.ops import planar_points as pp
from lsqrrecipes_tpu_torch.ransac import sampling

torch.set_num_threads(2)


def _cloud(seed, n_in, n_out):
    """``n_in`` points on the radius-25 sphere at (5, -2, 11) with N(0, 0.3)
    noise and ``n_out`` uniform in [-40, 40]^3, float64."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_in, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inl = np.array([5.0, -2.0, 11.0]) + 25.0 * d + 0.3 * rng.normal(size=(n_in, 3))
    return np.concatenate([inl, rng.uniform(-40.0, 40.0, (n_out, 3))])


def _perm(key, n):
    return np.asarray(jax.random.permutation(key, n))


def test_sweep_matches_engine_f64():
    # tests/test_ops.py::test_sphere_planar_sweep_matches_engine_f64
    pts = torch.as_tensor(_cloud(31, 80, 20))
    est = SphereEstimator(1.0, 3, ALGEBRAIC)
    groups = 3
    gen = torch.Generator().manual_seed(5)
    perm = torch.randperm(100, generator=gen)
    counts, params = pp.sphere3d_planar_sweep(pts, None, groups, est.delta, perm=perm)
    assert counts.dtype == torch.int32 and params.dtype == torch.float64

    samples = sampling.structured_samples(None, pts, 4, groups, perm=perm)
    planar = pp.planar_samples_reference(pts, None, groups, perm=perm)
    assert torch.equal(planar, samples)

    p_ref, v_ref = est.minimal_fit(samples)
    c_ref = torch.where(v_ref, est.agree(p_ref, pts).sum(-1).to(torch.int32), -1)
    assert torch.equal(counts, c_ref)
    np.testing.assert_allclose(params[v_ref].numpy(), p_ref[v_ref].numpy(), rtol=1e-9, atol=1e-9)

    chunked, _ = pp.sphere3d_planar_sweep(pts, None, groups, est.delta, chunk=100, perm=perm)
    assert torch.equal(chunked, counts)
    f64, _ = pp.sphere3d_planar_sweep(pts, None, groups, est.delta, vote="f64", perm=perm)
    assert torch.equal(f64, c_ref)


@pytest.mark.parametrize("vote", ["ds", "f64"])
@pytest.mark.parametrize("groups,n_in,n_out", [(3, 80, 20), (2, 200, 56)])
def test_sweep_matches_jax(vote, groups, n_in, n_out):
    pts = _cloud(40 + groups, n_in, n_out)
    key = jax.random.PRNGKey(7 + groups)
    with jax.enable_x64(True):
        jc, jparams = jpp.sphere3d_planar_sweep(jnp.asarray(pts), key, groups, 1.0, vote=vote)
        jsamples = jpp.planar_samples_reference(jnp.asarray(pts), key, groups)
    perm = _perm(key, pts.shape[0])
    counts, params = pp.sphere3d_planar_sweep(pts, None, groups, 1.0, vote=vote, perm=perm,
                                              device="cpu")
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    keep = np.asarray(jc) >= 0
    np.testing.assert_allclose(params.numpy()[keep], np.asarray(jparams)[keep], rtol=1e-9,
                               atol=1e-9)
    samples = pp.planar_samples_reference(pts, None, groups, perm=perm, device="cpu")
    np.testing.assert_array_equal(samples.numpy(), np.asarray(jsamples))


def test_ds_vote_equals_f64_vote():
    # tests/test_ops.py::test_ds_vote_equals_f64_vote: a bench-style cloud,
    # then integer points exactly on the band edges (no rounding anywhere).
    pts = _cloud(11, 200, 56)
    perm = torch.randperm(256, generator=torch.Generator().manual_seed(3))
    c_ds, p_ds = pp.sphere3d_planar_sweep(pts, None, 2, 1.0, vote="ds", perm=perm, device="cpu")
    c_f64, p_f64 = pp.sphere3d_planar_sweep(pts, None, 2, 1.0, vote="f64", perm=perm,
                                            device="cpu")
    assert torch.equal(c_ds, c_f64) and torch.equal(p_ds, p_f64)

    centers = torch.tensor([[3.0, 4.0, 0.0, 5.0], [0.0, 0.0, 0.0, 2.0]], dtype=torch.float64)
    ipts = torch.tensor([
        [3.0, 4.0, 3.0],   # dist 3: on the lower edge, must not vote
        [3.0, 4.0, 7.0],   # dist 7: on the upper edge, must not vote
        [3.0, 4.0, 4.0],   # dist 4: inside
        [3.0, 4.0, 6.9],   # inside
        [10.0, 4.0, 0.0],  # dist 7 along x: on the upper edge
        [0.0, 0.0, 0.0],   # dist 5 from sphere 1 (votes); centre of sphere 2
                           # (r == delta): no vote there
        [0.0, 0.0, 1.0],   # votes for both
    ], dtype=torch.float64)
    cnt_ds = pp._ds_vote_counts(pp._ds_point_pack(ipts), centers[:, :3], centers[:, 3], 2.0)
    est = SphereEstimator(2.0, 3, ALGEBRAIC)
    assert torch.equal(cnt_ds, est.vote_counts(centers, ipts))
    assert cnt_ds.tolist() == [4, 1]
    with jax.enable_x64(True):
        jcnt = jpp._ds_vote_counts(jpp._ds_point_pack(jnp.asarray(ipts.numpy())),
                                   jnp.asarray(centers[:, :3].numpy()),
                                   jnp.asarray(centers[:, 3].numpy()), 2.0)
    np.testing.assert_array_equal(cnt_ds.numpy(), np.asarray(jcnt))


def test_band_edge_cases_match_literal_agree():
    # tests/test_ops.py::test_sqrt_free_band_vote_equals_literal_agree, for
    # both votes of the sweep: r < delta (no lower edge), r == delta (a point
    # at the centre must not vote) and points on the band.
    params = torch.tensor([[5.0, -2.0, 11.0, 25.0], [0.0, 0.0, 0.0, 0.25],
                           [0.0, 0.0, 0.0, 1.0]], dtype=torch.float64)
    rng = np.random.default_rng(7)
    extra = [np.zeros((1, 3))]
    for c0, c1, c2, r in params.numpy():
        for rad in (r, r - 1.0, r + 1.0, r - 0.5, r + 0.5):
            if rad > 0:
                extra.append(np.array([[c0 + rad, c1, c2]]))
    pts = torch.as_tensor(np.concatenate([rng.uniform(-40.0, 40.0, (257, 3))] + extra))
    est = SphereEstimator(1.0, 3, ALGEBRAIC)
    literal = est.agree(params, pts).sum(-1).to(torch.int32)
    c, r = params[:, :3], params[:, 3]
    p2 = torch.sum(pts * pts, dim=-1)
    ds = pp._ds_vote_counts(pp._ds_point_pack(pts), c, r, 1.0)
    f64 = pp._f64_vote_counts(pts, p2, c, torch.sum(c * c, dim=-1), r, 1.0)
    assert torch.equal(ds, literal) and torch.equal(f64, literal)
    at_center = torch.zeros((1, 3), dtype=torch.float64)
    one = pp._ds_vote_counts(pp._ds_point_pack(at_center), c, r, 1.0)
    assert one.tolist() == [0, 1, 0]


def test_sweep_draws_its_own_permutation():
    pts = _cloud(12, 400, 100)
    counts, params = pp.sphere3d_planar_sweep(pts, torch.Generator().manual_seed(1), 4, 1.0,
                                              device="cpu")
    best = int(torch.argmax(counts))
    assert counts.shape == (2000,) and int(counts[best]) > 300
    assert np.abs(params[best].numpy() - [5.0, -2.0, 11.0, 25.0]).max() < 1.0


def test_sweep_rejects_bad_arguments():
    pts = _cloud(13, 80, 20)
    with pytest.raises(ValueError, match="vote"):
        pp.sphere3d_planar_sweep(pts, None, 2, 1.0, vote="bf16", device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        pp.sphere3d_planar_sweep(pts, None, 2, 1.0, chunk=64, device="cpu")
    with pytest.raises(ValueError, match=r"\[n, 3\]"):
        pp.sphere3d_planar_sweep(pts[:, :2], None, 2, 1.0, device="cpu")
