"""Port parity: ``lsqrrecipes_tpu_torch.ops.us_fast`` (the crosswire and
pointer fast hypothesize-and-vote) vs ``lsqrrecipes_tpu.ops.us_fast``.

Everything here is float32, made with numpy from a seed.  The polar
iteration and the Euler extraction agree to 1e-5; the minimal fits agree to
1e-5 relative to each parameter's scale on most lanes and to 1e-4 on every
well-posed one (both f32 fits within 1e-4 of the f64 fit of the same
sample: an ill-conditioned f32 QR amplifies the last bits, which the two
frameworks round differently), with ``valid`` equal away from the gates;
the structured sweep and
``fit_and_vote``, fed JAX's permutation and samples, find best counts
within 2 of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu.ops import us_fast as jfast
from lsqrrecipes_tpu.ransac import engine as jengine
from lsqrrecipes_tpu.ransac import sampling as jsampling
from lsqrrecipes_tpu_torch.ops import us_fast
from lsqrrecipes_tpu_torch.ransac import engine
from test_torch_us_calibration import (
    check_truth,
    euler_np,
    gather_np,
    make_estimators,
    make_us_data,
    to_jax,
    to_torch,
)

torch.set_num_threads(2)

KINDS = ("crosswire", "pointer")


def _lanes(m):
    """``[B, 3, 3]`` numpy -> lanes lists of torch and of JAX ``[B]`` arrays."""
    return ([[torch.as_tensor(m[:, i, j]) for j in range(3)] for i in range(3)],
            [[jnp.asarray(m[:, i, j]) for j in range(3)] for i in range(3)])


def _stack(lanes):
    return np.stack([np.stack([np.asarray(x) for x in row], -1) for row in lanes], -2)


def test_polar3_lanes_matches_jax_and_is_a_rotation():
    rng = np.random.default_rng(1)
    w = rng.uniform(0, np.pi, (200, 3))
    m = (euler_np(w[:, 0], w[:, 1], w[:, 2]) + 0.1 * rng.normal(size=(200, 3, 3)))
    m = m.astype(np.float32)
    m[0] = 0.0                                      # det 0: the gate fails
    tl, jl = _lanes(m)
    rt, okt = us_fast.polar3_lanes(tl)
    rj, okj = jfast.polar3_lanes(jl)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert not bool(okt[0]) and bool(okt[1:].all())
    got, want = _stack(rt)[1:], _stack(rj)[1:]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    eye = np.einsum("bij,bkj->bik", got.astype(np.float64), got.astype(np.float64))
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-5)
    assert (np.linalg.det(got) > 0).all()


def test_euler_zyx_plus_lanes_matches_jax():
    rng = np.random.default_rng(2)
    w = rng.uniform(-np.pi / 2, np.pi / 2, (100, 3))
    w[:4, 1] = [np.pi / 2, -np.pi / 2, np.pi / 2 - 1e-3, -np.pi / 2 + 1e-3]   # gimbal zone
    r = euler_np(w[:, 0], w[:, 1], w[:, 2]).astype(np.float32)
    tl, jl = _lanes(r)
    for got, want in zip(us_fast.euler_zyx_plus_lanes(tl), jfast.euler_zyx_plus_lanes(jl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    wz, wy, wx = (x.numpy() for x in us_fast.euler_zyx_plus_lanes(tl))
    np.testing.assert_allclose(euler_np(wz, wy, wx)[4:], r[4:], atol=1e-5)


def _slot_planes(kind, seed, n, b):
    """``(data, idx [b, k], torch planes [k, F, b], JAX planes)`` of f32 samples."""
    data, truth = make_us_data(kind, seed, n)
    k = 4 if kind == "crosswire" else 3
    idx = np.array(jsampling.sample_k_subsets(jax.random.PRNGKey(seed), n, k, b))
    feats = us_fast._KINDS[kind][4](to_torch(data)).numpy()           # [n, F] f32
    jfeats = np.asarray(jfast._KINDS[kind][4](to_jax(data)))
    np.testing.assert_array_equal(feats, jfeats)
    planes = np.moveaxis(feats[idx], 0, -1)                             # [k, F, b]
    return data, truth, idx, torch.as_tensor(planes), jnp.asarray(planes)


@pytest.mark.parametrize("kind", KINDS)
def test_fit_slots_match_jax(kind):
    data, _, idx, tp, jp = _slot_planes(kind, 3, 96, 400)
    k = tp.shape[0]
    pt, vt = us_fast._KINDS[kind][0](tp, k)
    pj, vj = jfast._KINDS[kind][0](jp, k)
    pt, vt, pj, vj = pt.numpy(), vt.numpy(), np.asarray(pj), np.asarray(vj)
    assert pt.shape == pj.shape == (400, us_fast._KINDS[kind][5])
    # The f64 reference fit of the same samples decides which lanes are
    # well posed in f32.
    est = make_estimators(kind)[1]
    p64, v64 = est.minimal_fit(to_torch(gather_np(data, idx)))
    p64, v64 = p64.numpy(), v64.numpy()
    scale = np.abs(p64[v64]).max(axis=0)            # each parameter's scale
    valid = vt & vj & v64
    rel = (np.abs(pt - pj) / scale).max(axis=1)
    well = (valid & ((np.abs(pt - p64) / scale).max(axis=1) < 1e-4)
            & ((np.abs(pj - p64) / scale).max(axis=1) < 1e-4))
    assert valid.mean() > 0.95 and well.mean() > 0.85
    assert (rel[valid] < 1e-5).mean() > 0.85
    assert rel[well].max() < 1e-4
    assert (vt == vj).mean() > 0.99


@pytest.mark.parametrize("kind", KINDS)
def test_fit_slots_flag_degenerate_samples(kind):
    data, _, idx, tp, jp = _slot_planes(kind, 4, 64, 8)
    tp[:, :, 0] = tp[0, :, 0][None]                    # one pose in every slot
    jp = jp.at[:, :, 0].set(jp[0, :, 0][None])
    k = tp.shape[0]
    _, vt = us_fast._KINDS[kind][0](tp, k)
    _, vj = jfast._KINDS[kind][0](jp, k)
    assert not bool(vt[0]) and not bool(vj[0])
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("kind", KINDS)
def test_structured_sweep_matches_jax_on_its_permutation(kind):
    jest, test = make_estimators(kind)
    data, truth = make_us_data(kind, 5, 128)
    key = jax.random.PRNGKey(6)
    cj, mj, pj = jengine.hypothesize_and_vote_structured(jest, to_jax(data), key, 3)
    perm = np.asarray(jax.random.permutation(key, 128))
    ct, mt, pt = engine.hypothesize_and_vote_structured(test, to_torch(data), None, 3, perm=perm)
    assert abs(int(ct) - int(cj)) <= 2 and int(ct) > 90
    assert pt.dtype == torch.float32 and pt.shape == (test.nparams,)
    check_truth(kind, pt.double().numpy(), truth)
    counts, params = test.structured_sweep(to_torch(data), None, 3, perm=perm)
    jcounts, _ = jest.structured_sweep(to_jax(data), key, 3)
    assert counts.shape == (3 * 128,) and params.shape == (3 * 128, test.nparams)
    assert int(counts.max()) == int(ct)
    both = (counts.numpy() >= 0) & (np.asarray(jcounts) >= 0)
    assert both.mean() > 0.95
    assert np.abs(counts.numpy()[both] - np.asarray(jcounts)[both]).max() <= 2


@pytest.mark.parametrize("kind", KINDS)
def test_structured_sweep_planes_are_the_structured_samples(kind):
    data, _ = make_us_data(kind, 7, 64)
    tdata = to_torch(data)
    perm = np.random.default_rng(8).permutation(64)
    planes, feats = us_fast.build_sampling_planes(kind, tdata, None, 5, perm=perm)
    samples = engine.structured_samples(None, tdata, 4 if kind == "crosswire" else 3, 5, perm)
    want = us_fast._samples_to_slot_features(kind, samples).permute(1, 2, 0)
    assert torch.equal(planes, want)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfast._KINDS[kind][3](to_jax(data))),
                               rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_fit_and_vote_matches_jax(kind, monkeypatch):
    jest, test = make_estimators(kind)
    data, _ = make_us_data(kind, 9, 100)
    k = test.k
    idx = np.array(jsampling.sample_k_subsets(jax.random.PRNGKey(10), 100, k, 300))
    samples = gather_np(data, idx)
    cj, _ = jest.fit_and_vote(to_jax(samples), to_jax(data))
    ct, pt = test.fit_and_vote(to_torch(samples), to_torch(data))
    assert ct.shape == (300,) and pt.shape == (300, test.nparams)
    assert abs(int(ct.max()) - int(np.asarray(cj).max())) <= 2
    both = (ct.numpy() >= 0) & (np.asarray(cj) >= 0)
    assert both.mean() > 0.95
    assert np.abs(ct.numpy()[both] - np.asarray(cj)[both]).max() <= 2
    # Chunking over hypotheses changes nothing.
    monkeypatch.setattr(us_fast, "_chunk_size", lambda bsz, n, k=4: 128)
    c2, p2 = test.fit_and_vote(to_torch(samples), to_torch(data))
    assert torch.equal(c2, ct) and torch.equal(p2, pt)
