"""Port parity: ``lsqrrecipes_tpu_torch.ops.vote`` vs ``lsqrrecipes_tpu.ops.vote``.

The JAX Pallas kernels run in interpret mode on the CPU (as the JAX
package's own tests run them); the port's CPU path is the plain version of
each CUDA kernel.  Sphere f32 counts may differ by one at a band edge,
because the two round ``|p|^2 - 2 c.p`` differently (the port in three
FMAs, JAX through a dot product): |delta| <= 1 per hypothesis and >= 99.9%
exactly equal.  Plane counts are equal.  float64
votes (the estimator's plain path) are exact.
"""

import functools
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lsqrrecipes_tpu.estimators import ALGEBRAIC as J_ALGEBRAIC
from lsqrrecipes_tpu.estimators import SphereEstimator as JSphere
from lsqrrecipes_tpu.ops import vote as jvote
from lsqrrecipes_tpu_torch.estimators import ALGEBRAIC, SphereEstimator
from lsqrrecipes_tpu_torch.ops import vote

torch.set_num_threads(2)


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _points(seed, n):
    rng = np.random.default_rng(seed)
    n_in = n * 4 // 5
    d = rng.normal(size=(n_in, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inl = np.array([5.0, -2.0, 11.0]) + 25.0 * d + 0.3 * rng.normal(size=(n_in, 3))
    out = rng.uniform(-40.0, 40.0, size=(n - n_in, 3))
    return np.concatenate([inl, out]).astype(np.float32)


def _params(seed, b):
    rng = np.random.default_rng(seed)
    near = np.concatenate([np.array([5.0, -2.0, 11.0]) + rng.normal(0, 2, (b // 2, 3)),
                           25.0 + rng.normal(0, 2, (b // 2, 1))], 1)
    wide = np.concatenate([rng.uniform(-20, 30, (b - b // 2, 3)),
                           rng.uniform(0.2, 45, (b - b // 2, 1))], 1)
    return np.concatenate([near, wide]).astype(np.float32)


@pytest.mark.parametrize("n", [200, 256])
def test_pack_points_matches_jax(n):
    pts = _points(n, n)
    tj, vj, nj = jvote.pack_points(jnp.asarray(pts))
    tt, vt, nt = vote.pack_points(torch.as_tensor(pts))
    assert nt == nj == n
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("n,delta", [(200, 2.0), (256, 1.0)])
def test_plain_vote_f32_vs_pallas_interpret(interpret_pallas, n, delta):
    pts = _points(1, n)
    params = _params(2, 2048)
    tj, vj, _ = jvote.pack_points(jnp.asarray(pts))
    cj = np.asarray(jvote.sphere_vote_counts(jnp.asarray(params), tj, vj, delta, block_b=256))
    tt, vt, _ = vote.pack_points(torch.as_tensor(pts))
    ct = vote.sphere_vote_counts(torch.as_tensor(params), tt, vt, delta).numpy()
    assert ct.dtype == np.int32
    diff = np.abs(ct.astype(np.int64) - cj)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999
    assert cj.max() > n // 2               # the near half finds the sphere


def test_estimator_vote_counts_f64_exact():
    pts = _points(3, 256).astype(np.float64)
    params = _params(4, 512).astype(np.float64)
    cj = JSphere(1.0, 3, J_ALGEBRAIC).vote_counts(jnp.asarray(params), jnp.asarray(pts))
    ct = SphereEstimator(1.0, 3, ALGEBRAIC).vote_counts(torch.as_tensor(params), torch.as_tensor(pts))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("b", [512, 500])
def test_estimator_vote_counts_f32_dispatch(b):
    # f32 in 3D takes the kernel wrapper at any b (its plain version on the
    # CPU); JAX takes its Pallas kernel at b % 512 == 0 and its own formula
    # otherwise: within one of JAX's either way.
    pts = _points(5, 256)
    params = _params(6, b)
    cj = np.asarray(JSphere(1.0, 3, J_ALGEBRAIC).vote_counts(jnp.asarray(params), jnp.asarray(pts)))
    ct = SphereEstimator(1.0, 3, ALGEBRAIC).vote_counts(torch.as_tensor(params), torch.as_tensor(pts))
    assert np.abs(ct.numpy().astype(np.int64) - cj).max() <= 1


@pytest.mark.parametrize("b", [1, 500, 513])
def test_estimator_f32_vote_goes_through_the_kernel_wrapper_at_any_b(monkeypatch, b):
    # One f32 3D formula at every batch size: the wrapper (B2 on CUDA, its
    # plain version here), so band-edge counts do not depend on b.
    pts = _points(13, 300)
    params = torch.as_tensor(_params(14, b))
    wrapper, calls = vote.sphere_vote_counts, []
    monkeypatch.setattr(vote, "sphere_vote_counts",
                        lambda p, *a, **k: calls.append(p.shape[0]) or wrapper(p, *a, **k))
    got = SphereEstimator(1.0, 3, ALGEBRAIC).vote_counts(params, torch.as_tensor(pts))
    tt, vt, _ = vote.pack_points(torch.as_tensor(pts))
    assert calls == [b]
    assert torch.equal(got, vote.sphere_vote_counts_plain(params, tt, vt, 1.0))


@pytest.mark.parametrize("d", [None, 2, 3])
def test_plain_votes_never_count_padding_columns(d):
    # 100 points, then padding columns that hold copies of them.
    n, n_pad = 100, 640
    pts = _points(15, n) if d is None else _flat_points(15, n, d)
    points_t = torch.as_tensor(np.tile(pts.T, (1, n_pad // n + 1))[:, :n_pad].copy())
    valid = torch.zeros((1, n_pad), dtype=torch.float32)
    valid[0, :n] = 1.0
    alone_t, alone_v = points_t[:, :n].contiguous(), valid[:, :n].contiguous()
    if d is None:
        params = torch.as_tensor(_params(16, 256))
        got = vote.sphere_vote_counts_plain(params, points_t, valid, 1.0)
        alone = vote.sphere_vote_counts_plain(params, alone_t, alone_v, 1.0)
    else:
        params = torch.as_tensor(_plane_params(16, 256, d))
        got = vote.plane_vote_counts_plain(params, points_t, valid, 1.0)
        alone = vote.plane_vote_counts_plain(params, alone_t, alone_v, 1.0)
    assert torch.equal(got, alone) and int(got.max()) > n // 2


def _f32_round(exact):
    """``exact`` (a Fraction) rounded to the nearest float32, ties to even,
    by comparing its two float32 neighbours exactly (finite range only)."""
    lo = np.float32(float(exact))
    while Fraction(float(lo)) > exact:
        lo = np.nextafter(lo, np.float32(-np.inf))
    while Fraction(float(np.nextafter(lo, np.float32(np.inf)))) <= exact:
        lo = np.nextafter(lo, np.float32(np.inf))
    if Fraction(float(lo)) == exact:
        return lo
    hi = np.nextafter(lo, np.float32(np.inf))
    below, above = exact - Fraction(float(lo)), Fraction(float(hi)) - exact
    if below != above:
        return lo if below < above else hi
    return lo if lo.view(np.uint32) % 2 == 0 else hi


def test_plain_vote_rounds_each_fma_once_on_band_edge_points():
    # B2 and its plain version take, about the centre c0 = the packed
    # points' column 0 (p' = p - c0, c' = c - c0), d2 = fma(-2c'z, z',
    # fma(-2c'y, y', fma(-2c'x, x', |p'|^2))) + |c'|^2 in float32.  Held here
    # against that chain with each FMA rounded once from its exact rational
    # value, on points placed on the band edges r +- delta of every
    # hypothesis, where one rounding decides the count.
    rng = np.random.default_rng(25)
    f32 = np.float32
    delta = f32(1.0)
    params = _params(26, 24)
    edge = []
    for c0, c1, c2, r in params.astype(np.float64):
        u = rng.normal(size=(6, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        rad = np.array([r + 1.0, r - 1.0] * 3)[:, None]
        edge.append((np.array([c0, c1, c2]) + rad * u)[rad[:, 0] > 0])
    pts = np.concatenate(edge).astype(np.float32)
    tt, vt, _ = vote.pack_points(torch.as_tensor(pts))
    got = vote.sphere_vote_counts_plain(torch.as_tensor(params), tt, vt, float(delta)).numpy()

    want, near_edge = [], 0
    rel = pts - pts[0]                                          # float32 throughout
    pp = [(x * x + y * y) + z * z for x, y, z in rel]
    for c0, c1, c2, r in params:
        c = [c0 - pts[0, 0], c1 - pts[0, 1], c2 - pts[0, 2]]
        m = [f32(-2.0) * ck for ck in c]
        cc = (c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]
        rp, rm = r + delta, r - delta
        hi2, lo2 = rp * rp, (rm * rm if rm >= 0 else f32(-np.inf))
        count = 0
        for (x, y, z), p2 in zip(rel, pp):
            t = p2
            for mk, v in zip(m, (x, y, z)):
                t = _f32_round(Fraction(float(mk)) * Fraction(float(v)) + Fraction(float(t)))
            d2 = t + cc
            count += bool(lo2 < d2 < hi2)
            near_edge += bool(min(abs(d2 - hi2), abs(d2 - lo2)) <= 16 * np.spacing(hi2))
        want.append(count)
    np.testing.assert_array_equal(got, np.array(want, np.int32))
    assert near_edge >= len(params)           # the edges are really probed


def _far_sphere(offset, n=1024):
    """The far-cloud data model: 80% of ``n`` points on the radius-10 sphere
    about (1, 2, -3) with N(0, 0.2) radial noise, the rest uniform in [-40,
    40]^3 (``default_rng(41)``), every coordinate offset by ``offset``, f32."""
    rng = np.random.default_rng(41)
    n_in = n * 4 // 5
    d = rng.normal(size=(n_in, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inl = np.array([1.0, 2.0, -3.0]) + (10.0 + 0.2 * rng.normal(size=(n_in, 1))) * d
    out = rng.uniform(-40.0, 40.0, size=(n - n_in, 3))
    return (np.concatenate([inl, out]) + offset).astype(np.float32)


@pytest.mark.parametrize("offset", [0.0, 1e3, 1e4])
def test_plain_sphere_vote_holds_far_from_the_origin(offset):
    # Expanded about the origin, |p|^2 - 2 c.p + |c|^2 loses the band to
    # ulp(|p|^2) (32 at 1e4, against (r + 1)^2 - (r - 1)^2 = 40 at r = 10):
    # the uncentred vote counted 525 of 819-820 there.  About the packed
    # points' column 0 every count stays within 2 of the float64 `agree`
    # count and the best within 1 of the float64 maximum.
    pts = torch.as_tensor(_far_sphere(offset))
    rng = np.random.default_rng(42)
    params = np.concatenate([np.array([1.0, 2.0, -3.0]) + offset + rng.normal(0, 0.1, (64, 3)),
                             10.0 + rng.uniform(-0.1, 0.1, (64, 1))], 1)
    params = torch.as_tensor(params.astype(np.float32))
    tt, vt, _ = vote.pack_points(pts)
    got = vote.sphere_vote_counts_plain(params, tt, vt, 1.0)
    want = SphereEstimator(1.0, 3).agree(params.double(), pts.double()).sum(-1)
    assert int(want.max()) > 800
    assert int((got - want).abs().max()) <= 2
    assert abs(int(got.max()) - int(want.max())) <= 1


def test_plain_vote_equals_literal_agree_away_from_edges():
    pts = _points(7, 256)
    params = _params(8, 1024)
    tt, vt, _ = vote.pack_points(torch.as_tensor(pts))
    counts = vote.sphere_vote_counts_plain(torch.as_tensor(params), tt, vt, 1.0).numpy()
    p64, c64 = pts.astype(np.float64), params.astype(np.float64)
    dist = np.linalg.norm(p64[None] - c64[:, None, :3], axis=-1)
    oracle = (np.abs(dist - c64[:, 3:4]) < 1.0).sum(1)
    assert np.abs(counts - oracle).max() <= 1


def test_wrapper_on_cpu_runs_plain_and_cuda_path_rejects_cpu():
    pts = _points(9, 128)
    params = torch.as_tensor(_params(10, 64))
    tt, vt, _ = vote.pack_points(torch.as_tensor(pts))
    np.testing.assert_array_equal(
        vote.sphere_vote_counts(params, tt, vt, 1.0).numpy(),
        vote.sphere_vote_counts_plain(params, tt, vt, 1.0).numpy(),
    )
    with pytest.raises(ValueError, match="CUDA"):
        vote.sphere_vote_counts_cuda(params, tt, vt, 1.0)
    with pytest.raises(ValueError):
        vote.sphere_vote_counts_plain(params[:, :3], tt, vt, 1.0)


def test_numpy_input_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: numpy input legitimately goes to the card")
    pts = _points(11, 128)
    tt, vt, _ = vote.pack_points(torch.as_tensor(pts))
    params = _params(12, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vote.sphere_vote_counts(params, tt, vt, 1.0)
    counts = vote.sphere_vote_counts(params, tt, vt, 1.0, device="cpu")
    assert counts.device.type == "cpu" and counts.shape == (64,)


def _plane_params(seed, b, d):
    """``[b, d+1]`` rows ``[unit normal, offset]``: half near the plane or
    line of :func:`_flat_points`, half random."""
    rng = np.random.default_rng(seed)
    true_n = np.array([0.3, -0.5, 0.81][:d])
    true_n /= np.linalg.norm(true_n)
    n = np.concatenate([true_n + rng.normal(0, 0.05, (b // 2, d)), rng.normal(size=(b - b // 2, d))])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    off = np.concatenate([2.0 + rng.normal(0, 1.0, b // 2), rng.uniform(-20, 20, b - b // 2)])
    return np.concatenate([n, off[:, None]], 1).astype(np.float32)


def _flat_points(seed, n, d):
    """80% points within N(0, 0.3) of the plane (line) n.p = 2, 20% uniform
    outliers in [-40, 40]^d, f32."""
    rng = np.random.default_rng(seed)
    true_n = np.array([0.3, -0.5, 0.81][:d])
    true_n /= np.linalg.norm(true_n)
    n_in = n * 4 // 5
    raw = rng.uniform(-30, 30, (n_in, d))
    inl = raw - (raw @ true_n - 2.0)[:, None] * true_n + 0.3 * rng.normal(size=(n_in, d))
    return np.concatenate([inl, rng.uniform(-40, 40, (n - n_in, d))]).astype(np.float32)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("n,delta_sq", [(200, 4.0), (256, 1.0)])
def test_plane_vote_plain_equals_pallas_interpret(interpret_pallas, d, n, delta_sq):
    pts = _flat_points(20 + d, n, d)
    params = _plane_params(21 + d, 1024, d)
    tj, vj, _ = jvote.pack_points(jnp.asarray(pts))
    cj = np.asarray(jvote.plane_vote_counts(jnp.asarray(params), tj, vj, delta_sq, block_b=256))
    tt, vt, _ = vote.pack_points(torch.as_tensor(pts))
    ct = vote.plane_vote_counts(torch.as_tensor(params), tt, vt, delta_sq).numpy()
    assert ct.dtype == np.int32 and ct.shape == (1024,)
    np.testing.assert_array_equal(ct, cj)
    assert cj.max() > n // 2               # the near half finds the structure


@pytest.mark.parametrize("d", [2, 3])
def test_plane_vote_plain_equals_literal_agree_away_from_edges(d):
    pts = _flat_points(30 + d, 256, d)
    params = _plane_params(31 + d, 512, d)
    tt, vt, _ = vote.pack_points(torch.as_tensor(pts))
    counts = vote.plane_vote_counts_plain(torch.as_tensor(params), tt, vt, 1.0).numpy()
    p64, h64 = pts.astype(np.float64), params.astype(np.float64)
    s = h64[:, :d] @ p64.T - h64[:, d:]
    oracle = (s * s < 1.0).sum(1)
    assert np.abs(counts - oracle).max() <= 1


def test_plane_vote_chunks_and_pads_consistently(monkeypatch):
    pts = _flat_points(40, 200, 3)          # 56 padding columns
    params = torch.as_tensor(_plane_params(41, 300, 3))
    params[0] = torch.tensor([0.0, 0.0, 1.0, 0.0])   # the pads (0, 0, 0) lie on it
    tt, vt, _ = vote.pack_points(torch.as_tensor(pts))
    whole = vote.plane_vote_counts_plain(params, tt, vt, 1.0)
    monkeypatch.setattr(vote, "_PLAIN_CELLS", 7 * tt.shape[1])
    assert torch.equal(vote.plane_vote_counts_plain(params, tt, vt, 1.0), whole)
    assert int(whole[0]) == int((torch.as_tensor(pts)[:, 2].abs() < 1.0).sum())


def test_plane_wrapper_on_cpu_runs_plain_and_cuda_path_rejects_cpu():
    pts = _flat_points(42, 128, 2)
    params = torch.as_tensor(_plane_params(43, 64, 2))
    tt, vt, _ = vote.pack_points(torch.as_tensor(pts))
    np.testing.assert_array_equal(
        vote.plane_vote_counts(params, tt, vt, 1.0).numpy(),
        vote.plane_vote_counts_plain(params, tt, vt, 1.0).numpy(),
    )
    with pytest.raises(ValueError, match="CUDA"):
        vote.plane_vote_counts_cuda(params, tt, vt, 1.0)
    with pytest.raises(ValueError, match="params must be"):
        vote.plane_vote_counts_plain(params[:, :2], tt, vt, 1.0)
    with pytest.raises(ValueError, match="points_t must be"):
        vote.plane_vote_counts_plain(params, tt[:1], vt, 1.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            vote.plane_vote_counts(params.numpy(), tt, vt, 1.0)
