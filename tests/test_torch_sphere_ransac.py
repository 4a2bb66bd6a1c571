"""Port parity: ``lsqrrecipes_tpu_torch.ops.sphere_ransac`` vs
``lsqrrecipes_tpu.ops.sphere_ransac`` (the per-step sweep and the planar
fit-and-vote kernels, run in Pallas interpret mode).

Both packages get the same points and JAX's own slot planes, permutations
and sample planes (the generators differ).  Tolerances: counts within 1 per
hypothesis (the interpreted kernels sum the band products in XLA's order
and may contract into FMAs; the plain versions round as the CUDA kernels do:
the per-step sweep's vote as four exact FMAs, the planar vote's as three)
and the best count equal; the winner's rows within 1e-6 relative.
``linalg.small.fma_f32``, the FMA of both, is held against an exact
rational oracle, and so is the planar vote's whole chain on band-edge
points.  The per-step sweep's independent slot permutations
can put one point into two slots: such a sample's system is exactly
singular, its rounding residue decides the fit in each package alike
arbitrarily, and those lanes are left out of the per-lane comparisons.
"""

import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lsqrrecipes_tpu.ops import sphere_ransac as jsr
from lsqrrecipes_tpu.ops.vote import pack_points as jpack_points
from lsqrrecipes_tpu_torch.estimators import ALGEBRAIC, SphereEstimator
from lsqrrecipes_tpu_torch.linalg.small import fma_f32
from lsqrrecipes_tpu_torch.ops import sphere_ransac as sr
from lsqrrecipes_tpu_torch.ops import vote
from test_torch_vote import _far_sphere

torch.set_num_threads(2)

N, GROUPS = 256, 4


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _cloud(seed, n):
    """80% inliers on the radius-25 sphere at (5, -2, 11) with N(0, 0.3)
    noise, 20% uniform outliers in [-40, 40]^3, f32."""
    rng = np.random.default_rng(seed)
    n_in = n - n // 5
    d = rng.normal(size=(n_in, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inl = np.array([5.0, -2.0, 11.0]) + 25.0 * d + 0.3 * rng.normal(size=(n_in, 3))
    return np.concatenate([inl, rng.uniform(-40, 40, (n - n_in, 3))]).astype(np.float32)


def _packed(pts):
    points_t, valid, _ = vote.pack_points(torch.as_tensor(pts))
    with jax.enable_x64(False):
        jt, jv, _ = jpack_points(jnp.asarray(pts))
    return points_t, valid, jt, jv


def _jax_coords2(pts, key):
    with jax.enable_x64(False):
        return np.asarray(jsr._slot_planes(jnp.asarray(pts), key, pts.shape[0]))


def _distinct_points(samples):
    """Lanes whose four sample points are pairwise distinct."""
    s = np.asarray(samples)
    same = [(s[:, i] == s[:, j]).all(-1) for i in range(4) for j in range(i + 1, 4)]
    return ~np.any(same, axis=0)


def _rows_close(got, want, rtol=1e-6):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


# --------------------------------------------------------- static tables


@pytest.mark.parametrize("groups,n", [(64, 1024), (4, 256), (300, 256), (7, 128)])
def test_mega_group_shifts_identical(groups, n):
    got = sr.mega_group_shifts(groups, n)
    np.testing.assert_array_equal(got, jsr.mega_group_shifts(groups, n))
    assert (got % 128 == 0).all() and got.min() >= 0 and got.max() < n
    if groups <= (n // 128) ** 4:
        assert len({tuple(s) for s in got}) == groups


@pytest.mark.parametrize("groups,k,n", [(4, 4, 256), (9, 4, 1000), (3, 3, 64)])
def test_group_shifts_identical(groups, k, n):
    np.testing.assert_array_equal(sr.group_shifts(groups, k, n), jsr.group_shifts(groups, k, n))


def test_slot_planes_and_reference_samples_identical():
    pts = _cloud(1, N)
    key = jax.random.PRNGKey(5)
    perms = [np.asarray(jax.random.permutation(k, N)) for k in jax.random.split(key, 4)]
    planes = sr._slot_planes(torch.as_tensor(pts), None, N, perms)
    np.testing.assert_array_equal(planes.numpy(), _jax_coords2(pts, key))
    with jax.enable_x64(False):
        want = np.asarray(jsr.reference_mega_samples(jnp.asarray(pts), key, GROUPS))
    got = sr.reference_mega_samples(pts, None, GROUPS, coords2=planes, device="cpu")
    assert got.shape == (GROUPS * N, 4, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_planar_samples_identical():
    pts = _cloud(2, N)
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(False):
        want = np.asarray(jsr.planar_sphere_samples(key, jnp.asarray(pts), GROUPS))
    perm = np.asarray(jax.random.permutation(key, N))
    got = sr.planar_sphere_samples(None, pts, GROUPS, perm=perm, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (12, GROUPS * N)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------ the exact f32 FMA (B7)


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


def _fma_cases():
    """``(a, b, c)`` float32: products on an exact float32 halfway point,
    with c = 0 (a true tie) or a tiny c on either side (where rounding the
    float64 sum first would land on the tie and round the wrong way),
    cancellations, subnormal results, and random triples over a wide range
    of exponents."""
    rng = np.random.default_rng(0)
    cases = []
    for k in (1, 3, 5, 7, 11):
        a = np.float32(1 + 2.0**-12)
        b = np.float32(1 + k * 2.0**-12)
        for c in (0.0, 2.0**-80, -(2.0**-80), 2.0**-60, -(2.0**-60), 2.0**-149, -(2.0**-149)):
            cases.append((a, b, np.float32(c)))
            cases.append((-a, b, np.float32(-c)))
    a = rng.standard_normal(3000) * 2.0 ** rng.integers(-30, 30, 3000)
    b = rng.standard_normal(3000) * 2.0 ** rng.integers(-30, 30, 3000)
    c = rng.standard_normal(3000) * 2.0 ** rng.integers(-60, 60, 3000)
    a, b, c = a.astype(np.float32), b.astype(np.float32), c.astype(np.float32)
    near = -(a[:1000].astype(np.float64) * b[:1000]).astype(np.float32)   # cancellation
    c[:1000] = near * (1 + rng.integers(-3, 4, 1000) * np.float32(2.0**-23))
    tiny = (rng.standard_normal(200) * 2.0**-70).astype(np.float32)       # subnormal results
    cases += list(zip(a, b, c)) + [(t, np.float32(2.0**-70), np.float32(t * 2.0**-100))
                                   for t in tiny]
    return [tuple(np.float32(v) for v in t) for t in cases]


def test_fma_f32_is_the_correctly_rounded_fma():
    cases = _fma_cases()
    a, b, c = (torch.tensor([t[i] for t in cases]) for i in range(3))
    got = fma_f32(a, b, c).numpy()
    want = np.array([_f32_round(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in cases], np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # The tiny addends decide the rounding: rounding the float64 sum first
    # would miss some of them.
    naive = (a.double() * b.double() + c.double()).float().numpy()
    assert (naive.view(np.uint32) != want.view(np.uint32)).sum() >= 10


def test_fma_f32_special_values_and_broadcast():
    inf, nan = float("inf"), float("nan")
    a = torch.tensor([inf, inf, inf, nan, -0.0, -0.0, 1.0, 3e38])
    b = torch.tensor([0.0, 1.0, 1.0, 1.0, 1.0, 1.0, -1.0, 10.0])
    c = torch.tensor([1.0, 1.0, -inf, 1.0, 0.0, -0.0, 1.0, 0.0])
    got = fma_f32(a, b, c)
    assert torch.isnan(got[[0, 2, 3]]).all()
    assert got[1] == inf and got[7] == inf
    assert np.signbit(got[4:7].numpy()).tolist() == [False, True, False]
    assert bool((got[4:7] == 0).all())
    grid = fma_f32(torch.ones(3, 1), torch.arange(4.0), torch.tensor(0.5))
    assert grid.shape == (3, 4) and torch.equal(grid[2], torch.arange(4.0) + 0.5)


# -------------------------------------------------- the per-step sweep (B7)


def _mega_both(seed, key):
    pts = _cloud(seed, N)
    points_t, valid, jt, jv = _packed(pts)
    coords2 = _jax_coords2(pts, key)
    with jax.enable_x64(False):
        shifts = jnp.asarray(jsr.mega_group_shifts(GROUPS, N), jnp.int32)
        jc, jp = jsr._megakernel_call(shifts, jnp.asarray(coords2), jt, jv, GROUPS, 1.0, N,
                                      jt.shape[1])
    counts, params_t = sr.megakernel_call(np.asarray(shifts), coords2, points_t, valid, 1.0,
                                          device="cpu")
    samples = sr.reference_mega_samples(pts, None, GROUPS, coords2=coords2, device="cpu")
    return pts, coords2, counts.numpy(), params_t.numpy(), np.asarray(jc)[0], np.asarray(jp), \
        samples


@pytest.mark.parametrize("seed,key", [(10, 5), (11, 8)])
def test_megakernel_plain_matches_jax(interpret_pallas, seed, key):
    pts, _, counts, params_t, jc, jp, samples = _mega_both(seed, jax.random.PRNGKey(key))
    assert counts.dtype == np.int32 and params_t.shape == (8, GROUPS * N)
    lanes = _distinct_points(samples)
    assert lanes.mean() > 0.9
    assert np.abs(counts - jc)[lanes].max() <= 1
    assert counts.max() == jc.max()
    best = int(np.argmax(counts))
    _rows_close(params_t[:4, best], jp[:4, best])
    np.testing.assert_array_equal(params_t[5:], 0.0)


def test_megakernel_best_count_matches_estimator(interpret_pallas):
    # tests/test_sphere_fastpath.py: the best count against minimal_fit +
    # vote_counts on the same hypotheses, and the winner re-achieves it.
    pts, coords2, counts, params_t, _, _, samples = _mega_both(12, jax.random.PRNGKey(5))
    est = SphereEstimator(1.0, 3, ALGEBRAIC)
    p_ref, v_ref = est.minimal_fit(samples)
    cref = torch.where(v_ref, est.vote_counts(p_ref, torch.as_tensor(pts)), 0).numpy()
    assert counts.max() == cref.max()
    best = int(np.argmax(counts))
    achieved = int(est.agree(torch.as_tensor(params_t[:4, best]), torch.as_tensor(pts)).sum())
    assert achieved == counts[best]


def test_fast_step_matches_jax(interpret_pallas):
    pts = _cloud(13, N)
    points_t, valid, jt, jv = _packed(pts)
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(False):
        jc, jp = jsr.fast_sphere_ransac_step(jnp.asarray(pts), jt, jv, key, GROUPS, 1.0)
    count, params = sr.fast_sphere_ransac_step(pts, points_t, valid, None, GROUPS, 1.0,
                                               coords2=_jax_coords2(pts, key), device="cpu")
    assert count.dtype == torch.int32 and params.shape == (4,)
    assert int(count) == int(jc)
    _rows_close(params.numpy(), np.asarray(jp))
    assert np.abs(params.numpy() - [5.0, -2.0, 11.0, 25.0]).max() < 1.0


def test_fast_sweep_matches_jax_and_carries_strictly(interpret_pallas):
    pts = _cloud(14, N)
    points_t, valid, jt, jv = _packed(pts)
    key = jax.random.PRNGKey(6)
    steps = 3
    with jax.enable_x64(False):
        jc, jp = jsr.fast_sphere_ransac_sweep(jnp.asarray(pts), jt, jv, key, GROUPS, steps, 1.0)
    coords2 = _jax_coords2(pts, key)
    count, params = sr.fast_sphere_ransac_sweep(pts, points_t, valid, None, GROUPS, steps, 1.0,
                                                coords2=coords2, device="cpu")
    assert int(count) == int(jc)
    _rows_close(params.numpy(), np.asarray(jp))
    # The carry: per-step winners (argmax, lowest index), a later step
    # replaces the best only when strictly greater.
    table = sr.mega_group_shifts(steps * GROUPS, N).reshape(steps, GROUPS, 4)
    best = (-1, None)
    for s in range(steps):
        c, p = sr.megakernel_call(table[s], coords2, points_t, valid, 1.0, device="cpu")
        i = int(torch.argmax(c))
        if int(c[i]) > best[0]:
            best = (int(c[i]), p[:4, i])
    assert int(count) == best[0] and torch.equal(params, best[1])


def test_fast_sweep_keeps_the_first_of_equal_steps():
    # Two steps over the same shifts give equal counts: the first one's
    # winner stays.  Reordered planes make the second step's rows differ.
    pts = _cloud(15, 128)
    points_t, valid, _, _ = _packed(pts)
    coords2 = sr._slot_planes(torch.as_tensor(pts), torch.Generator().manual_seed(0), 128)
    one_c, one_p = sr.fast_sphere_ransac_step(pts, points_t, valid, None, 1, 1.0,
                                              coords2=coords2, device="cpu")
    count, params = sr.fast_sphere_ransac_sweep(pts, points_t, valid, None, 1, 2, 1.0,
                                                coords2=coords2, device="cpu")
    # With n = 128 every shift is 0: both steps evaluate the same hypotheses.
    assert int(count) == int(one_c) and torch.equal(params, one_p)


def test_step_and_sweep_need_n_divisible_by_128():
    pts = _cloud(16, 200)
    points_t, valid, _, _ = _packed(pts)
    with pytest.raises(ValueError, match="divisible by 128"):
        sr.fast_sphere_ransac_step(pts, points_t, valid, None, 2, 1.0, device="cpu")
    with pytest.raises(ValueError, match="divisible by 128"):
        sr.fast_sphere_ransac_sweep(pts, points_t, valid, None, 2, 2, 1.0, device="cpu")


def test_step_draws_its_own_planes_on_the_cpu():
    pts = _cloud(17, N)
    points_t, valid, _, _ = _packed(pts)
    count, params = sr.fast_sphere_ransac_step(pts, points_t, valid,
                                               torch.Generator().manual_seed(1), 8, 1.0,
                                               device="cpu")
    assert int(count) > 150
    assert np.abs(params.numpy() - [5.0, -2.0, 11.0, 25.0]).max() < 1.0


# ---------------------------------------- the planar fit-and-vote (B8)


@pytest.mark.parametrize("seed,key", [(20, 3), (21, 9)])
def test_planar_plain_matches_jax(interpret_pallas, seed, key):
    pts = _cloud(seed, N)
    points_t, valid, jt, jv = _packed(pts)
    key = jax.random.PRNGKey(key)
    with jax.enable_x64(False):
        sxyz = jsr.planar_sphere_samples(key, jnp.asarray(pts), GROUPS)
        jc, jp = jsr.sphere_fit_and_vote_planar(sxyz, jt, jv, 1.0, block_b=256)
    counts, params_t = sr.sphere_fit_and_vote_planar(np.asarray(sxyz), points_t, valid, 1.0,
                                                     device="cpu")
    jc, jp = np.asarray(jc), np.asarray(jp)
    assert counts.dtype == torch.int32 and params_t.shape == (8, GROUPS * N)
    assert np.abs(counts.numpy() - jc).max() <= 1
    assert int(counts.max()) == int(jc.max())
    best = int(torch.argmax(counts))
    _rows_close(params_t[:4, best].numpy(), jp[:4, best])
    np.testing.assert_array_equal(params_t[4].numpy(), jp[4])


def test_planar_matches_minimal_fit_and_vote_counts():
    # tests/test_sphere_fastpath.py: squared bounds against the estimator's
    # band vote flip single border points at most.
    pts = _cloud(22, N)
    points_t, valid, _, _ = _packed(pts)
    sxyz = sr.planar_sphere_samples(torch.Generator().manual_seed(4), pts, GROUPS, device="cpu")
    counts, params_t = sr.sphere_fit_and_vote_planar(sxyz, points_t, valid, 1.0)
    est = SphereEstimator(1.0, 3, ALGEBRAIC)
    samples = torch.stack([sxyz[0:4].T, sxyz[4:8].T, sxyz[8:12].T], dim=-1)
    p_ref, v_ref = est.minimal_fit(samples)
    cref = torch.where(v_ref, est.vote_counts(p_ref, torch.as_tensor(pts)), 0)
    assert int((counts - cref).abs().max()) <= 1
    assert int(counts.max()) == int(cref.max())
    assert torch.equal(params_t[4] != 0, ~v_ref)


def _planar_edge_case():
    """``(sxyz, points)``: 24 random circumspheres (four points on a sphere of
    radius 5-30 about U(-20, 20)^3 each, N(0, 0.3) noise) and one exact one,
    (+-5, 0, 0), (0, 5, 0), (0, 0, 5) about the origin; the points are the
    origin first (so the votes' centre c0 is 0 and c' = c), six on each
    random sphere's band edges r +- delta, and four on the exact sphere's:
    (4, 0, 0) and (0, -4, 0) at r - delta, where t = |p'|^2 = lo exactly
    (counted: the lower edge is closed), (6, 0, 0) and (0, 0, -6) at
    r + delta, where t = hi (not counted)."""
    rng = np.random.default_rng(27)
    samples = []
    for _ in range(24):
        c, r = rng.uniform(-20, 20, 3), rng.uniform(5, 30)
        u = rng.normal(size=(4, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        samples.append(c + r * u + 0.3 * rng.normal(size=(4, 3)))
    samples.append(np.array([[5.0, 0, 0], [-5.0, 0, 0], [0, 5.0, 0], [0, 0, 5.0]]))
    samples = np.asarray(samples, np.float32)                      # [B, 4, 3]
    sxyz = torch.as_tensor(np.ascontiguousarray(samples.transpose(2, 1, 0).reshape(12, -1)))
    _, params_t = sr.sphere_fit_and_vote_planar_plain(
        sxyz, *vote.pack_points(torch.zeros((1, 3)))[:2], 1.0)
    edge = [np.zeros((1, 3))]
    for cx, cy, cz, r in params_t[:4, :-1].T.double().numpy():
        u = rng.normal(size=(6, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        edge.append(np.array([cx, cy, cz]) + np.array([r + 1.0, r - 1.0] * 3)[:, None] * u)
    edge.append(np.array([[4.0, 0, 0], [0, -4.0, 0], [6.0, 0, 0], [0, 0, -6.0]]))
    return sxyz, np.concatenate(edge).astype(np.float32)


def test_planar_plain_vote_rounds_each_fma_once_on_band_edge_points():
    # B8 and its plain version take, about c0 = the packed points' column 0,
    # t = fma(-2c'z, z', fma(-2c'y, y', fma(-2c'x, x', |p'|^2))) and count
    # where t < (hi - |c'|^2) - 1e30 deg and t >= lo - |c'|^2.  Held here
    # against that chain with each FMA rounded once from its exact rational
    # value, on points placed on every hypothesis's band edges.
    f32 = np.float32
    sxyz, pts = _planar_edge_case()
    points_t, valid, _ = vote.pack_points(torch.as_tensor(pts))
    counts, params_t = sr.sphere_fit_and_vote_planar_plain(sxyz, points_t, valid, 1.0)
    delta = f32(1.0)
    rel = pts - pts[0]                                           # float32 throughout
    pp = [(x * x + y * y) + z * z for x, y, z in rel]
    want, near_edge = [], 0
    for cx, cy, cz, r, deg in params_t[:5].T.numpy():
        c = [cx - pts[0, 0], cy - pts[0, 1], cz - pts[0, 2]]
        m = [f32(-2.0) * ck for ck in c]
        cc = (c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]
        hi, lo_root = (r + delta) * (r + delta), max(r - delta, f32(0.0))
        upper = (hi - cc) - (f32(1e30) if deg else f32(0.0))
        lower = lo_root * lo_root - cc
        agree = []
        for (x, y, z), p2 in zip(rel, pp):
            t = p2
            for mk, v in zip(m, (x, y, z)):
                t = _f32_round(Fraction(float(mk)) * Fraction(float(v)) + Fraction(float(t)))
            agree.append(bool(lower <= t < upper))
            near_edge += bool(min(abs(t - upper), abs(t - lower)) <= 16 * np.spacing(hi))
        want.append(sum(agree))
    np.testing.assert_array_equal(counts.numpy(), np.array(want, np.int32))
    assert near_edge >= params_t.shape[1]                   # the edges are really probed
    # The exact sphere (r = 5, c = 0, so t = |p'|^2): its two r - delta points
    # sit on the closed lower edge and count, its two r + delta points on the
    # open upper edge do not.
    assert params_t[:5, -1].tolist() == [0.0, 0.0, 0.0, 5.0, 0.0]
    assert pp[-4:] == [f32(16.0), f32(16.0), f32(36.0), f32(36.0)]
    assert agree[-4:] == [True, True, False, False]


def _holds_far_from_the_origin(counts, params_t, samples, pts):
    """Every non-degenerate count within 2 of the float64 `agree` count of
    the same f32 fit, the best within 1 of the float64 maximum over the same
    samples (``minimal_fit`` + ``agree``)."""
    est = SphereEstimator(1.0, 3)
    fit = params_t[4] == 0
    want = est.agree(params_t[:4, fit].T.double(), pts.double()).sum(-1)
    assert int(fit.sum()) > 1500
    assert int((counts[fit] - want).abs().max()) <= 2
    p64, valid = est.minimal_fit(samples.double())
    best = int(torch.where(valid, est.agree(p64, pts.double()).sum(-1), 0).max())
    assert best > 800
    assert abs(int(counts.max()) - best) <= 1


@pytest.mark.parametrize("offset", [0.0, 1e3, 1e4])
def test_plain_megakernel_holds_far_from_the_origin(offset):
    # B7 expands |p - c|^2 about the packed points' column 0, so a cloud far
    # from the origin counts as one near it.
    pts = torch.as_tensor(_far_sphere(offset))
    points_t, valid, _ = vote.pack_points(pts)
    coords2 = sr._slot_planes(pts, torch.Generator().manual_seed(1), 1024)
    counts, params_t = sr.megakernel_call_plain(torch.as_tensor(sr.mega_group_shifts(2, 1024)),
                                                coords2, points_t, valid, 1.0)
    samples = sr.reference_mega_samples(pts, None, 2, coords2=coords2)
    _holds_far_from_the_origin(counts, params_t, samples, pts)


@pytest.mark.parametrize("offset", [0.0, 1e3, 1e4])
def test_plain_planar_vote_holds_far_from_the_origin(offset):
    # B8's two bounds on |p - c|^2, expanded about the packed points' column 0.
    pts = torch.as_tensor(_far_sphere(offset))
    points_t, valid, _ = vote.pack_points(pts)
    sxyz = sr.planar_sphere_samples(torch.Generator().manual_seed(2), pts, 2)
    counts, params_t = sr.sphere_fit_and_vote_planar_plain(sxyz, points_t, valid, 1.0)
    samples = torch.stack([sxyz[0:4].T, sxyz[4:8].T, sxyz[8:12].T], dim=-1)
    _holds_far_from_the_origin(counts, params_t, samples, pts)


def test_invalid_columns_never_vote():
    # valid == 0 marks a column out: the counts equal those on the rest.
    pts = _cloud(23, N)
    points_t, valid, _, _ = _packed(pts)
    keep = torch.ones(N, dtype=torch.bool)
    keep[::3] = False
    masked = valid.clone()
    masked[0, :N] = keep.float()
    sub_t, sub_v, _ = vote.pack_points(torch.as_tensor(pts)[keep])
    sxyz = sr.planar_sphere_samples(torch.Generator().manual_seed(5), pts, 2, device="cpu")
    c_mask, _ = sr.sphere_fit_and_vote_planar(sxyz, points_t, masked, 1.0)
    c_sub, _ = sr.sphere_fit_and_vote_planar(sxyz, sub_t, sub_v, 1.0)
    assert torch.equal(c_mask, c_sub)
    coords2 = sr._slot_planes(torch.as_tensor(pts), torch.Generator().manual_seed(6), N)
    shifts = sr.mega_group_shifts(2, N)
    m_mask, _ = sr.megakernel_call(shifts, coords2, points_t, masked, 1.0)
    m_sub, _ = sr.megakernel_call(shifts, coords2, sub_t, sub_v, 1.0)
    assert torch.equal(m_mask, m_sub)


def test_plain_chunks_without_changing_results(monkeypatch):
    pts = _cloud(24, N)
    points_t, valid, _, _ = _packed(pts)
    sxyz = sr.planar_sphere_samples(torch.Generator().manual_seed(7), pts, 3, device="cpu")
    coords2 = sr._slot_planes(torch.as_tensor(pts), torch.Generator().manual_seed(8), N)
    shifts = sr.mega_group_shifts(3, N)
    whole = (sr.sphere_fit_and_vote_planar(sxyz, points_t, valid, 1.0),
             sr.megakernel_call(shifts, coords2, points_t, valid, 1.0))
    monkeypatch.setattr(sr, "_PLAIN_CELLS", 100 * N)
    chunked = (sr.sphere_fit_and_vote_planar(sxyz, points_t, valid, 1.0),
               sr.megakernel_call(shifts, coords2, points_t, valid, 1.0))
    for (cw, pw), (cc, pc) in zip(whole, chunked):
        assert torch.equal(cw, cc) and torch.equal(pw, pc)


def test_rejects_misshapen_inputs():
    pts = _cloud(25, N)
    points_t, valid, _, _ = _packed(pts)
    with pytest.raises(ValueError, match="sxyz"):
        sr.sphere_fit_and_vote_planar(torch.zeros(11, 8), points_t, valid, 1.0)
    with pytest.raises(ValueError, match="shifts"):
        sr.megakernel_call(np.zeros((2, 3)), torch.zeros(12, 2 * N), points_t, valid, 1.0)
    with pytest.raises(ValueError, match="coords2"):
        sr.megakernel_call(np.zeros((2, 4)), torch.zeros(12, 3), points_t, valid, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        sr.megakernel_call_cuda(torch.zeros((2, 4), dtype=torch.int32), torch.zeros(12, 2 * N),
                                points_t, valid, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        sr.sphere_fit_and_vote_planar_cuda(torch.zeros(12, 8), points_t, valid, 1.0)
