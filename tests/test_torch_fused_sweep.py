"""Port parity: ``lsqrrecipes_tpu_torch.ops.fused_sweep`` (sphere3d) vs
``lsqrrecipes_tpu.ops.fused_sweep``.

The port is fed JAX's own permutations, rebuilt here from the key exactly
as ``fused_sweep.py`` draws them, so both evaluate the identical hypothesis
set: host-side planes and samples are bitwise equal; the best count agrees
within one (the f32 band product sums in another order) and, where the
winner is the same hypothesis, its params agree to rtol 1e-5.  The JAX
kernel runs in interpret mode on the CPU; the port's CPU path is the plain
version of the CUDA kernel, which votes with four FMAs per cell, each
rounded once as CUDA's ``__fmaf_rn``.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu.ops import fused_sweep as jfs
from lsqrrecipes_tpu_torch.estimators import SphereEstimator
from lsqrrecipes_tpu_torch.ops import fused_sweep as fs
from test_torch_vote import _f32_round, _far_sphere

torch.set_num_threads(2)


def _cloud(seed, n):
    rng = np.random.default_rng(seed)
    n_in = n * 4 // 5
    d = rng.normal(size=(n_in, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inl = np.array([5.0, -2.0, 11.0]) + 25.0 * d + 0.3 * rng.normal(size=(n_in, 3))
    out = rng.uniform(-40.0, 40.0, size=(n - n_in, 3))
    return np.concatenate([inl, out]).astype(np.float32)


def _jax_randomness(key, n, n_fit, k_slots=4, vote_subsample=0):
    """(slot-plane perms [4k, n_fit], vote perm or None), drawn as
    ``fused_sweep`` / ``slot_planes`` draw them from ``key``."""
    vote_perm = None
    if vote_subsample:
        key, sub = jax.random.split(key)
        vote_perm = np.asarray(jax.random.permutation(sub, n))
    keys = jax.random.split(key, 4 * k_slots)
    perms = np.stack([np.asarray(jax.random.permutation(keys[i], n_fit))
                      for i in range(4 * k_slots)])
    return perms, vote_perm


@pytest.mark.parametrize("n", [128, 200, 256, 1000, 1024, 4096])
def test_static_sizes_match_jax(n):
    nf = fs.fit_size(n, 4)
    assert nf == jfs.fit_size(n, 4)
    assert fs.sweep_static(nf, 4) == jfs.sweep_static(nf, 4)


def test_fit_size_limit_and_supports_data():
    with pytest.raises(ValueError):
        fs.fit_size(8192, 4)
    assert fs.supports_data("sphere3d", torch.zeros(4096, 3))
    assert not fs.supports_data("sphere3d", torch.zeros(4097, 3))
    assert not fs.supports_data("sphere3d", torch.zeros(256, 2))
    assert not fs.supports_data("pivot", torch.zeros(256, 3))


@pytest.mark.parametrize("n", [256, 1024])
def test_shift_units_match_jax(n):
    m, b, mask = fs.sweep_static(n, 4)
    groups = np.arange(0, 5000, 7)
    for j in range(4):
        want = [int(jfs.shift_units(g, j, b, m, mask)) for g in groups[:64]]
        assert [fs.shift_units(int(g), j, b, m, mask) for g in groups[:64]] == want
        # The tensor form (plain sweep) equals the int form everywhere.
        got_t = fs.shift_units(torch.as_tensor(groups), j, b, m, mask).tolist()
        assert got_t == [fs.shift_units(int(g), j, b, m, mask) for g in groups]


@pytest.mark.parametrize("n", [256, 200])
def test_host_side_bitwise_equal(n):
    pts = _cloud(n, n)
    key = jax.random.PRNGKey(3)
    n_fit = fs.fit_size(n, 4)
    perms, _ = _jax_randomness(key, n, n_fit)
    feats_j = jfs._pad_features(jnp.asarray(pts), n_fit)
    planes_j = np.asarray(jfs.slot_planes(feats_j, key, 4))
    feats_t = fs._pad_features(torch.as_tensor(pts), n_fit)
    np.testing.assert_array_equal(feats_t.numpy(), np.asarray(feats_j))
    np.testing.assert_array_equal(fs.slot_planes(feats_t, perms, 4).numpy(), planes_j)
    np.testing.assert_array_equal(
        fs.pack_feature_rows(torch.as_tensor(pts), True).numpy(),
        np.asarray(jfs.pack_feature_rows(jnp.asarray(pts), True)),
    )
    np.testing.assert_array_equal(
        fs.reference_samples("sphere3d", torch.as_tensor(pts), perms, 5).numpy(),
        np.asarray(jfs.reference_samples("sphere3d", jnp.asarray(pts), key, 5)),
    )


CASES = [  # (n, total_groups, groups_per_step, vote_subsample)
    (256, 6, 1, 0),
    (256, 6, 4, 0),      # 6 groups, gps 4: 8 groups evaluated
    (256, 6, 1, 128),
    (200, 6, 1, 0),      # replication padding + guard columns
]


@pytest.mark.parametrize("n,groups,gps,subsample", CASES)
def test_fused_sweep_matches_jax(n, groups, gps, subsample):
    pts = _cloud(100 + n + gps + subsample, n)
    key = jax.random.PRNGKey(7 + gps + subsample)
    cj, pj = jfs.fused_sweep("sphere3d", jnp.asarray(pts), key, groups, 1.0,
                             groups_per_step=gps, vote_subsample=subsample)
    cj, pj = int(cj), np.asarray(pj)
    n_fit = fs.fit_size(n, 4)
    perms, vote_perm = _jax_randomness(key, n, n_fit, vote_subsample=subsample)
    tpts = torch.as_tensor(pts)
    ct, pt = fs.fused_sweep("sphere3d", tpts, None, groups, 1.0, groups_per_step=gps,
                            vote_subsample=subsample, perms=perms, vote_perm=vote_perm)
    assert abs(int(ct) - cj) <= 1
    assert int(ct) > (n * 4 // 5) * (subsample or n) // n // 2

    # Locate both winners among the evaluated hypotheses.
    coords, p, nf, cols = fs.sweep_inputs("sphere3d", tpts, None, subsample,
                                          perms=perms, vote_perm=vote_perm)
    evaluated = -(-groups // gps) * gps
    _, _, index_t = fs.sphere3d_sweep_plain(coords, p, nf, evaluated, cols, 1.0)
    samples = fs.reference_samples("sphere3d", tpts, perms, evaluated)
    pts_k = [[samples[:, j, c] for c in range(3)] for j in range(4)]
    center, r, _, _ = fs.sphere3d_fit(pts_k, torch.tensor(1.0))
    fits = torch.stack(center + [r], dim=1).numpy()
    np.testing.assert_array_equal(fits[int(index_t)], pt.numpy())
    gap = np.abs(fits - pj).max(axis=1)
    index_j = int(np.argmin(gap))
    assert gap[index_j] <= 1e-4 * np.abs(pj).max()   # JAX's winner is in the set
    if index_j == int(index_t):
        np.testing.assert_allclose(pt.numpy(), pj, rtol=1e-5)


def test_plain_sweep_ties_go_to_lowest_index():
    # The four permutations of each slot are equal, so every window of a
    # slot holds the same points and every group repeats group 0's
    # hypotheses: all groups tie, and the winner must stay in group 0.
    pts = torch.as_tensor(_cloud(5, 128))
    rng = np.random.default_rng(0)
    sigma = [rng.permutation(128) for _ in range(4)]
    perms = np.stack([sigma[j] for j in range(4) for _ in range(4)])
    coords, p, nf, cols = fs.sweep_inputs("sphere3d", pts, None, perms=perms)
    c1, p1, i1 = fs.sphere3d_sweep_plain(coords, p, nf, 1, cols, 1.0)
    c5, p5, i5 = fs.sphere3d_sweep_plain(coords, p, nf, 5, cols, 1.0)
    assert int(c1) > 0
    assert (int(c5), int(i5)) == (int(c1), int(i1))
    assert torch.equal(p1, p5)


def test_degenerate_lanes_count_zero():
    # All four slots see the same point: every hypothesis is degenerate, so
    # every count is 0 and the winner is hypothesis 0 (the TPU rule).
    pts = torch.as_tensor(np.tile(_cloud(6, 1), (128, 1)))
    count, _, index = fs.sphere3d_sweep_plain(
        *fs.sweep_inputs("sphere3d", pts, torch.Generator().manual_seed(0))[:2],
        128, 4, 128, 1.0,
    )
    assert int(count) == 0 and int(index) == 0


def test_generator_drives_the_sweep():
    pts = torch.as_tensor(_cloud(8, 256))
    a = fs.fused_sweep("sphere3d", pts, torch.Generator().manual_seed(1), 4, 1.0)
    b = fs.fused_sweep("sphere3d", pts, torch.Generator().manual_seed(1), 4, 1.0)
    assert int(a[0]) == int(b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError):
        fs.fused_sweep("pivot", pts, None, 4, 1.0)
    with pytest.raises(ValueError):
        fs.fused_sweep("sphere3d", pts, None, 4, 1.0, vote_subsample=100)


def test_cuda_sweep_path_rejects_cpu_tensors():
    pts = torch.as_tensor(_cloud(9, 128))
    coords, p, nf, cols = fs.sweep_inputs("sphere3d", pts, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="CUDA"):
        fs.sphere3d_sweep_cuda(coords, p, nf, 4, cols, 1.0)


def test_pad_columns_never_vote():
    # 200 points on a sphere through the origin, with the padding columns'
    # 1e30 guard replaced by their true |p|^2 = 0: the 56 zero columns lie on
    # the sphere, so only the ones-row mask (the kernel's NaN staging) keeps
    # them out of the count.
    d = np.random.default_rng(31).normal(size=(200, 3))
    centre = np.array([6.0, -2.0, 3.0])                       # radius |centre| = 7
    pts = torch.as_tensor((centre + 7.0 * d / np.linalg.norm(d, axis=1, keepdims=True))
                          .astype(np.float32))
    coords, p, nf, cols = fs.sweep_inputs("sphere3d", pts, torch.Generator().manual_seed(1))
    assert p.shape == (5, 256) and cols == 256
    p[4, 200:] = 0.0
    count, params, _ = fs.sweep_plain("sphere3d", coords, p, nf, 4, cols, 1.0)
    assert int(count) == 200
    np.testing.assert_allclose(params.numpy(), np.append(centre, 7.0), atol=1e-3)


def test_plain_sphere3d_vote_rounds_each_fma_once_on_band_edge_points():
    # The sphere3d kernel and its plain version count a cell where |e| < 1,
    # e = fma(a4, |p'|^2, fma(a2, z', fma(a1, y', fma(a0, x', a3)))) in
    # float32 on the points relative to P's column 0, c0 (p' = p - c0), with
    # the band rows about it, a = [w(-2c'), w|c'|^2 + o, w] for c' = c - c0.
    # Held here against that chain with each FMA rounded once from its exact
    # rational value, on points placed at distance r +- delta from each
    # centre (the band edge, |e| = 1, where one rounding decides the count)
    # and on padding columns, which never count.
    rng = np.random.default_rng(35)
    f32 = np.float32
    pts = torch.as_tensor(_cloud(36, 256))
    perms = fs.draw_slot_perms(256, 4, torch.Generator().manual_seed(5))
    samples = fs.reference_samples("sphere3d", pts, perms, 1)
    params, degenerate, vote_rows = fs._sphere3d_rows(
        [[samples[:, j, c] for c in range(3)] for j in range(4)], 1.0)
    keep = (~degenerate & (params[3] < 60.0)).nonzero()[:, 0][:8]
    assert len(keep) == 8
    rows = [a[keep] for a in vote_rows]                       # [c, w, o]
    centres = torch.stack(params[:3], 1)[keep].double().numpy()
    radii = params[3][keep].double().numpy()
    edge = []
    for c, r in zip(centres, radii):
        u = rng.normal(size=(6, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        edge.append(c + (r + np.array([1.0, -1.0] * 3))[:, None] * u)
    edge = np.concatenate(edge).astype(np.float32)            # 48 points, 80 padding columns
    p = fs.pack_feature_rows(torch.as_tensor(edge), True)
    assert p.shape == (5, 128)
    got = fs._sphere3d_vote(p, rows, 1.0).numpy()

    def fma(a, b, c):
        return _f32_round(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))

    cells = p.numpy()
    c0 = cells[0:3, 0]
    rel = cells[0:3] - c0[:, None]                            # float32 throughout
    pp = (rel[0] * rel[0] + rel[1] * rel[1]) + rel[2] * rel[2]
    want, near_edge = [], 0
    for cx, cy, cz, w, o in torch.stack(rows, 1).numpy():
        c = [cx - c0[0], cy - c0[1], cz - c0[2]]
        cc = (c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]
        a0, a1, a2, a3, a4 = w * (f32(-2.0) * c[0]), w * (f32(-2.0) * c[1]), \
            w * (f32(-2.0) * c[2]), w * cc + o, w
        count = 0
        for x, y, z, one, p2 in zip(*rel, cells[3], pp):
            e = fma(a4, p2, fma(a2, z, fma(a1, y, fma(a0, x, a3))))
            count += bool(abs(e) < 1.0) and one != 0
            near_edge += bool(one != 0 and abs(abs(float(e)) - 1.0) <= 1e-3)
        want.append(count)
    np.testing.assert_array_equal(got, np.array(want))
    assert near_edge >= 6 * len(want)          # the edge points really sit on the edge


@pytest.mark.parametrize("offset", [0.0, 1e3, 1e4])
def test_plain_sphere3d_vote_holds_far_from_the_origin(offset):
    # The sphere3d vote expands |p - c|^2 about P's column 0: on the same f32
    # fits every hypothesis's count stays within 2 of the float64 `agree`
    # count, and the sweep's best within 1 of the float64 maximum over the
    # same samples, wherever the cloud lies (about the origin the best fell
    # to 706 of 823 at 1e4).
    pts = torch.as_tensor(_far_sphere(offset))
    perms = fs.draw_slot_perms(1024, 4, torch.Generator().manual_seed(1))
    samples = fs.reference_samples("sphere3d", pts, perms, 2)
    params, degenerate, vote_rows = fs._sphere3d_rows(
        [[samples[:, j, c] for c in range(3)] for j in range(4)], 1.0)
    rows = [r[~degenerate] for r in vote_rows]
    got = fs._sphere3d_vote(fs.pack_feature_rows(pts, True), rows, 1.0)
    est = SphereEstimator(1.0, 3)
    fits = torch.stack(params, 1)[~degenerate].double()
    want = est.agree(fits, pts.double()).sum(-1)
    assert len(rows[0]) > 2000
    assert int((got - want).abs().max()) <= 2

    coords, p, nf, cols = fs.sweep_inputs("sphere3d", pts, None, perms=perms)
    count, _, _ = fs.sweep_plain("sphere3d", coords, p, nf, 2, cols, 1.0)
    p64, valid = est.minimal_fit(samples.double())
    best = int(torch.where(valid, est.agree(p64, pts.double()).sum(-1), 0).max())
    assert best > 800
    assert abs(int(count) - best) <= 1
