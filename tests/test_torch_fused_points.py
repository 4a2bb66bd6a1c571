"""Port parity: the plane3d, line3d and line2d families of
``lsqrrecipes_tpu_torch.ops.fused_sweep`` vs ``lsqrrecipes_tpu.ops.fused_sweep``.

The port is fed JAX's own permutations, rebuilt from the key exactly as
``fused_sweep.py`` draws them, so both evaluate the identical hypothesis
set.  Host-side planes, packed rows and samples are bitwise equal.  The best
count agrees within one for plane3d and line2d (the f32 band product sums
in another order) and within two for line3d, whose JAX product is a bf16
split that drops the lo*lo term while the port expands ``|p-a|^2 -
(u.(p-a))^2`` the same way in f32 FMAs, about P's first point instead of
the origin; each side is within one of the float64 ``agree`` maximum over
the same hypotheses.  JAX's winner is among the evaluated
hypotheses and, where the winners match, the params agree to rtol 1e-5.
The JAX kernel runs in interpret mode on the CPU; the port's CPU path is the
plain version of the CUDA kernels.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu.ops import fused_sweep as jfs
from lsqrrecipes_tpu_torch.estimators import Line2DEstimator, LineEstimator, PlaneEstimator
from lsqrrecipes_tpu_torch.ops import fused_sweep as fs
from test_torch_vote import _f32_round

torch.set_num_threads(2)

FAMILIES = {  # family: (estimator, count slack against JAX)
    "plane3d": (lambda: PlaneEstimator(1.0, 3), 1),
    "line3d": (lambda: LineEstimator(1.0, 3), 2),
    "line2d": (lambda: Line2DEstimator(1.0), 1),
}


def cloud(family, seed, n):
    """The chip gate's data model: 80% inliers with N(0, 0.2) noise on the
    family's ground truth, 20% uniform outliers in [-40, 40]^d, f32."""
    rng = np.random.default_rng(seed)
    n_in = n - n // 5
    if family == "plane3d":
        e1 = np.array([1.0, 0.0, 0.5]) / np.sqrt(1.25)
        e2 = np.array([0.0, 1.0, -0.2]) / np.linalg.norm([0.0, 1.0, -0.2])
        uv = rng.uniform(-30, 30, (n_in, 2))
        inl = np.array([2.0, -1.0, 4.0]) + uv[:, :1] * e1 + uv[:, 1:] * e2
    elif family == "line3d":
        u = np.array([0.6, -0.64, 0.48]) / np.linalg.norm([0.6, -0.64, 0.48])
        inl = np.array([1.0, 2.0, -3.0]) + rng.uniform(-40, 40, (n_in, 1)) * u
    else:
        inl = np.array([-2.0, 5.0]) + rng.uniform(-40, 40, (n_in, 1)) * np.array([0.8, 0.6])
    inl = inl + 0.2 * rng.normal(size=inl.shape)
    out = rng.uniform(-40, 40, (n - n_in, inl.shape[1]))
    return np.concatenate([inl, out]).astype(np.float32)


def _jax_randomness(key, n, n_fit, k_slots, vote_subsample=0):
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


def test_family_table():
    assert fs._FAMILIES == {
        "sphere3d": (4, 3, 4, True, 3),
        "plane3d": (3, 3, 6, False, 3),
        "line3d": (2, 3, 6, True, 3),
        "line2d": (2, 2, 4, False, 2),
        "dense_linear6": (6, 7, 6, False, 7),
        "pivot": (3, 15, 6, False, None),
        "absolute_orientation": (3, 6, 12, False, None),
        "ray3d": (2, 6, 3, False, None),
        "crosswire": (4, 14, 15, False, None),
        "pointer": (3, 17, 12, False, None),
    }
    for family, (k_slots, feat_rows, npr, _, _) in fs._FAMILIES.items():
        _, jk, jf, jn, *_ = jfs._FAMILIES[family]
        assert (k_slots, feat_rows, npr) == (jk, jf, jn)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_supports_data_checks_the_family_dim(family):
    dim, k_slots = fs._FAMILIES[family][4], fs._FAMILIES[family][0]
    assert fs.supports_data(family, torch.zeros(1000, dim))
    assert not fs.supports_data(family, torch.zeros(1000, 5 - dim))
    assert not fs.supports_data(family, torch.zeros(1000))
    too_big = 128 << (31 // k_slots - 1)      # first width whose hash overflows
    assert not fs.supports_data(family, torch.zeros(too_big, dim))
    assert jfs.supports_data(family, jnp.zeros((1000, dim)))


@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_host_side_bitwise_equal(family, n):
    k_slots, _, _, with_pp, _ = fs._FAMILIES[family]
    pts = cloud(family, n, n)
    key = jax.random.PRNGKey(3)
    n_fit = fs.fit_size(n, k_slots)
    assert n_fit == jfs.fit_size(n, k_slots)
    perms, _ = _jax_randomness(key, n, n_fit, k_slots)
    feats_j = jfs._pad_features(jnp.asarray(pts), n_fit)
    planes_j = np.asarray(jfs.slot_planes(feats_j, key, k_slots))
    feats_t = fs._pad_features(torch.as_tensor(pts), n_fit)
    np.testing.assert_array_equal(fs.slot_planes(feats_t, perms, k_slots).numpy(), planes_j)
    np.testing.assert_array_equal(
        fs.pack_feature_rows(torch.as_tensor(pts), with_pp).numpy(),
        np.asarray(jfs._FAMILIES[family][5](jnp.asarray(pts))),
    )
    np.testing.assert_array_equal(
        fs.reference_samples(family, torch.as_tensor(pts), perms, 5).numpy(),
        np.asarray(jfs.reference_samples(family, jnp.asarray(pts), key, 5)),
    )


CASES = [  # (n, total_groups, groups_per_step, vote_subsample)
    (256, 6, 1, 0),
    (256, 6, 4, 0),      # 6 groups, gps 4: 8 groups evaluated
    (256, 6, 1, 128),
    (200, 6, 1, 0),      # replication padding + guard columns
]


def _f64_agree_max(family, est, samples, voters):
    """Max float64 ``agree`` count over valid minimal fits of ``samples``."""
    params, valid = est.minimal_fit(samples.double())
    counts = est.agree(params, voters.double()).sum(-1)
    return int(torch.where(valid, counts, 0).max())


@pytest.mark.parametrize("n,groups,gps,subsample", CASES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fused_sweep_matches_jax(family, n, groups, gps, subsample):
    k_slots, feat_rows, _, _, _ = fs._FAMILIES[family]
    make_est, slack = FAMILIES[family]
    pts = cloud(family, 100 + n + gps + subsample, n)
    key = jax.random.PRNGKey(7 + gps + subsample)
    cj, pj = jfs.fused_sweep(family, jnp.asarray(pts), key, groups, 1.0,
                             groups_per_step=gps, vote_subsample=subsample)
    cj, pj = int(cj), np.asarray(pj)
    n_fit = fs.fit_size(n, k_slots)
    perms, vote_perm = _jax_randomness(key, n, n_fit, k_slots, subsample)
    tpts = torch.as_tensor(pts)
    ct, pt = fs.fused_sweep(family, tpts, None, groups, 1.0, groups_per_step=gps,
                            vote_subsample=subsample, perms=perms, vote_perm=vote_perm)
    ct = int(ct)
    assert abs(ct - cj) <= slack
    assert pt.shape == (fs._FAMILIES[family][2],) and pt.dtype == torch.float32

    evaluated = -(-groups // gps) * gps
    samples = fs.reference_samples(family, tpts, perms, evaluated)
    voters = tpts[torch.as_tensor(vote_perm.copy())][:subsample] if subsample else tpts
    oracle = _f64_agree_max(family, make_est(), samples, voters)
    assert abs(ct - oracle) <= 1 and abs(cj - oracle) <= 1
    assert ct > (n * 4 // 5) * (subsample or n) // n // 2

    # Locate both winners among the evaluated hypotheses.
    coords, p, nf, cols = fs.sweep_inputs(family, tpts, None, subsample,
                                          perms=perms, vote_perm=vote_perm)
    _, _, index_t = fs.sweep_plain(family, coords, p, nf, evaluated, cols, 1.0)
    pts_k = [[samples[:, j, c] for c in range(feat_rows)] for j in range(k_slots)]
    fits = torch.stack(fs._FITS[family](pts_k, 1.0)[0], dim=1).numpy()
    np.testing.assert_array_equal(fits[int(index_t)], pt.numpy())
    gap = np.abs(fits - pj).max(axis=1)
    index_j = int(np.argmin(gap))
    assert gap[index_j] <= 1e-4 * np.abs(pj).max()   # JAX's winner is in the set
    if index_j == int(index_t):
        np.testing.assert_allclose(pt.numpy(), pj, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_fit_matches_estimator_minimal_fit(family):
    # The kernels' f32 fit against the estimator's f64 exact fit on the same
    # samples: the same valid lanes (away from the gate) and close params.
    make_est, _ = FAMILIES[family]
    k_slots, feat_rows = fs._FAMILIES[family][:2]
    pts = torch.as_tensor(cloud(family, 5, 256))
    perms = fs.draw_slot_perms(256, k_slots, torch.Generator().manual_seed(5))
    samples = fs.reference_samples(family, pts, perms, 2)
    params, degenerate, _ = fs._FITS[family]([[samples[:, j, c] for c in range(feat_rows)]
                                              for j in range(k_slots)], 1.0)
    want, valid = make_est().minimal_fit(samples.double())
    got = torch.stack(params, dim=1).double()
    assert torch.equal(~degenerate, valid) or family == "plane3d"
    ok = valid & ~degenerate
    assert int(ok.sum()) > 400
    err = (got[ok] - want[ok]).abs().numpy()
    assert np.quantile(err, 0.99) < 1e-3 and err.max() < 0.1


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_sweep_ties_go_to_lowest_index(family):
    # The four permutations of each slot are equal, so every window of a
    # slot holds the same points and every group repeats group 0's
    # hypotheses: all groups tie, and the winner must stay in group 0.
    k_slots = fs._FAMILIES[family][0]
    pts = torch.as_tensor(cloud(family, 5, 128))
    rng = np.random.default_rng(0)
    sigma = [rng.permutation(128) for _ in range(k_slots)]
    perms = np.stack([sigma[j] for j in range(k_slots) for _ in range(4)])
    coords, p, nf, cols = fs.sweep_inputs(family, pts, None, perms=perms)
    c1, p1, i1 = fs.sweep_plain(family, coords, p, nf, 1, cols, 1.0)
    c5, p5, i5 = fs.sweep_plain(family, coords, p, nf, 5, cols, 1.0)
    assert int(c1) > 0
    assert (int(c5), int(i5)) == (int(c1), int(i1))
    assert torch.equal(p1, p5)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_degenerate_lanes_count_zero(family):
    # Every slot sees the same point: every hypothesis is degenerate, so
    # every count is 0 (the guard columns never vote) and the winner is
    # hypothesis 0 (the TPU rule).
    dim = fs._FAMILIES[family][4]
    pts = torch.as_tensor(np.tile(cloud(family, 6, 5)[:1], (100, 1)))
    coords, p, nf, cols = fs.sweep_inputs(family, pts, torch.Generator().manual_seed(0))
    assert p.shape == (dim + 2, 128)
    count, _, index = fs.sweep_plain(family, coords, p, nf, 4, cols, 1.0)
    assert int(count) == 0 and int(index) == 0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_pad_columns_never_vote(family):
    # 200 points on the x axis (56 padding columns of zeros, which lie on
    # every line through the origin): a line's best count is exactly the
    # 200 live points; for planes every sample is collinear, so 0.
    pts = torch.zeros((200, fs._FAMILIES[family][4]))
    pts[:, 0] = torch.linspace(-30, 30, 200)
    coords, p, nf, cols = fs.sweep_inputs(family, pts, torch.Generator().manual_seed(1))
    count, _, _ = fs.sweep_plain(family, coords, p, nf, 2, cols, 1.0)
    assert int(count) == (0 if family == "plane3d" else 200)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generator_drives_the_sweep_and_cuda_path_rejects_cpu(family):
    dim = fs._FAMILIES[family][4]
    pts = torch.as_tensor(cloud(family, 8, 256))
    a = fs.fused_sweep(family, pts, torch.Generator().manual_seed(1), 4, 1.0)
    b = fs.fused_sweep(family, pts, torch.Generator().manual_seed(1), 4, 1.0)
    assert int(a[0]) == int(b[0]) and torch.equal(a[1], b[1])
    coords, p, nf, cols = fs.sweep_inputs(family, pts, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="CUDA"):
        fs.sweep_cuda(family, coords, p, nf, 4, cols, 1.0)
    with pytest.raises(ValueError, match="coords must be"):
        fs.sweep_plain(family, coords[:-1], p, nf, 4, cols, 1.0)
    with pytest.raises(ValueError, match="p must be"):
        fs.sweep_plain(family, coords, p[:dim], nf, 4, cols, 1.0)


def test_rsqrt_is_correctly_rounded_reciprocal_sqrt():
    x = torch.tensor(np.random.default_rng(9).uniform(1e-3, 1e4, 10_000), dtype=torch.float32)
    want = (1.0 / np.sqrt(x.double().numpy())).astype(np.float32)
    got = fs._rsqrt(x).numpy()
    # Two correctly rounded steps: within one ulp of the exact value.
    assert np.abs(got.view(np.int32) - want.view(np.int32)).max() <= 1


def test_plain_line3d_vote_rounds_each_fma_once_on_band_edge_points():
    # The line3d kernel and its plain version count a cell where
    # fma(-e1, e1, t) < delta^2 - |a'|^2, with t = fma(-2a'_z, z', fma(-2a'_y,
    # y', fma(-2a'_x, x', |p'|^2))) and e1 = fma(u_z, z', fma(u_y, y',
    # fma(u_x, x', -u.a'))) in float32, p' = p - c and a' = a - c about the
    # centre c = P's column 0.  Held here against that chain with each FMA
    # rounded once from its exact rational value, on points placed at
    # distance delta from each line (the band edge, where one rounding
    # decides the count) and on padding columns, which never count.
    rng = np.random.default_rng(31)
    f32 = np.float32
    delta = f32(1.0)
    pts = torch.as_tensor(cloud("line3d", 32, 256))
    perms = fs.draw_slot_perms(256, 2, torch.Generator().manual_seed(3))
    samples = fs.reference_samples("line3d", pts, perms, 1)[:16]
    params, degenerate, _ = fs.line3d_fit([[samples[:, j, c] for c in range(3)]
                                           for j in range(2)], 1.0)
    rows = [r[~degenerate][:12] for r in params]             # the vote rows are [u, a]
    params = rows
    u_all = torch.stack(params[:3], 1).numpy()
    a_all = torch.stack(params[3:], 1).numpy()
    edge = []
    for u, a in zip(u_all.astype(np.float64), a_all.astype(np.float64)):
        w = np.cross(u, rng.normal(size=(6, 3)))
        w /= np.linalg.norm(w, axis=1, keepdims=True)
        edge.append(a + rng.uniform(-40, 40, (6, 1)) * u + w)
    edge = np.concatenate(edge).astype(np.float32)            # 72 points, 56 padding columns
    p = fs.pack_feature_rows(torch.as_tensor(edge), True)
    assert p.shape == (5, 128)
    got = fs._line3d_vote(p, rows, 1.0).numpy()

    want, near_edge = [], 0
    centre = edge[0]
    rel = edge - centre                                       # float32 throughout
    pp = (rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1]) + rel[:, 2] * rel[:, 2]
    for u, a in zip(u_all, a_all - centre):
        m = [f32(-2.0) * c for c in a]
        nua = -((u[0] * a[0] + u[1] * a[1]) + u[2] * a[2])
        thr = delta * delta - ((a[0] * a[0] + a[1] * a[1]) + a[2] * a[2])
        count = 0
        for (x, y, z), p2 in zip(rel, pp):
            t, e1 = p2, nua
            for mk, uk, v in zip(m, u, (x, y, z)):
                t = _f32_round(Fraction(float(mk)) * Fraction(float(v)) + Fraction(float(t)))
                e1 = _f32_round(Fraction(float(uk)) * Fraction(float(v)) + Fraction(float(e1)))
            d = _f32_round(-Fraction(float(e1)) ** 2 + Fraction(float(t)))
            count += bool(d < thr)
            near_edge += bool(abs(float(d) - float(thr)) <= 64 * np.spacing(f32(abs(t))))
        want.append(count)
    np.testing.assert_array_equal(got, np.array(want))
    assert near_edge >= 6 * len(want)          # the edge points really sit on the edge


@pytest.mark.parametrize("offset", [0.0, 1e3, 1e4, 1e5])
def test_plain_line3d_vote_holds_far_from_the_origin(offset):
    # The line3d vote expands |p - a|^2 into |p|^2 - 2a.p + |a|^2, whose terms
    # cancel.  Taken about the origin, a cloud 1e3 away miscounts most
    # hypotheses; about P's column 0 every hypothesis's count stays within 2
    # of the float64 `agree` count and the sweep's best within 1 of the f64
    # maximum, wherever the cloud lies.
    pts = torch.as_tensor(cloud("line3d", 41, 1024) + np.float32(offset))
    perms = fs.draw_slot_perms(1024, 2, torch.Generator().manual_seed(1))
    samples = fs.reference_samples("line3d", pts, perms, 2)
    params, degenerate, _ = fs.line3d_fit([[samples[:, j, c] for c in range(3)]
                                           for j in range(2)], 1.0)
    rows = [r[~degenerate] for r in params]
    got = fs._line3d_vote(fs.pack_feature_rows(pts, True), rows, 1.0)
    want = LineEstimator(1.0, 3).agree(torch.stack(rows, 1).double(), pts.double()).sum(-1)
    assert len(rows[0]) > 2000
    assert int((got - want).abs().max()) <= 2

    coords, p, nf, cols = fs.sweep_inputs("line3d", pts, None, perms=perms)
    count, _, _ = fs.sweep_plain("line3d", coords, p, nf, 2, cols, 1.0)
    assert abs(int(count) - _f64_agree_max("line3d", LineEstimator(1.0, 3), samples, pts)) <= 1
