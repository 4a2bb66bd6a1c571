"""Port parity: the dense_linear6, pivot, absolute_orientation and ray3d
families of ``lsqrrecipes_tpu_torch.ops.fused_sweep`` vs
``lsqrrecipes_tpu.ops.fused_sweep``.

The port is fed JAX's own permutations, rebuilt from the key exactly as
``fused_sweep.py`` draws them, so both evaluate the identical hypothesis
set.  Slot features and packed vote rows agree with JAX's (bit for bit, but
pivot's ``R^T t`` features, which XLA forms as a product, to 1e-6
relative).  The best counts of the JAX kernel (interpret mode on the CPU)
and of the port's plain version are within 2 of each other and each within
1 of the float64 ``agree`` maximum over the same hypotheses; the port's
winner is among them bit for bit.  The JAX kernel votes through a 3-pass
bf16 split product; the port, like its CUDA kernels, per cell in plain f32.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu.ops import fused_sweep as jfs
from lsqrrecipes_tpu_torch.device import as_tensor
from lsqrrecipes_tpu_torch.geometry import Frame, Ray3D, rotations
from lsqrrecipes_tpu_torch.ops import fused_sweep as fs
from lsqrrecipes_tpu_torch.ransac import ransac_fused_sweep
from lsqrrecipes_tpu_torch.tree import tree_map
from test_torch_rigid_estimators import ESTIMATORS, _rotations, make_data, to_jax, to_torch
from test_torch_vote import _f32_round

torch.set_num_threads(2)

FAMILIES = {  # family: estimator kind
    "pivot": "pivot_calibration",
    "absolute_orientation": "absolute_orientation",
    "ray3d": "ray_intersection",
    "dense_linear6": "dense_linear_6",
}


def _f32(data):
    kind, *arrays = data
    return (kind, *(a.astype(np.float32) for a in arrays))


def _jax_perms(key, n_fit, k_slots, vote_subsample=0):
    """(slot-plane perms [4k, n_fit], vote perm or None), drawn as
    ``fused_sweep`` / ``slot_planes`` draw them from ``key``."""
    vote_perm = None
    if vote_subsample:
        key, sub = jax.random.split(key)
    keys = jax.random.split(key, 4 * k_slots)
    perms = np.stack([np.asarray(jax.random.permutation(keys[i], n_fit))
                      for i in range(4 * k_slots)])
    return perms, (sub if vote_subsample else None)


def _delta(family):
    if family == "ray3d":
        return ESTIMATORS["ray_intersection"][1]().fused_delta
    return 1.0


def _samples_as_data(family, feats):
    """``[B, k, F]`` slot features -> the estimator's sample tree (f64)."""
    f = feats.double()
    if family == "pivot":
        return Frame(f[..., 0:9].reshape(*f.shape[:2], 3, 3), f[..., 9:12])
    if family == "absolute_orientation":
        return (f[..., 0:3], f[..., 3:6])
    if family == "ray3d":
        return Ray3D(f[..., 0:3], f[..., 3:6])
    return f


def _f64_agree_max(family, samples, voters):
    est = ESTIMATORS[FAMILIES[family]][1]()
    params, valid = est.minimal_fit(_samples_as_data(family, samples))
    counts = est.agree(params, voters).sum(-1)
    return int(torch.where(valid, counts, 0).max())


def test_family_table_matches_jax():
    for family in FAMILIES:
        k_slots, feat_rows, npr, _, _ = fs._FAMILIES[family]
        _, jk, jf, jn, *_ = jfs._FAMILIES[family]
        assert (k_slots, feat_rows, npr) == (jk, jf, jn)


@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_host_side_matches_jax(family, n):
    data = _f32(make_data(FAMILIES[family], n, n))
    k_slots = fs._FAMILIES[family][0]
    key = jax.random.PRNGKey(3)
    n_fit = fs.fit_size(n, k_slots)
    assert n_fit == jfs.fit_size(n, k_slots)
    perms, _ = _jax_perms(key, n_fit, k_slots)
    tol = {"rtol": 1e-6, "atol": 1e-4} if family == "pivot" else {"rtol": 0, "atol": 0}
    np.testing.assert_allclose(
        fs.reference_samples(family, to_torch(data), perms, 5).numpy(),
        np.asarray(jfs.reference_samples(family, to_jax(data), key, 5)), **tol)
    np.testing.assert_allclose(fs.pack_p(family, to_torch(data)).numpy(),
                               np.asarray(jfs._FAMILIES[family][5](to_jax(data))), **tol)
    assert fs.supports_data(family, to_torch(data)) and jfs.supports_data(family, to_jax(data))


CASES = [  # (n, total_groups, groups_per_step, vote_subsample)
    (256, 6, 1, 0),
    (200, 6, 4, 128),    # replication and guard padding, 8 groups, a subsample
]


@pytest.mark.parametrize("n,groups,gps,subsample", CASES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_sweep_matches_jax(family, n, groups, gps, subsample):
    k_slots = fs._FAMILIES[family][0]
    data = _f32(make_data(FAMILIES[family], 100 + n + gps, n))
    key = jax.random.PRNGKey(7 + gps + subsample)
    cj, _ = jfs.fused_sweep(family, to_jax(data), key, groups, _delta(family),
                            groups_per_step=gps, vote_subsample=subsample)
    n_fit = fs.fit_size(n, k_slots)
    perms, sub = _jax_perms(key, n_fit, k_slots, subsample)
    vote_perm = None if sub is None else np.array(jax.random.permutation(sub, n))
    tdata = to_torch(data)
    coords, p, nf, cols = fs.sweep_inputs(family, tdata, None, subsample,
                                          perms=perms, vote_perm=vote_perm)
    evaluated = -(-groups // gps) * gps
    ct, pt, index = fs.sweep_plain(family, coords, p, nf, evaluated, cols, _delta(family))
    ct, cj = int(ct), int(cj)
    assert abs(ct - cj) <= 2

    samples = fs.reference_samples(family, tdata, perms, evaluated)
    voters = to_torch(make_data(FAMILIES[family], 100 + n + gps, n))       # f64
    if subsample:
        voters = tree_map(lambda x: x[torch.as_tensor(vote_perm)][:subsample], voters)
    oracle = _f64_agree_max(family, samples, voters)
    assert abs(ct - oracle) <= 1 and abs(cj - oracle) <= 1
    assert ct > (n * 4 // 5) * (subsample or n) // n // 2

    # The winner is its own hypothesis, bit for bit.
    feat_rows = fs._FAMILIES[family][1]
    pts = [[samples[:, j, c] for c in range(feat_rows)] for j in range(k_slots)]
    fits = torch.stack(fs._FITS[family](pts, _delta(family))[0], dim=1)
    assert torch.equal(fits[int(index)], pt)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_pad_columns_never_vote(family):
    # n = 200: 56 padding columns whose rows (all 0) would lie in the band
    # of a fit whose residual there is ~0 (t_W = 0, t = 0, a ray target at
    # the origin; any x for the linear system), so any vote from them would
    # push the count past what agree() re-achieves on the true data.
    rng = np.random.default_rng(17)
    n = 200
    if family == "pivot":
        r = torch.as_tensor(_rotations(rng, n))
        data = Frame(r, -r @ torch.tensor([10.0, -5.0, 2.0], dtype=r.dtype))
    elif family == "absolute_orientation":
        first = torch.as_tensor(rng.uniform(-50, 50, (n, 3)))
        data = (first, first.clone())
    elif family == "ray3d":
        p = torch.as_tensor(rng.uniform(-50, 50, (n, 3)))
        data = Ray3D(p, -p / p.norm(dim=1, keepdim=True))
    else:
        data = torch.as_tensor(rng.normal(size=(n, 7)) * 10.0)
    data = as_tensor(data, "cpu", torch.float32)
    delta = 0.05 if family == "dense_linear6" else _delta(family)
    coords, p, nf, cols = fs.sweep_inputs(family, data, torch.Generator().manual_seed(1))
    assert p.shape[1] == 256
    count, params, _ = fs.sweep_plain(family, coords, p, nf, 6, cols, delta)
    est = ESTIMATORS[FAMILIES[family]][1]()
    if family == "dense_linear6":
        est.delta = delta
    if family == "absolute_orientation":
        params = fs._absor_post(params)
    achieved = int(est.agree(params.double(), as_tensor(data, "cpu", torch.float64)).sum())
    assert int(count) <= n and abs(achieved - int(count)) <= 1
    if family != "dense_linear6":
        assert int(count) >= n - 1         # the planted structure holds every observation


TRUTH = {
    "pivot": lambda x: max(np.abs(x[:3] - [10.0, -5.0, 2.0]).max(),
                           np.abs(x[3:] - [100.0, 50.0, -30.0]).max()) < 0.1,
    "ray3d": lambda x: np.abs(x - [20.0, -10.0, 35.0]).max() < 0.2,
    "dense_linear6": lambda x: np.abs(x - np.linspace(-2.0, 3.0, 6)).max() < 0.05,
}


def _planted_rotation(seed, n):
    """The rotation ``make_data("absolute_orientation", seed, n)`` applies."""
    rng = np.random.default_rng(seed)
    rng.uniform(-100, 100, (n, 3))
    return _rotations(rng, 1)[0]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_ransac_fused_sweep_recovers_the_truth(family):
    # The JAX tests' limits (tests/test_fused_sweep.py).
    est = ESTIMATORS[FAMILIES[family]][1]()
    data = to_torch(_f32(make_data(FAMILIES[family], 31, 256)))
    res = ransac_fused_sweep(est, data, torch.Generator().manual_seed(2), num_hypotheses=2048)
    assert bool(res.valid) and float(res.inlier_fraction) > 0.6
    assert int(res.best_count) == int(res.consensus.sum())
    x = res.params.double().numpy()
    if family == "absolute_orientation":
        r_fit = rotations.matrix_from_quaternion(torch.as_tensor(x[:4] / np.linalg.norm(x[:4])))
        assert np.abs(r_fit.numpy() - _planted_rotation(31, 256)).max() < 0.01
        assert np.abs(x[4:] - [12.0, -7.0, 30.0]).max() < 0.2
    else:
        assert TRUTH[family](x)


def test_absolute_orientation_postprocess_gives_q_and_t():
    data = to_torch(_f32(make_data("absolute_orientation", 41, 256)))
    gen = torch.Generator().manual_seed(3)
    count, params = fs.fused_sweep("absolute_orientation", data, gen, 4, 1.0)
    assert params.shape == (7,) and params.dtype == torch.float64 and int(count) > 150
    assert abs(float(params[:4].norm()) - 1.0) < 1e-6
    coords, p, nf, cols = fs.sweep_inputs("absolute_orientation", data,
                                          torch.Generator().manual_seed(3))
    _, rows, _ = fs.sweep_plain("absolute_orientation", coords, p, nf, 4, cols, 1.0)
    r = rotations.matrix_from_quaternion(params[:4])
    np.testing.assert_allclose(r.numpy(), rows[:9].double().reshape(3, 3).numpy(), atol=1e-6)
    np.testing.assert_array_equal(params[4:].numpy(), rows[9:].double().numpy())


def test_supports_data_and_ray_delta_pack():
    frames = to_torch(_f32(make_data("pivot_calibration", 1, 300)))
    rays = to_torch(_f32(make_data("ray_intersection", 1, 300)))
    pair = to_torch(_f32(make_data("absolute_orientation", 1, 300)))
    rows = to_torch(_f32(make_data("dense_linear_6", 1, 300)))
    assert fs.supports_data("pivot", frames) and not fs.supports_data("pivot", rows)
    assert fs.supports_data("ray3d", rays) and not fs.supports_data("ray3d", pair)
    assert fs.supports_data("absolute_orientation", pair)
    assert not fs.supports_data("absolute_orientation", frames)
    assert fs.supports_data("dense_linear6", rows)
    assert not fs.supports_data("dense_linear6", torch.zeros(2048, 7))   # 6 x 6 bits: n <= 1024
    with pytest.raises(ValueError, match="does not fit"):
        fs.fused_sweep("pivot", rows, None, 2, 1.0)
    # The ray family's (delta, cross_eps) reaches the fit intact: a gate above
    # every pair's |na x nb|^2 leaves no valid hypothesis.
    count, _ = fs.fused_sweep("ray3d", rays, torch.Generator().manual_seed(4), 2, (1.0, 2.0))
    assert int(count) == 0
    count, _ = fs.fused_sweep("ray3d", rays, torch.Generator().manual_seed(4), 2, _delta("ray3d"))
    assert int(count) > 150


def _fma(a, b, c):
    """``a * b + c`` rounded once to float32 from its exact rational value."""
    return _f32_round(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def test_plain_dense6_vote_rounds_each_fma_once_on_band_edge_points():
    # The dense_linear6 kernel and its plain version count a cell where |e| <
    # delta, e = fma(a5, x5, ... fma(a1, x1, fma(a0, x0, -b))) in float32.
    # Held here against that chain with each FMA rounded once from its exact
    # rational value, on rows placed at residual +-delta from each hypothesis
    # (the band edge, where one rounding decides the count) and on padding
    # columns, which never count.
    rng = np.random.default_rng(61)
    delta = np.float32(1.0)
    a = rng.uniform(-10, 10, (16, 6, 6))
    b = a @ np.linspace(-2.0, 3.0, 6) + 0.05 * rng.normal(size=(16, 6))
    samples = torch.as_tensor(np.concatenate([a, b[..., None]], -1).astype(np.float32))
    x, degenerate, _ = fs.dense_linear6_fit([[samples[:, j, c] for c in range(7)]
                                             for j in range(6)], float(delta))
    hyp = torch.stack([r[~degenerate][:8] for r in x], 1).numpy()
    assert hyp.shape == (8, 6)
    rows = []
    for xh in hyp.astype(np.float64):
        a_e = rng.uniform(-10, 10, (6, 6))
        rows.append(np.concatenate([a_e, (a_e @ xh + np.array([1.0, -1.0] * 3))[:, None]], 1))
    p = fs.pack_feature_rows(torch.as_tensor(np.concatenate(rows).astype(np.float32)), False)
    assert p.shape == (9, 128)                                # 48 rows, 80 padding columns
    got = fs._dense6_vote(p, [torch.as_tensor(hyp[:, c]) for c in range(6)], float(delta))

    want, near_edge = [], 0
    for xh in hyp:
        count = 0
        for col in p.numpy().T:
            e = -col[6]
            for c in range(6):
                e = _fma(col[c], xh[c], e)
            count += bool(abs(e) < delta) and col[7] != 0
            near_edge += bool(col[7] != 0 and abs(abs(float(e)) - float(delta)) <= 1e-3)
        want.append(count)
    np.testing.assert_array_equal(got.numpy(), np.array(want))
    assert near_edge >= 6 * len(want)          # the edge rows really sit on the edge


def test_plain_absor_vote_rounds_each_fma_once_on_band_edge_points():
    # The absolute_orientation kernel and its plain version count a cell
    # where fma(e_2, e_2, fma(e_1, e_1, e_0 e_0)) < delta^2, e_j = fma(R_j2,
    # z1, fma(R_j1, y1, fma(R_j0, x1, t_j))) - p2_j in float32.  Held here
    # against that chain with each FMA rounded once from its exact rational
    # value, on pairs placed at residual delta from each hypothesis (the band
    # edge) and on padding columns, which never count.
    rng = np.random.default_rng(62)
    f32 = np.float32
    delta = 1.0
    rot = _rotations(rng, 1)[0]
    first = rng.uniform(-100, 100, (16, 3, 3))
    second = first @ rot.T + np.array([12.0, -7.0, 30.0]) + 0.1 * rng.normal(size=(16, 3, 3))
    samples = torch.as_tensor(np.concatenate([first, second], -1).astype(np.float32))
    rows, degenerate, _ = fs.absolute_orientation_fit([[samples[:, j, c] for c in range(6)]
                                                       for j in range(3)], delta)
    hyp = torch.stack([r[~degenerate][:8] for r in rows], 1).numpy()
    assert hyp.shape == (8, 12)
    p1, p2 = [], []
    for h in hyp.astype(np.float64):
        for _ in range(6):
            q = rng.uniform(-100, 100, 3)
            e = rng.normal(size=3)
            p1.append(q)
            p2.append(h[0:9].reshape(3, 3) @ q + h[9:12] - delta * e / np.linalg.norm(e))
    p = fs._absor_p((torch.as_tensor(np.array(p1, np.float32)),
                     torch.as_tensor(np.array(p2, np.float32))))
    assert p.shape == (8, 128)                                # 48 pairs, 80 padding columns
    got = fs._absor_vote(p, [torch.as_tensor(hyp[:, i]) for i in range(12)], delta)

    limit = f32(delta * delta)
    want, near_edge = [], 0
    for h in hyp:
        count = 0
        for col in p.numpy().T:
            e = [_fma(h[3 * j + 2], col[2], _fma(h[3 * j + 1], col[1], _fma(h[3 * j], col[0],
                                                                           h[9 + j])))
                 - col[3 + j] for j in range(3)]                # f32 subtract
            d2 = _fma(e[2], e[2], _fma(e[1], e[1], e[0] * e[0]))
            count += bool(d2 < limit) and col[6] != 0
            near_edge += bool(col[6] != 0 and abs(float(d2) - float(limit)) <= 1e-3)
        want.append(count)
    np.testing.assert_array_equal(got.numpy(), np.array(want))
    assert near_edge >= 6 * len(want)          # the edge pairs really sit on the edge


def test_plain_ray3d_vote_rounds_each_fma_once_on_band_edge_points():
    # The ray3d kernel and its plain version count a cell where t >= 0 and
    # fma(-(t t), w, |v|^2) < delta^2, v = x - p, t = fma(n_z, v_z, fma(n_y,
    # v_y, n_x v_x)), |v|^2 likewise, w = 2 - |n|^2, in float32.  Held here
    # against that chain with each FMA rounded once from its exact rational
    # value, on rays passing at distance delta from each hypothesis (the band
    # edge), on rays whose point lies a hair past the hypothesis along their
    # direction (t just below 0, where the front gate decides) and on padding
    # columns, which never count.
    rng = np.random.default_rng(63)
    f32 = np.float32
    delta = 1.0
    p = rng.uniform(-60, 60, (16, 2, 3))
    d = np.array([20.0, -10.0, 35.0]) - p + 0.05 * rng.normal(size=p.shape)
    n = d / np.linalg.norm(d, axis=-1, keepdims=True)
    samples = torch.as_tensor(np.concatenate([p, n], -1).astype(np.float32))
    x, degenerate, _ = fs.ray3d_fit([[samples[:, j, c] for c in range(6)] for j in range(2)],
                                    _delta("ray3d"))
    hyp = torch.stack([r[~degenerate][:8] for r in x], 1).numpy()
    assert hyp.shape == (8, 3)
    points, dirs = [], []
    for xh in hyp.astype(np.float64):
        for i in range(8):
            u = rng.normal(size=3)
            u /= np.linalg.norm(u)
            perp = rng.normal(size=3)
            perp -= (perp @ u) * u
            perp /= np.linalg.norm(perp)
            if i < 6:                                   # distance delta, x in front
                points.append(xh - rng.uniform(2, 20) * u + delta * perp)
            else:                                       # x a hair behind the point
                points.append(xh + rng.uniform(0, 4e-6) * u + 0.3 * delta * perp)
            dirs.append(u)
    p = fs._ray_p(Ray3D(torch.as_tensor(np.array(points, np.float32)),
                        torch.as_tensor(np.array(dirs, np.float32))))
    assert p.shape == (10, 128)                               # 64 rays, 64 padding columns
    got = fs._ray3d_vote(p, [torch.as_tensor(hyp[:, c]) for c in range(3)], delta)

    limit = f32(delta * delta)
    want, near_edge, gated = [], 0, 0
    for xh in hyp:
        count = 0
        for col in p.numpy().T:
            v = [xh[c] - col[c] for c in range(3)]              # f32 subtract
            t = _fma(col[5], v[2], _fma(col[4], v[1], col[3] * v[0]))
            d2 = _fma(v[2], v[2], _fma(v[1], v[1], v[0] * v[0]))
            e = _fma(-(t * t), f32(2.0) - col[8], d2)
            count += bool(t >= 0 and e < limit) and col[7] != 0
            near_edge += bool(col[7] != 0 and t > 1 and abs(float(e) - float(limit)) <= 1e-3)
            gated += bool(col[7] != 0 and t < 0 and e < limit)
        want.append(count)
    np.testing.assert_array_equal(got.numpy(), np.array(want))
    assert near_edge >= 6 * len(want)          # the edge rays really sit on the edge
    assert gated >= len(want)                  # and the front gate refuses some in the band


def test_plain_pivot_vote_rounds_each_fma_once_on_band_edge_points():
    # The pivot kernel and its plain version count a cell where fma(e_2, e_2,
    # fma(e_1, e_1, e_0 e_0)) < delta^2, e_j = fma(R_j2, td_2, fma(R_j1, td_1,
    # fma(R_j0, td_0, t_j))) - tw_j in float32.  Held here against that chain
    # with each FMA rounded once from its exact rational value, on frames
    # whose R t_D + t - t_W has norm delta for each hypothesis (the band edge)
    # and on padding columns, which never count.
    rng = np.random.default_rng(64)
    f32 = np.float32
    delta = 1.0
    r = _rotations(rng, 48).reshape(16, 3, 3, 3)
    t = (np.array([100.0, 50.0, -30.0]) - r @ np.array([10.0, -5.0, 2.0])
         + 0.05 * rng.normal(size=(16, 3, 3)))
    samples = fs._pivot_features(Frame(torch.as_tensor(r.reshape(48, 3, 3)),
                                       torch.as_tensor(t.reshape(48, 3))))
    samples = samples.to(torch.float32).reshape(16, 3, 15)
    rows, degenerate, _ = fs.pivot_fit([[samples[:, j, c] for c in range(15)] for j in range(3)],
                                       delta)
    hyp = torch.stack([x[~degenerate][:8] for x in rows], 1).numpy()
    assert hyp.shape == (8, 6)
    frames_r, frames_t = [], []
    for h in hyp.astype(np.float64):
        for rot in _rotations(rng, 6):
            e = rng.normal(size=3)
            frames_r.append(rot)
            frames_t.append(h[3:6] - rot @ h[0:3] + delta * e / np.linalg.norm(e))
    p = fs._pivot_p(Frame(torch.as_tensor(np.array(frames_r, np.float32)),
                          torch.as_tensor(np.array(frames_t, np.float32))))
    assert p.shape == (17, 128)                               # 48 frames, 80 padding columns
    got = fs._pivot_vote(p, [torch.as_tensor(hyp[:, i]) for i in range(6)], delta)

    limit = f32(delta * delta)
    want, near_edge = [], 0
    for h in hyp:
        count = 0
        for col in p.numpy().T:
            e = [_fma(col[8 + 3 * j], h[2], _fma(col[7 + 3 * j], h[1], _fma(col[6 + 3 * j], h[0],
                                                                           col[j])))
                 - h[3 + j] for j in range(3)]                  # f32 subtract
            d2 = _fma(e[2], e[2], _fma(e[1], e[1], e[0] * e[0]))
            count += bool(d2 < limit) and col[15] != 0
            near_edge += bool(col[15] != 0 and abs(float(d2) - float(limit)) <= 1e-3)
        want.append(count)
    np.testing.assert_array_equal(got.numpy(), np.array(want))
    assert near_edge >= 6 * len(want)          # the edge frames really sit on the edge
