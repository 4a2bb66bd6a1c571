"""Port parity: the crosswire and pointer families of
``lsqrrecipes_tpu_torch.ops.fused_sweep`` vs ``lsqrrecipes_tpu.ops.fused_sweep``.

The port is fed JAX's own permutations, rebuilt from the key exactly as
``fused_sweep.py`` draws them, so both evaluate the identical hypothesis
set, on the data model of the JAX tests (``tests/test_fused_sweep.py:543-682``:
the reference's calibration model with sigma 0.5 px, the last 30% of the
tracked translations or targets shifted by 30-80).  Slot features agree with
JAX's bit for bit and the packed vote rows to 1e-6 relative (``R2^T t2`` and
``R2^T (p - t2)``, which XLA forms as a product).  The best counts of the JAX
kernel (interpret mode on the CPU) and of the port's plain version are
within 2 of each other and each within 1 of the float64 ``agree`` maximum
over the same hypotheses; the port's winner is among them bit for bit, and
its host-side parameters match the f64 minimal fit of the winner to f32
accuracy.  The JAX kernel votes through a 3-pass bf16 split product; the
port, like its CUDA kernels, per cell in f32 (each residual component a
chain of FMAs, each rounded once as CUDA's ``__fmaf_rn``).
"""

from fractions import Fraction

import jax
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu.ops import fused_sweep as jfs
from lsqrrecipes_tpu_torch import kernels
from lsqrrecipes_tpu_torch.geometry import Frame
from lsqrrecipes_tpu_torch.ops import fused_sweep as fs
from lsqrrecipes_tpu_torch.ransac import ransac_fused_sweep
from lsqrrecipes_tpu_torch.tree import tree_map
from test_torch_fused_rigid import _jax_perms
from test_torch_us_calibration import (
    check_truth,
    euler_np,
    make_estimators,
    make_us_data,
    to_jax,
    to_torch,
)
from test_torch_vote import _f32_round

torch.set_num_threads(2)

FAMILIES = ("crosswire", "pointer")
DELTA = 3.0


def _data(family, seed, n):
    return make_us_data(family, seed, n, sigma=0.5, outliers=0.3)


def _samples_as_data(family, feats):
    """``[B, k, F]`` slot features -> the estimator's sample tree (f64)."""
    f = feats.double()
    frames = Frame(f[..., 0:9].reshape(*f.shape[:2], 3, 3), f[..., 9:12])
    return (frames, f[..., 12:14]) + ((f[..., 14:17],) if family == "pointer" else ())


def test_family_table_matches_jax():
    for family in FAMILIES:
        k_slots, feat_rows, npr, _, _ = fs._FAMILIES[family]
        _, jk, jf, jn, *_ = jfs._FAMILIES[family]
        assert (k_slots, feat_rows, npr) == (jk, jf, jn)
        assert family in kernels.US_FAMILIES and family in kernels.FUSED_SWEEPS


@pytest.mark.parametrize("n", [256, 200])
@pytest.mark.parametrize("family", FAMILIES)
def test_host_side_matches_jax(family, n):
    data, _ = _data(family, 1, n)
    k_slots = fs._FAMILIES[family][0]
    key = jax.random.PRNGKey(3)
    n_fit = fs.fit_size(n, k_slots)
    assert n_fit == jfs.fit_size(n, k_slots)
    perms, _ = _jax_perms(key, n_fit, k_slots)
    np.testing.assert_array_equal(
        fs.reference_samples(family, to_torch(data), perms, 5).numpy(),
        np.asarray(jfs.reference_samples(family, to_jax(data), key, 5)))
    p = fs.pack_p(family, to_torch(data))
    assert p.shape == (fs._DATA[family][3], 256) and p.dtype == torch.float32
    np.testing.assert_allclose(p.numpy(), np.asarray(jfs._FAMILIES[family][5](to_jax(data))),
                               rtol=1e-6, atol=1e-4)
    assert fs.supports_data(family, to_torch(data)) and jfs.supports_data(family, to_jax(data))


CASES = [  # (n, total_groups, groups_per_step, vote_subsample)
    (256, 6, 1, 0),
    (200, 6, 4, 128),    # replication and guard padding, 8 groups, a subsample
]


@pytest.mark.parametrize("n,groups,gps,subsample", CASES)
@pytest.mark.parametrize("family", FAMILIES)
def test_plain_sweep_matches_jax(family, n, groups, gps, subsample):
    k_slots, feat_rows = fs._FAMILIES[family][:2]
    data, _ = _data(family, 20 + n + gps, n)
    key = jax.random.PRNGKey(7 + gps + subsample)
    cj, _ = jfs.fused_sweep(family, to_jax(data), key, groups, DELTA,
                            groups_per_step=gps, vote_subsample=subsample)
    n_fit = fs.fit_size(n, k_slots)
    perms, sub = _jax_perms(key, n_fit, k_slots, subsample)
    vote_perm = None if sub is None else np.array(jax.random.permutation(sub, n))
    tdata = to_torch(data)
    coords, p, nf, cols = fs.sweep_inputs(family, tdata, None, subsample,
                                          perms=perms, vote_perm=vote_perm)
    evaluated = -(-groups // gps) * gps
    ct, pt, index = fs.sweep_plain(family, coords, p, nf, evaluated, cols, DELTA)
    ct, cj = int(ct), int(cj)
    assert abs(ct - cj) <= 2

    samples = fs.reference_samples(family, tdata, perms, evaluated)
    voters = tdata if not subsample else tree_map(
        lambda x: x[torch.as_tensor(vote_perm)][:subsample], tdata)
    est = make_estimators(family, delta=DELTA)[1]
    p64, v64 = est.minimal_fit(_samples_as_data(family, samples))
    counts = torch.where(v64, est.agree(p64, voters).sum(-1), 0)
    oracle = int(counts.max())
    assert abs(ct - oracle) <= 1 and abs(cj - oracle) <= 1
    assert ct > (subsample or n) // 2

    # The winner is its own hypothesis, bit for bit ...
    pts = [[samples[:, j, c] for c in range(feat_rows)] for j in range(k_slots)]
    fits = torch.stack(fs._FITS[family](pts, DELTA)[0], dim=1)
    assert torch.equal(fits[int(index)], pt)
    # ... and its host-side parameters are the f64 fit's to f32 accuracy.
    post = fs._us_post(pt)
    want = p64[int(index)]
    assert post.shape == want.shape == (est.nparams,)
    scale = want.abs().clamp_min(1.0)
    assert float(((post - want).abs() / scale).max()) < 2e-3


@pytest.mark.parametrize("family", FAMILIES)
def test_pad_columns_never_vote(family):
    # n = 200, noise-free data with t3 = 0: the 56 padding columns hold zero
    # rows, whose residual under the planted calibration is |t3| = 0, so any
    # vote from them would push the count past what agree() re-achieves.
    rng = np.random.default_rng(30)
    n = 200
    w = rng.uniform(0, np.pi, (n, 3))
    r2 = euler_np(w[:, 2], w[:, 1], w[:, 0])
    r3 = euler_np(0.3, -0.2, 1.0)
    q = rng.uniform(size=(n, 2)) * np.array([640.0, 480.0])
    img = q[:, 0:1] * (0.143 * r3[:, 0]) + q[:, 1:2] * (0.139 * r3[:, 1])
    mapped = np.einsum("nij,nj->ni", r2, img)
    if family == "crosswire":
        data = ("crosswire", r2, np.array([10.0, -20.0, 30.0]) - mapped, q)
    else:
        t2 = rng.uniform(-100, 100, (n, 3))
        data = ("pointer", r2, t2, q, mapped + t2)
    tdata = to_torch(data, torch.float32)
    coords, p, nf, cols = fs.sweep_inputs(family, tdata, torch.Generator().manual_seed(1))
    assert p.shape[1] == 256
    count, params, _ = fs.sweep_plain(family, coords, p, nf, 6, cols, DELTA)
    est = make_estimators(family, delta=DELTA)[1]
    achieved = int(est.agree(fs._us_post(params), to_torch(data)).sum())
    assert n - 1 <= int(count) <= n and abs(achieved - int(count)) <= 1


@pytest.mark.parametrize("family", FAMILIES)
def test_ransac_fused_sweep_recovers_the_truth(family):
    est = make_estimators(family, delta=DELTA)[1]
    data, truth = _data(family, 31, 256)
    res = ransac_fused_sweep(est, to_torch(data), torch.Generator().manual_seed(2),
                             num_hypotheses=1024)
    assert bool(res.valid) and float(res.inlier_fraction) > 0.6
    assert int(res.best_count) == int(res.consensus.sum())
    assert res.params.dtype == torch.float64 and res.minimal_params.shape == (est.nparams,)
    check_truth(family, res.params.numpy(), truth)


@pytest.mark.parametrize("family", FAMILIES)
def test_postprocess_gives_the_estimator_layout(family):
    data, truth = _data(family, 41, 256)
    count, params = fs.fused_sweep(family, to_torch(data), torch.Generator().manual_seed(3),
                                   8, DELTA)
    assert params.dtype == torch.float64 and int(count) > 128
    coords, p, nf, cols = fs.sweep_inputs(family, to_torch(data), torch.Generator().manual_seed(3))
    _, rows, _ = fs.sweep_plain(family, coords, p, nf, 8, cols, DELTA)
    off = 3 if family == "crosswire" else 0
    np.testing.assert_array_equal(params[: off + 3].numpy(), rows[: off + 3].double().numpy())
    np.testing.assert_array_equal(params[off + 8 :].numpy(), rows[off + 3 :].double().numpy())
    r = euler_np(*params[off + 3 : off + 6].numpy())
    np.testing.assert_allclose(r[:, 0] * float(params[off + 6]), rows[off + 3 : off + 6].numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(r[:, 2], rows[off + 9 : off + 12].numpy(), atol=1e-6)
    check_truth(family, params.numpy(), truth)


def test_supports_data():
    cross, _ = _data("crosswire", 1, 300)
    point, _ = _data("pointer", 1, 300)
    frames = to_torch(cross)[0]
    assert fs.supports_data("crosswire", to_torch(cross))
    assert not fs.supports_data("crosswire", to_torch(point))
    assert fs.supports_data("pointer", to_torch(point))
    assert not fs.supports_data("pointer", to_torch(cross))
    assert not fs.supports_data("pivot", to_torch(cross)) and fs.supports_data("pivot", frames)
    assert not fs.supports_data("crosswire", frames)
    assert not fs.supports_data("absolute_orientation", to_torch(cross))
    assert fs.supports_data("crosswire", to_torch(_data("crosswire", 2, 4096)[0]))
    big = to_torch(_data("crosswire", 2, 8192)[0])      # 4 x 8 bits > 31: n <= 4096
    assert not fs.supports_data("crosswire", big)
    with pytest.raises(ValueError, match="does not fit"):
        fs.fused_sweep("crosswire", to_torch(point), None, 2, DELTA)


def test_plain_crosswire_vote_rounds_each_fma_once_on_band_edge_points():
    # The crosswire kernel and its plain version count a cell where
    # fma(e_2, e_2, fma(e_1, e_1, e_0 e_0)) < delta^2, e_j = fma(R2[2][j],
    # -t1_2, fma(R2[1][j], -t1_1, fma(R2[0][j], -t1_0, fma(v, c2_j, fma(u,
    # c1_j, t3_j + q_j))))) in float32.  Held here against that chain with
    # each FMA rounded once from its exact rational value, on observations
    # placed at residual delta from each hypothesis (the band edge) and on
    # padding columns, which never count.
    rng = np.random.default_rng(33)
    f32 = np.float32
    data, _ = _data("crosswire", 34, 256)
    tdata = to_torch(data)
    perms = fs.draw_slot_perms(256, 4, torch.Generator().manual_seed(4))
    samples = fs.reference_samples("crosswire", tdata, perms, 1)[:16]
    rows, degenerate, _ = fs.crosswire_fit([[samples[:, j, c] for c in range(14)]
                                            for j in range(4)], DELTA)
    rows = [r[~degenerate][:8] for r in rows[:12]]              # t1, t3, c1, c2
    hyp = torch.stack(rows, 1).numpy()
    assert hyp.shape == (8, 12)
    pix, rest = [], []
    for t1, t3, c1, c2 in (h.reshape(4, 3).astype(np.float64) for h in hyp):
        for _ in range(6):
            w = rng.uniform(0, np.pi, 3)
            r2 = euler_np(w[2], w[1], w[0])
            uv = rng.uniform(size=2) * np.array([640.0, 480.0])
            e = rng.normal(size=3)
            e *= DELTA / np.linalg.norm(e)
            q = e - (uv[0] * c1 + uv[1] * c2 + t3) + r2.T @ t1
            pix.append(uv)
            rest.append(np.concatenate([q, r2.reshape(9)]))
    pix, rest = np.array(pix, np.float32), np.array(rest, np.float32)   # 48 + 80 padding
    p = fs._us_rows(torch.as_tensor(pix), torch.as_tensor(rest))
    assert p.shape == (16, 128)
    got = fs._crosswire_vote(p, [torch.as_tensor(hyp[:, i]) for i in range(12)], DELTA).numpy()

    def fma(a, b, c):
        return _f32_round(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))

    limit = f32(DELTA * DELTA)
    want, near_edge = [], 0
    for h in hyp:
        t1, t3, c1, c2 = h.reshape(4, 3)
        count = 0
        for (u, v), obs in zip(pix, rest):
            q, r2 = obs[:3], obs[3:].reshape(3, 3)
            e = []
            for j in range(3):
                acc = fma(v, c2[j], fma(u, c1[j], t3[j] + q[j]))    # float32 add first
                for k in range(3):
                    acc = fma(r2[k, j], -t1[k], acc)
                e.append(acc)
            d2 = fma(e[2], e[2], fma(e[1], e[1], e[0] * e[0]))
            count += bool(d2 < limit)
            near_edge += bool(abs(float(d2) - float(limit)) <= 1e-3)
        want.append(count)
    np.testing.assert_array_equal(got, np.array(want))
    assert near_edge >= 6 * len(want)          # the edge observations really sit on the edge


def test_plain_pointer_vote_rounds_each_fma_once_on_band_edge_points():
    # The pointer kernel and its plain version count a cell where
    # fma(e_2, e_2, fma(e_1, e_1, e_0 e_0)) < delta^2, e_j = fma(v, c2_j,
    # fma(u, c1_j, t3_j)) - w_j in float32.  Held here against that chain
    # with each FMA rounded once from its exact rational value, on
    # observations placed at residual delta from each hypothesis (the band
    # edge) and on padding columns, which never count.
    rng = np.random.default_rng(35)
    f32 = np.float32
    data, _ = _data("pointer", 36, 256)
    tdata = to_torch(data)
    perms = fs.draw_slot_perms(256, 3, torch.Generator().manual_seed(4))
    samples = fs.reference_samples("pointer", tdata, perms, 1)[:16]
    rows, degenerate, _ = fs.pointer_fit([[samples[:, j, c] for c in range(17)]
                                          for j in range(3)], DELTA)
    rows = [r[~degenerate][:8] for r in rows[:9]]               # t3, c1, c2
    hyp = torch.stack(rows, 1).numpy()
    assert hyp.shape == (8, 9)
    pix, w = [], []
    for t3, c1, c2 in (h.reshape(3, 3).astype(np.float64) for h in hyp):
        for _ in range(6):
            uv = rng.uniform(size=2) * np.array([640.0, 480.0])
            e = rng.normal(size=3)
            e *= DELTA / np.linalg.norm(e)
            pix.append(uv)
            w.append(uv[0] * c1 + uv[1] * c2 + t3 - e)
    pix, w = np.array(pix, np.float32), np.array(w, np.float32)   # 48 + 80 padding
    p = fs._us_rows(torch.as_tensor(pix), torch.as_tensor(w))
    assert p.shape == (7, 128)
    got = fs._pointer_vote(p, [torch.as_tensor(hyp[:, i]) for i in range(9)], DELTA).numpy()

    def fma(a, b, c):
        return _f32_round(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))

    limit = f32(DELTA * DELTA)
    want, near_edge = [], 0
    for h in hyp:
        t3, c1, c2 = h.reshape(3, 3)
        count = 0
        for (u, v), obs in zip(pix, w):
            e = [fma(v, c2[j], fma(u, c1[j], t3[j])) - obs[j] for j in range(3)]   # f32 subtract
            d2 = fma(e[2], e[2], fma(e[1], e[1], e[0] * e[0]))
            count += bool(d2 < limit)
            near_edge += bool(abs(float(d2) - float(limit)) <= 1e-3)
        want.append(count)
    np.testing.assert_array_equal(got, np.array(want))
    assert near_edge >= 6 * len(want)          # the edge observations really sit on the edge
