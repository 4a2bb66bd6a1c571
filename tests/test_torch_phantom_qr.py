"""Port parity: the plane phantom's f32 subspace stage.

``lsqrrecipes_tpu_torch.linalg.small.qr_r_planar`` / ``solve_rt_r_planar``
(the phantom kernel's operation order: one 32-row butterfly sum per column
update and per forward-solve step) vs the JAX package's ``lax.scan`` forms,
and the plain version of the kernel B6 (``ops/phantom_qr.py``) inside
``us_fast._plane_phantom_fit_slots`` vs the JAX package's XLA stage, and the
float64 tail after B6 (``us_fast.phantom_ritz_plain``, the specification of
the kernel ``csrc/phantom_ritz.cu``) vs its earlier ``einsum``/``bmm`` form.

Inputs are made with numpy from a seed.  The two QR forms sum in different
orders, so R's upper triangle and the solves agree to 1e-4 relative to the
largest entry, not bit for bit.  The fits are held on slot planes built from
JAX's own permutation (n = 64, 4 groups): ``valid`` equal, and on valid
lanes the parameters within 1e-4 relative to each parameter's scale, the
median within 1e-5 (the JAX package projects the Ritz matrix in
double-single f32 pairs, the port in native f64, and the two f32 subspaces
differ by rounding).  JAX's Pallas B6 is
never run here: in interpret mode it takes minutes to compile, and JAX's
CPU path is its XLA stage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu.linalg import small as jsmall
from lsqrrecipes_tpu.ops import us_fast as jfast
from lsqrrecipes_tpu.synthetic import make_plane_phantom_data
from lsqrrecipes_tpu_torch import interop, kernels
from lsqrrecipes_tpu_torch.config import HALF_PI, SMALL_ANGLE
from lsqrrecipes_tpu_torch.device import full_f32_matmul
from lsqrrecipes_tpu_torch.linalg import small
from lsqrrecipes_tpu_torch.ops import phantom_qr, us_fast

torch.set_num_threads(2)


def _well_conditioned(seed, n=31, b=16):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n, b)) + 3.0 * np.eye(n)[:, :, None]
    return a.astype(np.float32)


def _phantom_planes(seed, n=64, groups=4, sigma=0.5):
    """``(data, JAX planes, port planes)``: the structured sampling planes of
    JAX's permutation on plane-phantom data, f64."""
    noisy, _, _ = make_plane_phantom_data(jax.random.PRNGKey(seed), n=n, sigma=sigma)
    key = jax.random.PRNGKey(seed + 1)
    jplanes, _ = jfast.build_sampling_planes("plane_phantom", noisy, key, groups)
    data = interop.data_to_torch(noisy, device="cpu")
    perm = np.asarray(jax.random.permutation(key, n))
    tplanes, _ = us_fast.build_sampling_planes("plane_phantom", data, None, groups, perm=perm)
    np.testing.assert_array_equal(tplanes.numpy(), np.asarray(jplanes))
    return data, jplanes, tplanes


def test_rows_sum32_is_the_butterfly_order():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(31, 5)).astype(np.float32)
    got = small.rows_sum32(torch.as_tensor(x))
    assert got.shape == (1, 5)
    want = np.concatenate([x, np.zeros((1, 5), np.float32)])
    for h in (16, 8, 4, 2, 1):
        want = (want[:h] + want[h : 2 * h]).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    # Along another axis, and at 32 entries with no padding.
    y = rng.normal(size=(3, 32, 2)).astype(np.float32)
    assert small.rows_sum32(torch.as_tensor(y), dim=1).shape == (3, 1, 2)
    with pytest.raises(ValueError, match="at most 32"):
        small.rows_sum32(torch.zeros(33, 2))


def _group_split_sum(x, group):
    """The phantom kernel's 32-row sum with ``group`` lanes per hypothesis,
    in numpy float32: lane l holds rows ``l + group m``, adds them in-lane by
    halving (m + per / 2, ..., m + 1), then takes the xor butterfly over the
    group's lanes (h = group / 2, ..., 1).  ``x[32, B]`` -> ``[group, B]``,
    one row per lane."""
    per = 32 // group
    t = [x[np.arange(group) + group * m] for m in range(per)]          # each [group, B]
    h = per // 2
    while h:
        t = [(t[m] + t[m + h]).astype(np.float32) for m in range(h)]
        h //= 2
    s = t[0]
    h = group // 2
    while h:
        s = (s + s[np.arange(group) ^ h]).astype(np.float32)
        h //= 2
    return s


@pytest.mark.parametrize("group", [16, 8])
def test_rows_sum32_is_the_grouped_kernel_order(group):
    # Random f32 with signed zeros, infinities and NaN: every lane of the
    # group ends with rows_sum32's bits (NaN where NaN).
    rng = np.random.default_rng(group)
    x = (rng.standard_normal((32, 4000)) * 2.0 ** rng.integers(-20, 20, (32, 4000)))
    x = x.astype(np.float32)
    special = rng.uniform(size=x.shape)
    x[special < 0.05] = 0.0
    x[(special >= 0.05) & (special < 0.1)] = -0.0
    x[(special >= 0.1) & (special < 0.11)] = np.inf
    x[(special >= 0.11) & (special < 0.12)] = -np.inf
    x[(special >= 0.12) & (special < 0.125)] = np.nan
    x[:, :50] = rng.choice(np.float32([0.0, -0.0]), size=(32, 50))      # all-zero sums
    x[:, :10] = -0.0
    want = small.rows_sum32(torch.as_tensor(x)).numpy()[0]
    lanes = _group_split_sum(x, group)
    for lane in lanes:
        np.testing.assert_array_equal(np.isnan(lane), np.isnan(want))
        live = ~np.isnan(want)
        np.testing.assert_array_equal(lane[live].view(np.uint32), want[live].view(np.uint32))
    assert np.isnan(want).any() and np.isinf(want).any() and np.signbit(want[:50]).any()


@pytest.mark.parametrize("n", [31, 12])
def test_qr_r_planar_matches_jax(n):
    a = _well_conditioned(n, n)
    rj = np.asarray(jsmall.qr_r_planar(jnp.asarray(a)))
    rt = small.qr_r_planar(torch.as_tensor(a)).numpy()
    assert rt.shape == (n, n, 16) and rt.dtype == np.float32
    lower = np.tril(np.ones((n, n), bool), -1)
    assert (rt[lower] == 0).all()
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-4 * np.abs(rj).max())
    # R^T R = A^T A (the factor, whatever the signs of its rows).
    at_a = np.einsum("rib,rjb->ijb", a.astype(np.float64), a.astype(np.float64))
    rt_r = np.einsum("rib,rjb->ijb", rt.astype(np.float64), rt.astype(np.float64))
    np.testing.assert_allclose(rt_r, at_a, rtol=0, atol=1e-5 * np.abs(at_a).max())


def test_qr_r_planar_passes_a_zero_column_through():
    a = _well_conditioned(3, 8, 4)
    a[:, 2] = 0.0
    r = small.qr_r_planar(torch.as_tensor(a))
    assert bool(torch.isfinite(r).all()) and bool((r[2, 2] == 0).all())
    with pytest.raises(ValueError, match="qr_r_planar"):
        small.qr_r_planar(torch.zeros(32, 32, 2))


def test_solve_rt_r_planar_matches_jax():
    a = _well_conditioned(4)
    rj = jsmall.qr_r_planar(jnp.asarray(a))
    d = np.abs(np.diagonal(np.asarray(rj), axis1=0, axis2=1).T) + 0.5
    d[::2] *= -1.0
    v = np.random.default_rng(5).normal(size=(4, 31, 16)).astype(np.float32)
    zj = np.asarray(jsmall.solve_rt_r_planar(rj, jnp.asarray(d), jnp.asarray(v)))
    zt = small.solve_rt_r_planar(torch.as_tensor(np.asarray(rj)), torch.as_tensor(d),
                                 torch.as_tensor(v)).numpy()
    assert zt.shape == (4, 31, 16)
    np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-4 * np.abs(zj).max())
    # z solves R^T R z = v with the clamped diagonal in place of R's.
    r = np.asarray(rj).astype(np.float64).copy()
    idx = np.arange(31)
    r[idx, idx] = d
    rtr = np.einsum("rib,rjb->bij", r, r)
    back = np.einsum("bij,qjb->qib", rtr, zt.astype(np.float64))
    np.testing.assert_allclose(back, v, rtol=0, atol=1e-3)


def test_start_table_is_the_xla_stage_starts():
    got = phantom_qr.start_table()
    assert got.shape == (4, 32) and got.dtype == np.float32 and (got[:, 31] == 0).all()
    for q in range(4):
        c = np.cos(np.arange(31) * (q + 1) * 0.7) + 0.1
        np.testing.assert_array_equal(got[q, :31], (c / np.linalg.norm(c)).astype(np.float32))


def test_phantom_systems_are_the_reference_rows():
    data, _, tplanes = _phantom_planes(12)
    a = us_fast.phantom_systems(tplanes)
    assert a.shape == (31, 31, 256) and a.dtype == torch.float64
    frames, q = data
    i = int(torch.nonzero((frames.t == tplanes[5, 9:12, 17]).all(dim=1))[0])
    r2 = frames.r[i].reshape(9)
    want = torch.cat([q[i, 0] * r2, q[i, 1] * r2, r2, frames.t[i], torch.ones(1, dtype=r2.dtype)])
    assert torch.equal(a[5, :, 17], want)


def test_pack_systems_layout_and_checks():
    a = torch.as_tensor(_well_conditioned(6, 31, 5)).double()
    bands = phantom_qr.pack_systems(a)
    assert bands.shape == (5, 31, 32) and bands.dtype == torch.float32
    assert bool((bands[:, :, 31] == 0).all())
    assert torch.equal(bands[3, 7, :31], a[:, 7, 3].float())
    with pytest.raises(ValueError, match=r"\[31, 31, B\]"):
        phantom_qr.pack_systems(torch.zeros(30, 31, 2))
    with pytest.raises(ValueError, match="float32"):
        phantom_qr.phantom_subspace(bands.double())
    with pytest.raises(ValueError, match=r"\[B, 31, 32\]"):
        phantom_qr.phantom_subspace(bands[:, :, :31])
    # The CUDA wrapper never falls back to the plain version.
    with pytest.raises(ValueError, match="CUDA"):
        phantom_qr.phantom_subspace_cuda(bands)


def test_plain_subspace_holds_the_null_direction():
    _, _, tplanes = _phantom_planes(10)
    a = us_fast.phantom_systems(tplanes)
    before = kernels.PHANTOM_QR.launches
    v = phantom_qr.phantom_subspace(phantom_qr.pack_systems(a)).double()
    assert kernels.PHANTOM_QR.launches == before           # the CPU runs the plain version
    assert v.shape == (4, 31, a.shape[-1]) and bool(torch.isfinite(v).all())
    # Unit vectors.  (Gram-Schmidt in f32 on vectors that inverse iteration
    # has pulled towards one direction keeps them only roughly orthogonal;
    # the f64 Rayleigh-Ritz needs the span alone.)
    np.testing.assert_allclose(torch.sum(v * v, dim=1).numpy(), 1.0, atol=1e-5)
    # The f64 SVD null vector lies in the span to the f32 stage's ~1e-2.
    _, _, vt = torch.linalg.svd(a.permute(2, 0, 1))
    null = vt[:, -1, :]                                    # [B, 31]
    basis, _ = torch.linalg.qr(v.permute(2, 1, 0))         # [B, 31, 4], orthonormal
    resid = null - torch.einsum("bcq,bq->bc", basis, torch.einsum("bcq,bc->bq", basis, null))
    assert float(resid.norm(dim=1).max()) < 1e-2


def test_fit_slots_match_jax_xla_stage():
    _, jplanes, tplanes = _phantom_planes(20)
    pj, vj = jfast._plane_phantom_fit_slots(jplanes, 31)
    pt, vt = us_fast._plane_phantom_fit_slots(tplanes, 31)
    pj, vj, pt, vt = np.asarray(pj), np.asarray(vj), pt.numpy(), vt.numpy()
    assert pt.shape == pj.shape == (256, 41) and pt.dtype == np.float64
    np.testing.assert_array_equal(vt, vj)
    assert vt.mean() > 0.9
    scale = np.abs(pj[vj]).max(axis=0)
    rel = np.abs(pt[vt] - pj[vj]) / scale
    assert rel.max() < 1e-4
    assert np.median(rel) < 1e-5


def test_fit_slots_gate_duplicate_and_translation_only_samples():
    _, jplanes, tplanes = _phantom_planes(30)
    tplanes = tplanes[..., :16].clone()
    jp = np.asarray(jplanes)[..., :16].copy()
    for planes in (tplanes.numpy(), jp):
        planes[:, :, :8] = planes[0:1, :, :8]              # one observation in all slots
        planes[:, 0:9, 8:] = planes[0:1, 0:9, 8:]          # one rotation: translation only
    tp = torch.as_tensor(jp)
    params, valid = us_fast._plane_phantom_fit_slots(tp, 31)
    _, vj = jfast._plane_phantom_fit_slots(jnp.asarray(jp), 31)
    assert not bool(valid.any()) and not bool(np.asarray(vj).any())
    assert bool(torch.isfinite(params).all())


def _einsum_tail(a_pl, v_pl):
    """The tail as it was before it had a kernel: W and S by ``einsum``,
    sigma_0 by ``bmm`` on the packed f32 systems, the norms by ``torch.sum``,
    sums in the library's order."""
    dt, q = a_pl.dtype, 4
    bands = phantom_qr.pack_systems(a_pl)
    fac_ok = torch.isfinite(v_pl).all(dim=1).all(dim=0)
    v64 = v_pl.to(dt)
    w = torch.einsum("rcb,qcb->qrb", a_pl, v64)
    s = torch.einsum("irb,jrb->ijb", w, w)
    sg = [[s[i, j] for j in range(q)] for i in range(q)]
    tiny = torch.finfo(dt).tiny
    trace = sg[0][0] + sg[1][1] + sg[2][2] + sg[3][3]
    shift = 100.0 * torch.finfo(dt).eps * trace + tiny
    s_ll = [[sg[i][j] + shift if i == j else sg[i][j] for j in range(q)] for i in range(q)]
    zeros_b, ones_b = torch.zeros_like(trace), torch.ones_like(trace)
    c = [ones_b] + [zeros_b] * (q - 1)
    for _ in range(2):
        c, _ = small.cholesky_solve_lanes(s_ll, c, q)
        c = us_fast._unit_lanes(c, tiny)
    x_pl = sum(c[j][None, :] * v64[j] for j in range(q))
    xn = 1.0 / torch.clamp_min(torch.sqrt(torch.sum(x_pl * x_pl, dim=0)), tiny)
    xq = [x_pl[i] * xn for i in range(31)]

    def deflate(y):
        dot = sum(ci * yi for ci, yi in zip(c, y))
        return us_fast._unit_lanes([yi - dot * ci for ci, yi in zip(c, y)], tiny)

    y = deflate([zeros_b, ones_b] + [zeros_b] * (q - 2))
    for _ in range(2):
        y, _ = small.cholesky_solve_lanes(s_ll, y, q)
        y = deflate(y)
    lam1 = sum(y[i] * sum(sg[i][j] * y[j] for j in range(q)) for i in range(q))

    def gram_apply(p):
        ap = torch.bmm(p[:, None, :], bands)
        return torch.bmm(bands, ap.transpose(1, 2))[..., 0]

    def norm_rows(p):
        return p * small.rsqrt(torch.clamp_min(torch.sum(p * p, dim=1, keepdim=True), 1e-30))

    pv = torch.full((bands.shape[0], 31), np.float32(1.0 / np.sqrt(31.0)))
    with full_f32_matmul():
        for _ in range(2):
            pv = norm_rows(gram_apply(pv))
        sig0_sq = torch.sum(pv * gram_apply(pv), dim=1).to(dt)
    rank_ok = lam1 > us_fast._PHANTOM_FLT_EPS**2 * torch.clamp_min(sig0_sq, 1.0)
    denom = torch.sqrt(xq[27] ** 2 + xq[28] ** 2 + xq[29] ** 2)
    nondeg = denom > 1e-30
    xr = [xi * (1.0 / torch.where(nondeg, denom, ones_b)) for xi in xq]
    r1 = [xr[27], xr[28], xr[29]]
    wy1 = torch.atan2(-r1[0], torch.sqrt(r1[1] ** 2 + r1[2] ** 2))
    gimbal = ~(((wy1 - HALF_PI).abs() > SMALL_ANGLE) & ((wy1 + HALF_PI).abs() > SMALL_ANGLE))
    cy1 = torch.where(gimbal, ones_b, torch.cos(wy1))
    wx1 = torch.where(gimbal, zeros_b, torch.atan2(r1[1] / cy1, r1[2] / cy1))
    inv = [1.0 / torch.where(r1[j].abs() > 1e-30, r1[j], ones_b) for j in range(3)]
    c1, c2, t3 = ([sum(xr[base + 3 * j + cc] * inv[j] for j in range(3)) / 3.0
                   for cc in range(3)] for base in (0, 9, 18))
    m_x, m_y, r3, ok = us_fast.orthonormalize_lanes(c1, c2)
    m1 = [m_x * r1[j] * r3[cc][0] for j in range(3) for cc in range(3)]
    m2 = [m_y * r1[j] * r3[cc][1] for j in range(3) for cc in range(3)]
    m3 = [r1[j] * t3[cc] for j in range(3) for cc in range(3)]
    cols = [wy1, wx1, xr[30], *t3, *us_fast.euler_zyx_plus_lanes(r3), m_x, m_y,
            *m1, *m2, *m3, *r1]
    return torch.stack(cols, dim=-1), fac_ok & rank_ok & nondeg & ok


@pytest.mark.parametrize("seed", [20, 21, 22])
def test_ritz_in_the_kernel_order_matches_the_einsum_form(seed):
    # The kernel's order of the sums moves W and S by a rounding of |A| |V|;
    # the Ritz vector turns that into ~|W| / (sigma_30^2 - sigma_31^2) of it,
    # so the params move by up to ~1e-11 of their scale where the pair sits
    # close (1.0e-11 measured over 4 x 4,352 hypotheses), and by a rounding
    # (median ~1e-15) elsewhere.
    _, _, tplanes = _phantom_planes(seed)
    a = us_fast.phantom_systems(tplanes)
    v = phantom_qr.phantom_subspace(phantom_qr.pack_systems(a))
    params, valid = us_fast.phantom_ritz(a, v)
    want, want_valid = _einsum_tail(a, v)
    assert params.shape == (256, 41) and params.dtype == torch.float64
    assert torch.equal(valid, want_valid) and float(valid.float().mean()) > 0.9
    scale = want[valid].abs().amax(dim=0)
    rel = (params - want)[valid].abs() / scale
    assert float(rel.max()) < 1e-10
    assert float(rel.median()) < 1e-14


def test_ritz_sigma0_in_the_kernel_order_matches_the_bmm_form():
    # The rank gate's sigma_0^2, two f32 power steps from the uniform vector
    # and a Rayleigh quotient: the bmm form's within f32 rounding, and never
    # above sigma_0^2 (a Rayleigh quotient).
    _, _, tplanes = _phantom_planes(23)
    a = us_fast.phantom_systems(tplanes)
    got = us_fast._phantom_sigma0_sq(a.to(torch.float32))
    assert got.dtype == torch.float32 and got.shape == (256,)
    bands = phantom_qr.pack_systems(a)
    pv = torch.full((256, 31), np.float32(1.0 / np.sqrt(31.0)))
    for _ in range(3):
        g = torch.bmm(bands, torch.bmm(pv[:, None, :], bands).transpose(1, 2))[..., 0]
        want, pv = torch.sum(pv * g, dim=1), g / torch.linalg.norm(g, dim=1, keepdim=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
    sv = torch.linalg.svdvals(a.permute(2, 0, 1))[:, 0]
    assert bool((got.double() <= sv**2 * (1 + 1e-5)).all()) and bool((got > 0).all())
    assert torch.equal(us_fast._sum_in_order(torch.tensor([1e16, 1.0, -1e16, 1.0],
                                                          dtype=torch.float64)),
                       torch.tensor(1.0, dtype=torch.float64))


def test_ritz_float32_systems_follow_the_float64_fit():
    _, _, tplanes = _phantom_planes(24)
    a = us_fast.phantom_systems(tplanes)
    v = phantom_qr.phantom_subspace(phantom_qr.pack_systems(a))
    p64, v64 = us_fast.phantom_ritz(a, v)
    p32, v32 = us_fast.phantom_ritz(a.float(), v)
    assert p32.dtype == torch.float32 and p32.shape == (256, 41)
    both = v64 & v32
    assert float(both.float().mean()) > 0.9
    # The plane normal and t1_z: f32 arithmetic on a null vector resolved
    # from a f32 subspace.
    np.testing.assert_allclose(p32[both][:, 38:41].double().numpy(),
                               p64[both][:, 38:41].numpy(), atol=1e-2)


def test_ritz_wrappers_check_their_inputs():
    _, _, tplanes = _phantom_planes(25)
    a = us_fast.phantom_systems(tplanes[..., :8])
    v = phantom_qr.phantom_subspace(phantom_qr.pack_systems(a))
    with pytest.raises(ValueError, match=r"\[31, 31, B\]"):
        us_fast.phantom_ritz(a[:30], v)
    with pytest.raises(ValueError, match="float32 or float64"):
        us_fast.phantom_ritz(a.to(torch.float16), v)
    with pytest.raises(ValueError, match=r"\[4, 31, 8\]"):
        us_fast.phantom_ritz(a, v[:, :, :7])
    with pytest.raises(ValueError, match="v_pl must be float32"):
        us_fast.phantom_ritz(a, v.double())
    with pytest.raises(ValueError, match="one device"):
        us_fast.phantom_ritz_plain(a, v.to("meta"))
    # B6's [B, 4, 32] output is read in place; any other layout is refused.
    with pytest.raises(ValueError, match="view of B6"):
        us_fast.phantom_ritz_cuda(a, v.contiguous())
    # The CUDA wrapper never falls back to the plain version.
    rows = torch.zeros((8, 4, 32))
    rows[:, :, :31] = v.permute(2, 0, 1)
    before = kernels.PHANTOM_RITZ.launches
    with pytest.raises(ValueError, match="CUDA"):
        us_fast.phantom_ritz_cuda(a, rows[:, :, :31].permute(1, 2, 0))
    assert kernels.PHANTOM_RITZ.launches == before
