"""Port parity: the plane phantom's f32 subspace stage.

``lsqrrecipes_tpu_torch.linalg.small.qr_r_planar`` / ``solve_rt_r_planar``
(the phantom kernel's operation order: one 32-row butterfly sum per column
update and per forward-solve step) vs the JAX package's ``lax.scan`` forms,
and the plain version of the kernel B6 (``ops/phantom_qr.py``) inside
``us_fast._plane_phantom_fit_slots`` vs the JAX package's XLA stage.

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
