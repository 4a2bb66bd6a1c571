"""Port parity: ``lsqrrecipes_tpu_torch.ops.sphere_lm`` vs
``lsqrrecipes_tpu.ops.sphere_lm`` (the batched sphere LM kernel, run in
Pallas interpret mode) and the float64 Levenberg-Marquardt.

Problems are made with numpy and handed to both packages.  Tolerances: the
f32 states agree to 1e-3 (the plain version sums with ``torch.sum``, the
interpreted kernel with XLA, in other orders), iteration counts within 2 on
most problems (near the minimum an accept is decided at the f32 resolution
of the cost, so single counts drift apart), and both reach the f64 LM's
minimum within 1e-2 (f32 against f64 at radius ~25).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lsqrrecipes_tpu.estimators.sphere import _sphere_jacobian, _sphere_residual
from lsqrrecipes_tpu.linalg import LMConfig as JLMConfig
from lsqrrecipes_tpu.linalg import levenberg_marquardt as jlm
from lsqrrecipes_tpu.ops import sphere_lm as jsl
from lsqrrecipes_tpu_torch.linalg import LMConfig
from lsqrrecipes_tpu_torch.linalg.small import rsqrt, scalar_like
from lsqrrecipes_tpu_torch.ops import sphere_lm as sl

torch.set_num_threads(2)

F64_CONFIG = dict(max_iters=30, ftol=0.0, xtol=0.0, gtol=1e-6)


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _problems(seed, b, m):
    """B spheres (centres in U(-50, 50)^3, radii in U(10, 40)) with m points
    each and N(0, 0.3) noise; starts at centre + 1, radius - 2 (f32)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-50, 50, (b, 3))
    radii = rng.uniform(10, 40, (b, 1))
    d = rng.normal(size=(b, m, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = centers[:, None, :] + radii[:, :, None] * d + 0.3 * rng.normal(size=(b, m, 3))
    x0 = np.concatenate([centers + 1.0, radii - 2.0], axis=1)
    return pts.astype(np.float32), x0.astype(np.float32), centers, radii[:, 0]


def _jax_f64_lm(pts, x0):
    with jax.enable_x64(True):
        config = JLMConfig(**F64_CONFIG)
        ref = jax.vmap(lambda x0_, p: jlm(_sphere_residual, _sphere_jacobian, x0_, p,
                                          config=config))(
            jnp.asarray(x0, jnp.float64), jnp.asarray(pts, jnp.float64))
        return np.asarray(ref.x), np.asarray(ref.cost), np.asarray(ref.iterations)


def test_pack_lm_problems_matches_jax():
    pts, x0, _, _ = _problems(1, 128, 16)
    planar, x0_t = sl.pack_lm_problems(torch.as_tensor(pts), torch.as_tensor(x0))
    jplanar, jx0_t = jsl.pack_lm_problems(jnp.asarray(pts), jnp.asarray(x0))
    np.testing.assert_array_equal(planar.numpy(), np.asarray(jplanar))
    np.testing.assert_array_equal(x0_t.numpy(), np.asarray(jx0_t))


def test_plain_matches_jax_kernel_and_f64_lm(interpret_pallas):
    b, m = 128, 64
    pts, x0, centers, radii = _problems(0, b, m)
    jx, jcost, jit, jconv = jsl.sphere_lm_batch(jnp.asarray(pts), jnp.asarray(x0),
                                                max_iters=30, block_b=128)
    x, cost, it, conv = sl.sphere_lm_batch(pts, x0, max_iters=30, device="cpu")
    assert x.dtype == torch.float32 and it.dtype == torch.int32 and conv.dtype == torch.bool
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-3)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(jconv))
    # Near the minimum the predicted decrease falls below the f32 resolution
    # of the cost, so accepting a step is decided by rounding and the
    # iteration counts of single problems drift apart (up to 8 here); most
    # stay within 2.
    assert np.mean(np.abs(it.numpy() - np.asarray(jit)) <= 2) >= 0.5
    np.testing.assert_allclose(cost.numpy(), np.asarray(jcost), rtol=1e-3, atol=1e-3)
    # Both reach the f64 LM's minimum and the ground truth to noise level.
    rx, rcost, _ = _jax_f64_lm(pts, x0)
    for got in (x.numpy(), np.asarray(jx)):
        assert np.abs(got - rx).max() < 1e-2
        assert np.abs(got[:, :3] - centers).max() < 0.5
        assert np.abs(got[:, 3] - radii).max() < 0.5
    assert np.max(np.abs(cost.numpy() - rcost) / (1.0 + rcost)) < 1e-2
    assert int(it.max()) <= 30


def test_f64_oracle_matches_jax_f64_lm():
    pts, x0, _, _ = _problems(2, 32, 48)
    rx, rcost, rit = _jax_f64_lm(pts, x0)
    got = sl.sphere_lm_batch_f64(pts, x0, LMConfig(**F64_CONFIG), device="cpu")
    assert got.x.dtype == torch.float64
    np.testing.assert_allclose(got.x.numpy(), rx, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got.cost.numpy(), rcost, rtol=1e-8, atol=1e-12)
    assert np.abs(got.iterations.numpy() - rit).max() <= 1
    assert bool(got.converged.all())


def test_converged_lanes_freeze_like_jax(interpret_pallas):
    # An exact sphere converges almost at once; its iterations stop counting.
    b, m = 128, 32
    pts, _, centers, radii = _problems(3, b, m)
    dirs = pts - centers[:, None, :]
    exact = centers[:, None, :] + radii[:, None, None] * dirs / np.linalg.norm(
        dirs, axis=-1, keepdims=True)
    exact = exact.astype(np.float32)
    x_true = np.concatenate([centers, radii[:, None]], axis=1).astype(np.float32)
    x, cost, it, conv = sl.sphere_lm_batch(exact, x_true, max_iters=25, device="cpu")
    assert bool(conv.all()) and int(it.max()) < 25 and float(cost.max()) < 1e-6
    jx, jcost, jit, jconv = jsl.sphere_lm_batch(jnp.asarray(exact), jnp.asarray(x_true),
                                                max_iters=25, block_b=128)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(jconv))
    # Both stop by the damping blowing up at the f32 floor of the cost.
    assert np.mean(np.abs(it.numpy() - np.asarray(jit)) <= 2) >= 0.5
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-4)


def test_frozen_problems_keep_their_state():
    # Exact problems beside noisy ones: the exact ones stop early and their
    # results equal those of a run of the exact ones alone.
    pts, x0, centers, radii = _problems(4, 6, 40)
    dirs = pts - centers[:, None, :]
    exact = (centers[:, None, :] + radii[:, None, None] * dirs
             / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    x_true = np.concatenate([centers, radii[:, None]], axis=1).astype(np.float32)
    mixed_pts = np.concatenate([exact[:3], pts[3:]])
    mixed_x0 = np.concatenate([x_true[:3], x0[3:]])
    x, cost, it, conv = sl.sphere_lm_batch(mixed_pts, mixed_x0, device="cpu")
    xa, costa, ita, conva = sl.sphere_lm_batch(exact[:3], x_true[:3], device="cpu")
    np.testing.assert_allclose(x[:3].numpy(), xa.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(it[:3], ita) and torch.equal(conv[:3], conva)
    assert int(it[:3].max()) < int(it[3:].min())


def test_any_batch_size_and_max_iters_cap():
    pts, x0, _, _ = _problems(5, 5, 24)       # B % 128 != 0 is fine here
    x, cost, it, conv = sl.sphere_lm_batch(pts, x0, max_iters=2, device="cpu")
    assert x.shape == (5, 4) and cost.shape == it.shape == conv.shape == (5,)
    assert int(it.max()) <= 2 and bool(torch.isfinite(x).all())


def test_rejects_bad_shapes():
    pts, x0, _, _ = _problems(6, 4, 8)
    with pytest.raises(ValueError, match="points"):
        sl.sphere_lm_batch(pts[:, :, :2], x0, device="cpu")
    with pytest.raises(ValueError, match="x0"):
        sl.sphere_lm_batch(pts, x0[:3], device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        sl.sphere_lm_batch_cuda(torch.as_tensor(pts), torch.as_tensor(x0))


def _two_pass_plain(points, x0, max_iters=30, init_lambda=1e-3, max_lambda=1e12, gtol=1e-6):
    """The plain version's earlier two-pass form, kept as the reference of
    the one-pass form: each iteration forms the 13 sums at x, then the cost
    at the trial point, and carries nothing."""
    m = points.shape[1]
    planar, x0_t = sl.pack_lm_problems(points, x0)
    px, py, pz = planar[0:m], planar[m : 2 * m], planar[2 * m :]
    cx, cy, cz, r = x0_t[0], x0_t[1], x0_t[2], x0_t[3]

    def c(value):
        return scalar_like(value, cx)

    def cost_at(cx, cy, cz, r):
        dx, dy, dz = px - cx, py - cy, pz - cz
        f = torch.sqrt(dx * dx + dy * dy + dz * dz) - r
        return 0.5 * torch.sum(f * f, dim=0)

    tiny, one, two, half = c(1e-30), c(1.0), c(2.0), c(0.5)
    cost = cost_at(cx, cy, cz, r)
    lam, nu = torch.full_like(cx, init_lambda), torch.full_like(cx, 2.0)
    conv, iters = torch.zeros_like(cx), torch.zeros_like(cx)
    mm = torch.full_like(cx, float(m))
    for _ in range(max_iters):
        active = one - conv
        dx, dy, dz = px - cx, py - cy, pz - cz
        s = dx * dx + dy * dy + dz * dz
        rd = rsqrt(torch.clamp_min(s, c(1e-24)))
        ux, uy, uz = dx * rd, dy * rd, dz * rd
        f = s * rd - r

        def rsum(v):
            return torch.sum(v, dim=0)

        sxx, sxy, sxz = rsum(ux * ux), rsum(ux * uy), rsum(ux * uz)
        syy, syz, szz = rsum(uy * uy), rsum(uy * uz), rsum(uz * uz)
        sx, sy, sz = rsum(ux), rsum(uy), rsum(uz)
        gx, gy, gz, gr = -rsum(ux * f), -rsum(uy * f), -rsum(uz * f), -rsum(f)
        gnorm = torch.maximum(torch.maximum(gx.abs(), gy.abs()),
                              torch.maximum(gz.abs(), gr.abs()))
        damp = one + lam
        l00 = torch.sqrt(torch.clamp_min(sxx * damp, tiny))
        l10, l20, l30 = sxy / l00, sxz / l00, sx / l00
        l11 = torch.sqrt(torch.clamp_min(syy * damp - l10 * l10, tiny))
        l21, l31 = (syz - l20 * l10) / l11, (sy - l30 * l10) / l11
        l22 = torch.sqrt(torch.clamp_min(szz * damp - l20 * l20 - l21 * l21, tiny))
        l32 = (sz - l30 * l20 - l31 * l21) / l22
        l33 = torch.sqrt(torch.clamp_min(mm * damp - l30 * l30 - l31 * l31 - l32 * l32, tiny))
        y0 = -gx / l00
        y1 = (-gy - l10 * y0) / l11
        y2 = (-gz - l20 * y0 - l21 * y1) / l22
        y3 = (-gr - l30 * y0 - l31 * y1 - l32 * y2) / l33
        s3 = y3 / l33
        s2 = (y2 - l32 * s3) / l22
        s1 = (y1 - l21 * s2 - l31 * s3) / l11
        s0 = (y0 - l10 * s1 - l20 * s2 - l30 * s3) / l00
        cost_new = cost_at(cx + s0, cy + s1, cz + s2, r + s3)
        j0 = sxx * s0 + sxy * s1 + sxz * s2 + sx * s3
        j1 = sxy * s0 + syy * s1 + syz * s2 + sy * s3
        j2 = sxz * s0 + syz * s1 + szz * s2 + sz * s3
        j3 = sx * s0 + sy * s1 + sz * s2 + mm * s3
        predicted = -(s0 * gx + s1 * gy + s2 * gz + s3 * gr) - half * (
            s0 * j0 + s1 * j1 + s2 * j2 + s3 * j3)
        rho = (cost - cost_new) / torch.clamp_min(predicted, tiny)
        accept = (torch.isfinite(cost_new) & (cost_new < cost)).to(cx.dtype) * active
        t = two * rho - one
        shrink = torch.clamp_min(one - t * (t * t), c(1.0 / 3.0))
        lam_acc = torch.clamp_min(lam * shrink, c(1e-18))
        lam_rej = torch.clamp_max(lam * nu, c(max_lambda))
        lam = torch.where(accept > 0, lam_acc, torch.where(active > 0, lam_rej, lam))
        nu = torch.where(accept > 0, two, torch.where(active > 0, nu * two, nu))
        cx, cy, cz, r = cx + accept * s0, cy + accept * s1, cz + accept * s2, r + accept * s3
        cost = torch.where(accept > 0, cost_new, cost)
        newly = ((gnorm < c(gtol)) | (lam >= c(max_lambda))).to(cx.dtype)
        conv = torch.maximum(conv, newly * active)
        iters = iters + active
        if bool((conv > 0).all()):
            break
    return torch.stack([cx, cy, cz, r], dim=1), cost, iters.to(torch.int32), conv > 0


def _lm_case(kind):
    """Problems that converge (noisy spheres), problems that freeze at once
    beside them (exact spheres started at their truth), and problems whose
    step goes non-finite (a point at 1e20 overflows s, so the f sums and the
    step are NaN and x + 0 NaN poisons the centre)."""
    pts, x0, centers, radii = _problems(10, 24, 40)
    if kind == "frozen":
        dirs = pts - centers[:, None, :]
        exact = centers[:, None, :] + radii[:, None, None] * dirs / np.linalg.norm(
            dirs, axis=-1, keepdims=True)
        pts[:8] = exact[:8].astype(np.float32)
        x0[:8] = np.concatenate([centers, radii[:, None]], axis=1)[:8].astype(np.float32)
    if kind == "nan_step":
        pts[3, 7] = 1e20
        pts[11, 0, 2] = -1e20
    return torch.as_tensor(pts), torch.as_tensor(x0)


@pytest.mark.parametrize("kind", ["converging", "frozen", "nan_step"])
def test_one_pass_plain_equals_the_two_pass_form_bit_for_bit(kind):
    # The plain version evaluates once per iteration at the trial point and
    # carries those sums on accept (NaN where x + 0 s poisons x): the same
    # arithmetic as forming the sums at x every iteration.
    pts, x0 = _lm_case(kind)
    got = sl.sphere_lm_batch_plain(pts, x0)
    want = _two_pass_plain(pts, x0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    if kind == "nan_step":
        assert bool(got[0][[3, 11]].isnan().all()) and bool(got[3][[3, 11]].all())
        assert bool(torch.isfinite(got[0][:3]).all())
    if kind == "frozen":   # the exact problems stop first and hold beside the others
        assert float(got[1][:8].max()) < 1e-6 and bool(got[3].all())
        assert int(got[2][:8].max()) < int(got[2][8:].max())
