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
