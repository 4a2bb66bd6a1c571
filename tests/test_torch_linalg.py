"""Port parity: ``lsqrrecipes_tpu_torch.linalg`` vs ``lsqrrecipes_tpu.linalg``.

Same numpy inputs through both packages on the CPU, float64, to
rtol/atol 1e-12; ranks must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu.linalg import eig as jeig
from lsqrrecipes_tpu.linalg import lstsq as jlstsq
from lsqrrecipes_tpu.linalg import small as jsmall
from lsqrrecipes_tpu_torch.linalg import eig, lstsq, small

torch.set_num_threads(2)

TOL = dict(rtol=1e-12, atol=1e-12)


def _systems(seed, batch, m, n, rank_deficient=False):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(batch, m, n))
    if rank_deficient:
        a[..., -1] = 0.0                 # zero column: rank n - 1
    b = rng.normal(size=(batch, m))
    return a, b


@pytest.mark.parametrize("m,n,deficient", [(6, 4, False), (12, 4, False), (6, 4, True), (3, 3, False)])
def test_pinv_solve_matches_jax(m, n, deficient):
    a, b = _systems(m * 10 + n + deficient, 20, m, n, deficient)
    xj, rj = jlstsq.pinv_solve(jnp.asarray(a), jnp.asarray(b))
    xt, rt = lstsq.pinv_solve(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert int(rt.min()) == (n - 1 if deficient else min(m, n))


def test_masked_pinv_solve_matches_jax():
    a, b = _systems(7, 8, 40, 4)
    mask = np.random.default_rng(8).random((8, 40)) < 0.6
    mask[0, :3], mask[0, 3:] = True, False   # 3 rows only: rank 3 < 4
    xj, rj = jlstsq.masked_pinv_solve(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask))
    xt, rt = lstsq.masked_pinv_solve(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(mask))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert int(rt[0]) == 3


def test_svd_rank_threshold_is_strict():
    s = torch.tensor([1.0, 2.220446049250313e-16, 0.0], dtype=torch.float64)
    assert int(lstsq.svd_rank(s)) == int(jlstsq.svd_rank(jnp.asarray(s.numpy()))) == 1


def test_pinv_solve_keeps_input_dtype():
    a, b = _systems(3, 4, 6, 4)
    x, _ = lstsq.pinv_solve(torch.as_tensor(a, dtype=torch.float32), torch.as_tensor(b))
    assert x.dtype == torch.float32


@pytest.mark.parametrize("singular", [False, True])
def test_solve3_matches_jax(singular):
    rng = np.random.default_rng(11 + singular)
    a = rng.normal(size=(50, 3, 3))
    if singular:
        a[::2, 2] = a[::2, 0]            # det == 0 on every other system
    b = rng.normal(size=(50, 3))
    xj, dj = jsmall.solve3(jnp.asarray(a), jnp.asarray(b))
    xt, dt = small.solve3(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)


def test_solve2_matches_jax():
    rng = np.random.default_rng(13)
    a = rng.normal(size=(50, 2, 2))
    b = rng.normal(size=(50, 2))
    xj, dj = jsmall.solve2(jnp.asarray(a), jnp.asarray(b))
    xt, dt = small.solve2(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)


def _same_up_to_sign(got, want, **tol):
    """Rows of ``got`` equal ``want`` up to each row's sign (neither package
    fixes the sign of an eigen- or singular vector)."""
    sign = np.where(np.sum(got * want, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(got * sign, want, **tol)


@pytest.mark.parametrize("which", ["smallest", "largest"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_eigvec_matches_jax(which, n):
    rng = np.random.default_rng(20 + n)
    x = rng.normal(size=(30, 8, n))
    a = np.einsum("bki,bkj->bij", x, x)           # symmetric positive definite
    vj = np.asarray(getattr(jeig, f"eigvec_{which}")(jnp.asarray(a)))
    vt = getattr(eig, f"eigvec_{which}")(torch.as_tensor(a)).numpy()
    _same_up_to_sign(vt, vj, **TOL)
    np.testing.assert_allclose(np.linalg.norm(vt, axis=-1), 1.0, rtol=1e-12)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_nullvector_matches_jax(k):
    rng = np.random.default_rng(30 + k)
    a = np.concatenate([rng.uniform(-30, 30, size=(40, k, k)), -np.ones((40, k, 1))], axis=-1)
    xj, rj = jlstsq.nullvector(jnp.asarray(a))
    xt, rt = lstsq.nullvector(torch.as_tensor(a))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert int(rt.min()) == k
    _same_up_to_sign(xt.numpy(), np.asarray(xj), **TOL)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", a, xt.numpy()), 0.0, atol=1e-9)
