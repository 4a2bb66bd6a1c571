"""Port parity: the tiny-system solvers of ``lsqrrecipes_tpu_torch.linalg.small``
(unrolled Cholesky in array and lanes form, ``solve_spd``, the lanes-form
Householder QR) and the Levenberg-Marquardt loop of ``linalg.lm`` vs
``lsqrrecipes_tpu.linalg``.

Inputs are made with numpy from a seed.  float64 results agree to 1e-12 and
float32 ones to 1e-5 relative (two frameworks round the same operations,
and XLA may contract a product and a sum into one FMA); the degeneracy
gates (Cholesky pivot sign, QR pivot collapse) agree exactly.  LM on a
masked problem takes the same number of iterations with the same
``converged`` and lands within 1e-10 relative (at the 1e-15 default
tolerances, where convergence is decided on the rounding floor, the same
``converged`` and point only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu.linalg import lm as jlm
from lsqrrecipes_tpu.linalg import small as jsmall
from lsqrrecipes_tpu_torch.linalg import lm, small

torch.set_num_threads(2)

TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _spd(rng, b, n, dtype):
    m = rng.normal(size=(b, n, n))
    a = m @ np.swapaxes(m, 1, 2) + 0.5 * np.eye(n)
    return a.astype(dtype), rng.normal(size=(b, n)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [4, 6])
def test_cholesky_unrolled_and_lanes_match_jax(n, dtype):
    rng = np.random.default_rng(n)
    a, b = _spd(rng, 50, n, dtype)
    a[0] = -a[0]                                    # not SPD: min_pivot <= 0
    xj, pj = jsmall.cholesky_solve_unrolled(jnp.asarray(a), jnp.asarray(b), n)
    xt, pt = small.cholesky_solve_unrolled(torch.as_tensor(a), torch.as_tensor(b), n)
    assert xt.dtype == torch.as_tensor(a).dtype and xt.shape == (50, n)
    np.testing.assert_array_equal(pt.numpy() <= 0, np.asarray(pj) <= 0)
    assert bool(pt[0] <= 0) and bool((pt[1:] > 0).all())
    tol = TOL[dtype]
    np.testing.assert_allclose(xt[1:].numpy(), np.asarray(xj)[1:], rtol=tol, atol=tol * 10)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=tol, atol=tol * 10)
    lanes_a = [[torch.as_tensor(a[:, i, j]) for j in range(n)] for i in range(n)]
    lanes_b = [torch.as_tensor(b[:, i]) for i in range(n)]
    xl, pl = small.cholesky_solve_lanes(lanes_a, lanes_b, n)
    jl, jp = jsmall.cholesky_solve_lanes([[jnp.asarray(a[:, i, j]) for j in range(n)]
                                          for i in range(n)],
                                         [jnp.asarray(b[:, i]) for i in range(n)], n)
    np.testing.assert_allclose(torch.stack(xl, -1)[1:].numpy(), xt[1:].numpy(), rtol=tol,
                               atol=tol * 10)
    np.testing.assert_allclose(pl.numpy(), pt.numpy(), rtol=tol, atol=tol * 10)
    np.testing.assert_allclose(torch.stack(xl, -1)[1:].numpy(), np.stack(jl, -1)[1:],
                               rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_solve_spd_matches_jax(n):
    rng = np.random.default_rng(10 + n)
    a, b = _spd(rng, 1, n, np.float64)
    xj, sj = jsmall.solve_spd(jnp.asarray(a[0]), jnp.asarray(b[0]))
    xt, st = small.solve_spd(torch.as_tensor(a[0]), torch.as_tensor(b[0]))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(a[0] @ xt.numpy(), b[0], rtol=1e-9, atol=1e-9)
    if n > 1:          # batched (JAX's n = 1 form broadcasts its batch)
        a, b = _spd(rng, 7, n, np.float64)
        xt, _ = small.solve_spd(torch.as_tensor(a), torch.as_tensor(b))
        xj, _ = jsmall.solve_spd(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-12, atol=1e-12)


def _lanes(arr):
    """``[B, R, C]`` -> rows of lists of ``[B]`` tensors."""
    return [[torch.as_tensor(arr[:, r, c]) for c in range(arr.shape[2])]
            for r in range(arr.shape[1])]


def _jlanes(arr):
    return [[jnp.asarray(arr[:, r, c]) for c in range(arr.shape[2])] for r in range(arr.shape[1])]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", [(12, 12), (9, 9), (15, 6)])
def test_qr_solve_lanes_matches_jax(shape, dtype):
    r, c = shape
    rng = np.random.default_rng(r * c)
    a = (rng.normal(size=(64, r, c)) * rng.uniform(0.1, 100.0, size=(64, 1, c))).astype(dtype)
    b = rng.normal(size=(64, r)).astype(dtype)
    a[0, :, 1] = 2.0 * a[0, :, 0]                   # dependent columns: a pivot collapses
    a[1, :, c - 1] = 0.0                            # a zero column
    xt, okt = small.qr_solve_lanes(_lanes(a), [torch.as_tensor(b[:, i]) for i in range(r)])
    xj, okj = jsmall.qr_solve_lanes(_jlanes(a), [jnp.asarray(b[:, i]) for i in range(r)])
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert not bool(okt[0]) and not bool(okt[1]) and bool(okt[2:].all())
    got = torch.stack(xt, -1).numpy()[2:]
    want = np.stack(xj, -1)[2:]
    scale = np.abs(want).max(axis=1, keepdims=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e2 * TOL[dtype] * scale.max())
    # The least-squares solution, to the working precision's conditioning.
    ref = np.stack([np.linalg.lstsq(a[i].astype(np.float64), b[i].astype(np.float64),
                                    rcond=None)[0] for i in range(2, 64)])
    err = np.abs(got - ref).max(axis=1) / np.abs(ref).max(axis=1)
    assert np.median(err) < (1e-10 if dtype == np.float64 else 1e-3)


def _exp_problem(seed, m=60):
    """``y = a exp(b t) + c`` with noise and 10 outliers, which the mask drops."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 2.0, m)
    y = 3.0 * np.exp(-1.3 * t) + 0.5 + 0.01 * rng.normal(size=m)
    y[::6] += 2.0
    mask = np.ones(m, bool)
    mask[::6] = False
    return t, y, mask


def _jax_fns(t, y):
    def res(x, data):
        tt, yy = data
        return x[0] * jnp.exp(x[1] * tt) + x[2] - yy

    return res, jax.jacfwd(res)


def _torch_fns():
    def res(x, data):
        tt, yy = data
        return x[0] * torch.exp(x[1] * tt) + x[2] - yy

    return res, torch.func.jacfwd(res)


@pytest.mark.parametrize("config", [dict(ftol=1e-10, xtol=1e-10), dict(max_iters=7), {}])
def test_levenberg_marquardt_matches_jax_on_a_masked_problem(config):
    t, y, mask = _exp_problem(21)
    x0 = np.array([1.0, -0.5, 0.0])
    jres, jjac = _jax_fns(t, y)
    rj = jlm.levenberg_marquardt(jres, jjac, jnp.asarray(x0), (jnp.asarray(t), jnp.asarray(y)),
                                 mask=jnp.asarray(mask), config=jlm.LMConfig(**config))
    tres, tjac = _torch_fns()
    rt = lm.levenberg_marquardt(tres, tjac, torch.as_tensor(x0),
                                (torch.as_tensor(t), torch.as_tensor(y)),
                                mask=torch.as_tensor(mask), config=lm.LMConfig(**config))
    if config:
        assert int(rt.iterations) == int(rj.iterations)
    # (At the 1e-15 default tolerances the loop stops on the rounding floor,
    # where the last steps' accept or reject follows the last bits of two
    # different summation orders: the iteration counts may differ there.)
    assert bool(rt.converged) == bool(rj.converged)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-8)
    if config.get("max_iters") == 7:
        assert int(rt.iterations) == 7 and not bool(rt.converged)
    else:
        assert bool(rt.converged)
        np.testing.assert_allclose(rt.x.numpy(), [3.0, -1.3, 0.5], atol=0.05)


def test_lm_core_freezes_finished_problems(monkeypatch):
    # Two problems batched over a leading axis give what each gives alone,
    # although one finishes long before the other and the loop checks for
    # completion only every few steps (alone: after every step).
    tres, tjac = _torch_fns()
    problems = []
    for seed, x0 in ((22, [2.9, -1.25, 0.45]), (23, [10.0, 0.5, -4.0])):
        t, y, mask = _exp_problem(seed)
        problems.append((torch.as_tensor(t), torch.as_tensor(y), torch.as_tensor(mask),
                         torch.as_tensor(np.array(x0))))
    monkeypatch.setattr(lm, "_CHECK_EVERY", 1)
    solo = [lm.levenberg_marquardt(tres, tjac, x0, (t, y), mask=m) for t, y, m, x0 in problems]
    monkeypatch.undo()
    assert int(solo[0].iterations) < int(solo[1].iterations)

    def normal_system(x):
        out = []
        for i, (t, y, m, _) in enumerate(problems):
            j = tjac(x[i], (t, y)) * m[:, None]
            r = tres(x[i], (t, y)) * m
            out.append((j.T @ j, j.T @ r))
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    def cost_of(x):
        return torch.stack([0.5 * torch.sum((tres(x[i], (t, y)) * m) ** 2)
                            for i, (t, y, m, _) in enumerate(problems)])

    both = lm.lm_core(normal_system, cost_of, torch.stack([p[3] for p in problems]))
    for i, r in enumerate(solo):
        assert int(both.iterations[i]) == int(r.iterations)
        assert bool(both.converged[i]) == bool(r.converged)
        np.testing.assert_allclose(both.x[i].numpy(), r.x.numpy(), rtol=1e-12, atol=1e-14)
