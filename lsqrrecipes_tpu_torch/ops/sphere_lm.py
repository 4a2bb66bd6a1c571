"""Batched Levenberg-Marquardt for geometric sphere refinement (counterpart
of ``lsqrrecipes_tpu/ops/sphere_lm.py``).

B independent problems ``min 0.5 sum_i (||p_i - c|| - r)^2`` in float32,
each with its own start, damping and convergence.  With unit directions
``u_i = (p_i - c) / ||p_i - c||`` and ``f_i = ||p_i - c|| - r`` the Jacobian
rows are ``[-u_i, -1]``, so the normal equations come from 13 sums:

    J^T J = [[ S_uu,  s_u ],     J^T r = [ -S_uf ]
             [ s_u^T,  m   ]]             [ -s_f  ]

(``S_uu = sum u u^T`` 6 unique, ``s_u = sum u`` 3, ``S_uf = sum u f`` 3,
``s_f = sum f`` 1).  Each step solves the damped system ``(J^T J + lam
diag(J^T J)) s = -J^T r`` by an unrolled 4x4 Cholesky with 1e-30 pivot
floors, and follows Nielsen's damping rule: accept when the trial cost is
finite and lower (``lam *= max(1/3, 1 - (2 rho - 1)^3)``, at least 1e-18,
``nu = 2``), else ``lam *= nu`` (at most ``max_lambda``) and ``nu *= 2``.  A
problem converges when the gradient's largest entry is below ``gtol`` or
``lam`` reaches ``max_lambda``; from then on its state is frozen and its
iteration count stops.  These are the TPU kernel's rules, not
:mod:`lsqrrecipes_tpu_torch.linalg.lm`'s: no ``ftol``/``xtol`` tests and no
floor on the Marquardt diagonal.

On CUDA tensors :func:`sphere_lm_batch` launches the hand-written kernel
(``csrc/sphere_lm.cu``, a group of lanes per problem, one evaluation per
iteration); on CPU tensors it runs
:func:`sphere_lm_batch_plain`, the same formulas in plain PyTorch.
:func:`sphere_lm_batch_f64` is the float64 oracle: the general LM
(:func:`~lsqrrecipes_tpu_torch.linalg.lm.lm_core`) batched over the
problems.
"""

import ctypes

import torch

from lsqrrecipes_tpu_torch import kernels
from lsqrrecipes_tpu_torch.device import as_tensor
from lsqrrecipes_tpu_torch.estimators.sphere import _sphere_jacobian, _sphere_residual
from lsqrrecipes_tpu_torch.linalg.lm import LMConfig, LMResult, lm_core
from lsqrrecipes_tpu_torch.linalg.small import rsqrt, scalar_like

_EPS_TINY = 1e-30


def _check_lm_args(points, x0):
    if points.ndim != 3 or points.shape[2] != 3:
        raise ValueError(f"points must be [B, m, 3], got {tuple(points.shape)}")
    if x0.shape != (points.shape[0], 4):
        raise ValueError(f"x0 must be [{points.shape[0]}, 4], got {tuple(x0.shape)}")
    if points.shape[1] < 1:
        raise ValueError("each problem needs at least one observation")
    if points.device != x0.device:
        raise ValueError("points and x0 lie on different devices")


def pack_lm_problems(points, x0):
    """``points[B, m, 3], x0[B, 4] -> (pts_planar[3m, B], x0_t[4, B])``
    float32: rows x of every observation, then y, then z; problems on the
    columns."""
    pts = points.to(torch.float32)
    planar = torch.cat([pts[:, :, 0].T, pts[:, :, 1].T, pts[:, :, 2].T], dim=0)
    return planar, x0.to(torch.float32).T


def _evaluate(px, py, pz, cx, cy, cz, r):
    """``(cost[B], sums)`` at ``(cx, cy, cz, r)`` over the ``[m, B]`` planes:
    ``0.5 sum_i (||p_i - c|| - r)^2`` and the 13 sums ``[S_xx, S_xy, S_xz,
    S_yy, S_yz, S_zz, s_x, s_y, s_z, S_fx, S_fy, S_fz, s_f]`` with ``u_i =
    (p_i - c) / sqrt(max(s_i, 1e-24))`` and ``f_i = s_i / sqrt(max(s_i,
    1e-24)) - r`` (the kernel takes that value with one square root)."""
    dx, dy, dz = px - cx, py - cy, pz - cz
    s = dx * dx + dy * dy + dz * dz
    rd = rsqrt(torch.clamp_min(s, scalar_like(1e-24, s)))
    fc = torch.sqrt(s) - r
    f = s * rd - r
    ux, uy, uz = dx * rd, dy * rd, dz * rd

    def rsum(v):
        return torch.sum(v, dim=0)

    sums = [rsum(ux * ux), rsum(ux * uy), rsum(ux * uz), rsum(uy * uy), rsum(uy * uz),
            rsum(uz * uz), rsum(ux), rsum(uy), rsum(uz), rsum(ux * f), rsum(uy * f),
            rsum(uz * f), rsum(f)]
    return 0.5 * rsum(fc * fc), sums


def sphere_lm_batch_plain(points, x0, max_iters=30, init_lambda=1e-3, max_lambda=1e12,
                          gtol=1e-6):
    """Plain PyTorch version of the kernel, formula for formula: ``points[B,
    m, 3], x0[B, 4] -> (x[B, 4], cost[B], iterations int32[B], converged
    bool[B])`` in float32.  One evaluation per iteration, at the trial
    point, gives its cost and its 13 sums; an accepted step carries them
    into the next iteration (the new x is the trial point bit for bit), a
    rejected one keeps the previous sums, NaN where ``x + 0 s`` made the
    centre NaN (all 13) or only ``r`` (the four ``f`` sums), as sums
    recomputed at that x would be.  The sums are ``torch.sum`` over the
    observations, so they add in another order than the kernel's group
    sums."""
    _check_lm_args(points, x0)
    m = points.shape[1]
    planar, x0_t = pack_lm_problems(points, x0)
    px, py, pz = planar[0:m], planar[m : 2 * m], planar[2 * m :]
    cx, cy, cz, r = x0_t[0], x0_t[1], x0_t[2], x0_t[3]

    def c(value):
        return scalar_like(value, cx)

    tiny, one, two, half = c(_EPS_TINY), c(1.0), c(2.0), c(0.5)
    nan = c(float("nan"))
    cost, sums = _evaluate(px, py, pz, cx, cy, cz, r)
    lam = torch.full_like(cx, init_lambda)
    nu = torch.full_like(cx, 2.0)
    conv = torch.zeros_like(cx)
    iters = torch.zeros_like(cx)
    mm = torch.full_like(cx, float(m))
    for _ in range(int(max_iters)):
        active = one - conv
        sxx, sxy, sxz, syy, syz, szz, sx, sy, sz = sums[:9]
        gx, gy, gz, gr = (-v for v in sums[9:])
        gnorm = torch.maximum(torch.maximum(gx.abs(), gy.abs()),
                              torch.maximum(gz.abs(), gr.abs()))

        damp = one + lam
        a00, a11, a22, a33 = sxx * damp, syy * damp, szz * damp, mm * damp
        b0, b1, b2, b3 = -gx, -gy, -gz, -gr
        l00 = torch.sqrt(torch.clamp_min(a00, tiny))
        l10, l20, l30 = sxy / l00, sxz / l00, sx / l00
        l11 = torch.sqrt(torch.clamp_min(a11 - l10 * l10, tiny))
        l21 = (syz - l20 * l10) / l11
        l31 = (sy - l30 * l10) / l11
        l22 = torch.sqrt(torch.clamp_min(a22 - l20 * l20 - l21 * l21, tiny))
        l32 = (sz - l30 * l20 - l31 * l21) / l22
        l33 = torch.sqrt(torch.clamp_min(a33 - l30 * l30 - l31 * l31 - l32 * l32, tiny))
        y0 = b0 / l00
        y1 = (b1 - l10 * y0) / l11
        y2 = (b2 - l20 * y0 - l21 * y1) / l22
        y3 = (b3 - l30 * y0 - l31 * y1 - l32 * y2) / l33
        s3 = y3 / l33
        s2 = (y2 - l32 * s3) / l22
        s1 = (y1 - l21 * s2 - l31 * s3) / l11
        s0 = (y0 - l10 * s1 - l20 * s2 - l30 * s3) / l00

        cost_new, sums_new = _evaluate(px, py, pz, cx + s0, cy + s1, cz + s2, r + s3)
        jtj_s0 = sxx * s0 + sxy * s1 + sxz * s2 + sx * s3
        jtj_s1 = sxy * s0 + syy * s1 + syz * s2 + sy * s3
        jtj_s2 = sxz * s0 + syz * s1 + szz * s2 + sz * s3
        jtj_s3 = sx * s0 + sy * s1 + sz * s2 + mm * s3
        predicted = -(s0 * gx + s1 * gy + s2 * gz + s3 * gr) - half * (
            s0 * jtj_s0 + s1 * jtj_s1 + s2 * jtj_s2 + s3 * jtj_s3)
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
        centre_nan = cx.isnan() | cy.isnan() | cz.isnan()
        poisoned = [centre_nan] * 9 + [centre_nan | r.isnan()] * 4
        sums = [torch.where(accept > 0, new, torch.where(bad, nan, old))
                for new, old, bad in zip(sums_new, sums, poisoned)]

        newly = ((gnorm < c(gtol)) | (lam >= c(max_lambda))).to(cx.dtype)
        conv = torch.maximum(conv, newly * active)
        iters = iters + active
        if bool((conv > 0).all()):
            break
    return (torch.stack([cx, cy, cz, r], dim=1), cost, iters.to(torch.int32), conv > 0)


def sphere_lm_batch_cuda(points, x0, max_iters=30, init_lambda=1e-3, max_lambda=1e12,
                         gtol=1e-6):
    """Launch ``csrc/sphere_lm.cu`` on the current stream; same contract as
    :func:`sphere_lm_batch_plain`.  The kernel reads ``points[B, m, 3]`` as
    it lies.  Raises on a non-CUDA, non-f32 or non-contiguous input, and
    when the build or the launch fails."""
    _check_lm_args(points, x0)
    x0 = x0.contiguous()
    kernels.check_inputs(points=points, x0=x0)
    b, m = points.shape[0], points.shape[1]
    if b >= 2**31 or 3 * m >= 2**31:
        raise ValueError("sphere_lm_batch supports fewer than 2^31 problems and observations")
    out = torch.empty((b, 8), dtype=torch.float32, device=points.device)
    if b:
        with torch.cuda.device(points.device):
            stream = torch.cuda.current_stream().cuda_stream
            kernels.SPHERE_LM.launch(
                points.data_ptr(), x0.data_ptr(), b, m, int(max_iters),
                ctypes.c_float(float(init_lambda)), ctypes.c_float(float(max_lambda)),
                ctypes.c_float(float(gtol)), out.data_ptr(), stream,
            )
    return out[:, 0:4], out[:, 4], out[:, 5].to(torch.int32), out[:, 6] > 0


def sphere_lm_batch(points, x0, max_iters: int = 30, init_lambda: float = 1e-3,
                    max_lambda: float = 1e12, gtol: float = 1e-6, *, device=None):
    """Levenberg-Marquardt refinement of B independent spheres in float32.

    ``points[B, m, 3]``, ``x0[B, 4]`` (start ``[cx, cy, cz, r]``) ->
    ``(x[B, 4], cost[B], iterations int32[B], converged bool[B])``; at most
    ``max_iters`` steps per problem, any B.  Numpy input goes to ``device``
    (default CUDA), a tensor stays on its device and ``x0`` follows
    ``points``.  On CUDA this launches the kernel, on the CPU it runs
    :func:`sphere_lm_batch_plain`.  :func:`sphere_lm_batch_f64` is the
    float64 parity path.
    """
    points = as_tensor(points, device, torch.float32)
    x0 = as_tensor(x0, points.device, torch.float32)
    if points.is_cuda:
        return sphere_lm_batch_cuda(points.contiguous(), x0, max_iters, init_lambda,
                                    max_lambda, gtol)
    return sphere_lm_batch_plain(points, x0, max_iters, init_lambda, max_lambda, gtol)


def sphere_lm_batch_f64(points, x0, config: LMConfig = LMConfig(max_iters=30, ftol=0.0,
                                                                 xtol=0.0, gtol=1e-6),
                        *, device=None) -> LMResult:
    """The general Levenberg-Marquardt (:func:`~lsqrrecipes_tpu_torch.linalg.lm.lm_core`,
    float64) on the geometric residual of every problem at once: ``points[B,
    m, 3], x0[B, 4] -> LMResult`` with ``[B]``-leading fields.  Each problem
    gives what it gives alone (finished problems freeze)."""
    points = as_tensor(points, device, torch.float64)
    x0 = as_tensor(x0, points.device, torch.float64)

    def cost_of(x):
        f = _sphere_residual(x, points)
        return 0.5 * torch.sum(f * f, dim=-1)

    def normal_system(x):
        f = _sphere_residual(x, points)
        j = _sphere_jacobian(x, points)
        return j.mT @ j, (j.mT @ f[..., None])[..., 0]

    return lm_core(normal_system, cost_of, x0, config)
