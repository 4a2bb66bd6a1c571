"""Sufficient-statistics Levenberg-Marquardt for feature-affine residuals
(counterpart of ``lsqrrecipes_tpu/linalg/stats_lm.py``).

The ultrasound calibrations' refits
(``SinglePointTargetUSCalibrationParametersEstimator.cxx:272-297,916-973``,
``PlanePhantomUSCalibrationParametersEstimator.cxx:357-447``) re-evaluate
residuals and a Jacobian over all n observations every iteration.  After
rotating each residual by the (orthogonal) tracker rotation ``R2_i``, every
residual is linear in a fixed per-observation feature vector ``h_i`` with
parameter-dependent coefficients, ``r_i(x) = W(x) h_i`` (``W: [R, F]``), so
the whole Gauss-Newton structure collapses onto the mask-weighted feature
Gram matrix ``H = sum_i m_i h_i h_i^T``:

    cost(x)  = 0.5 tr(W H W^T)
    g(x)     = J^T r = einsum(T, H, W)        T = dW/dx: [R, F, P]
    J^T J(x) = einsum(T, H, T)

Every iteration then costs O(R F^2 P + P^2 F R), independent of n; the
observations are touched once, to build H.  The loop is
:func:`lsqrrecipes_tpu_torch.linalg.lm.lm_core`, the same damping schedule,
accept rule and convergence tests as the full LM, batched over a leading
problem axis with its lane freeze.

Feature maps (the reference's residual definitions):

  * pointer (P = 8, F = 6): ``h = [u, v, 1, R2^T (p - t2)]``,
    ``W = [m_x r1 | m_y r2 | t3 | -I]`` (``...cxx:1059-1149``);
  * crosswire (P = 11, F = 15): ``h = [u, v, 1, R2^T t2, vec(R2)]``, the
    ``t1`` term linear in ``vec(R2)`` (``...cxx:415-509``);
  * plane phantom (P = 11, F = 31, R = 1): ``h = [R2 (x) z (27), t2, 1]``,
    the homogeneous 31-column system of the analytic fit
    (``PlanePhantom...cxx:119-355`` / residual ``:357-447``).

``T`` is ``torch.func.jacfwd`` of ``W``, vmapped over the problem axis.  The
JAX package spells the batched quadratic forms out as Python-unrolled sums
over R x F (a TPU tile-padding workaround); here they are the batched
``einsum`` of the single-problem form.  Everything runs in float64.
"""

from typing import Callable, Optional

import torch

from lsqrrecipes_tpu_torch.geometry import rotations
from lsqrrecipes_tpu_torch.linalg.lm import LMConfig, LMResult, lm_core


def _jacobian(w_fn, x, w_args):
    """``dW/dx``: ``[R, F, P]`` for ``x [P]``, ``[B, R, F, P]`` for ``x [B, P]``
    (``w_args`` then per-problem ``[B, ...]``)."""
    jac = torch.func.jacfwd(w_fn)
    return jac(x, *w_args) if x.dim() == 1 else torch.func.vmap(jac)(x, *w_args)


def _quadratics(w_fn, h, x, w_args=()):
    """``(J^T J [..., P, P], g [..., P])`` at ``x`` from the Gram ``h [..., F, F]``."""
    w = w_fn(x, *w_args)                                # [..., R, F]
    t = _jacobian(w_fn, x, w_args)                      # [..., R, F, P]
    g = torch.einsum("...rfp,...rf->...p", t, w @ h)
    th = torch.einsum("...rfp,...fe->...rep", t, h)
    return torch.einsum("...rep,...req->...pq", th, t), g


def _cost(w_fn, h, x, w_args=()):
    """``0.5 tr(W H W^T)`` ``[...]``."""
    w = w_fn(x, *w_args)
    return 0.5 * torch.sum((w @ h) * w, dim=(-2, -1))


def feature_lm(
    w_fn: Callable,
    h: torch.Tensor,
    x0: torch.Tensor,
    config: LMConfig = LMConfig(),
    w_args=(),
) -> LMResult:
    """Minimize ``0.5 sum_i ||W(x) h_i||^2`` given ``H = sum h_i h_i^T``.

    ``w_fn(x, *w_args) -> W [..., R, F]`` takes leading axes; ``x0 [P]`` with
    ``h [F, F]``, or ``x0 [B, P]`` with ``h [B, F, F]`` and per-problem
    ``w_args`` ``[B, ...]`` (B problems in lockstep, each frozen once done).
    """

    def normal_system(x):
        return _quadratics(w_fn, h, x, w_args)

    def cost_of(x):
        return _cost(w_fn, h, x, w_args)

    return lm_core(normal_system, cost_of, x0, config)


def feature_lm_planar(w_fn, h, x0, config: LMConfig = LMConfig(), w_args=()) -> LMResult:
    """Batched :func:`feature_lm`: ``h [B, F, F]``, ``x0 [B, P]``, optional
    per-problem ``w_args`` ``[B, ...]`` for ``w_fn``."""
    if x0.dim() != 2:
        raise ValueError(f"x0 must be [B, P], got {tuple(x0.shape)}")
    return feature_lm(w_fn, h, x0, config, w_args)


# ---------------------------------------------------------------------------
# Objective adapters.  Parameter layouts match the residual functions of
# estimators/us_calibration.py, so minima are directly comparable.  Every
# function takes leading axes.


def _weights(h, mask):
    """Observation weights ``[..., n]`` for features ``h [..., n, F]``."""
    if mask is None:
        return torch.ones(h.shape[:-1], dtype=h.dtype, device=h.device)
    return mask.to(h.dtype)


def _gram(h, wts):
    """``sum_n w_n h_n h_n^T`` ``[..., F, F]``."""
    return torch.einsum("...ni,...nj,...n->...ij", h, h, wts)


def _scaled_columns(x, t3, angles, scales):
    """``A = [m_x r1 | m_y r2 | t3]`` ``[..., 3, 3]`` for ``R3 =
    Euler-ZYX(x[angles])`` (``angles`` = indices of w_z, w_y, w_x)."""
    r3 = rotations.matrix_from_euler_zyx(x[..., angles[2]], x[..., angles[1]],
                                         x[..., angles[0]])
    return torch.stack([x[..., scales, None] * r3[..., :, 0],
                        x[..., scales + 1, None] * r3[..., :, 1], t3], dim=-1)


def _eye3(x):
    return torch.eye(3, dtype=x.dtype, device=x.device)


def pointer_w(x):
    """``x = [t3 3, w_z, w_y, w_x, m_x, m_y]`` -> ``W [..., 3, 6]``."""
    a = _scaled_columns(x, x[..., 0:3], (3, 4, 5), 6)
    return torch.cat([a, -_eye3(x).expand(a.shape)], dim=-1)


def crosswire_w(x):
    """``x = [t1 3, t3 3, w_z, w_y, w_x, m_x, m_y]`` -> ``W [..., 3, 15]``."""
    t1 = x[..., 0:3]
    a = _scaled_columns(x, x[..., 3:6], (6, 7, 8), 9)
    eye = _eye3(x)
    # [b, 3a + c] = -t1_a delta_bc: the Kronecker product -t1^T (x) I.
    t1_block = (-t1[..., None, :, None] * eye[:, None, :]).reshape(*x.shape[:-1], 3, 9)
    return torch.cat([a, eye.expand(a.shape), t1_block], dim=-1)


def phantom_w(x):
    """``x = [w1_y, w1_x, t1_z, t3 3, w3_z, w3_y, w3_x, m_x, m_y]`` ->
    ``W [..., 1, 31]``."""
    cy1, sy1 = torch.cos(x[..., 0]), torch.sin(x[..., 0])
    nrm = torch.stack([-sy1, cy1 * torch.sin(x[..., 1]), cy1 * torch.cos(x[..., 1])], dim=-1)
    a = _scaled_columns(x, x[..., 3:6], (6, 7, 8), 9)
    na = (nrm[..., :, None, None] * a[..., None, :, :]).reshape(*x.shape[:-1], 27)
    return torch.cat([na, nrm, x[..., 2:3]], dim=-1)[..., None, :]


def pointer_features(data):
    """``h [..., n, 6]`` = ``[u, v, 1, R2^T (p - t2)]`` (constant column 2)."""
    frames, q, p = data
    y = torch.einsum("...nji,...nj->...ni", frames.r, p - frames.t)
    return torch.cat([q, torch.ones_like(q[..., :1]), y], dim=-1)


def crosswire_features(data):
    """``h [..., n, 15]`` = ``[u, v, 1, R2^T t2, vec(R2)]`` (constant column 2)."""
    frames, q = data
    y = torch.einsum("...nji,...nj->...ni", frames.r, frames.t)
    return torch.cat([q, torch.ones_like(q[..., :1]), y, frames.r.flatten(-2)], dim=-1)


def phantom_features(data):
    """``h [..., n, 31]`` = ``[R2[a, b] z_c (27, (3a + b) 3 + c), t2, 1]`` with
    ``z = (u, v, 1)`` (constant column 30)."""
    frames, q = data
    ones = torch.ones_like(q[..., :1])
    z = torch.cat([q, ones], dim=-1)
    rz = (frames.r[..., :, :, None] * z[..., None, None, :]).flatten(-3)
    return torch.cat([rz, frames.t, ones], dim=-1)


def pointer_stats(data, mask=None):
    """``H [..., 6, 6]`` for the pointer objective."""
    h = pointer_features(data)
    return _gram(h, _weights(h, mask))


def crosswire_stats(data, mask=None):
    """``H [..., 15, 15]`` for the crosswire objective."""
    h = crosswire_features(data)
    return _gram(h, _weights(h, mask))


def phantom_stats(data, mask=None):
    """``H [..., 31, 31]`` for the plane-phantom objective."""
    h = phantom_features(data)
    return _gram(h, _weights(h, mask))


# kind: (W, stats, features, index of the constant feature)
_OBJECTIVES = {
    "pointer": (pointer_w, pointer_stats, pointer_features, 2),
    "crosswire": (crosswire_w, crosswire_stats, crosswire_features, 2),
    "plane_phantom": (phantom_w, phantom_stats, phantom_features, 30),
}


def shift_constant(w, m, const_idx):
    """``W S`` with ``S = I + m e_c^T``: column ``c`` of ``W [..., R, F]``
    gains ``W m`` (``m [..., F]`` with ``m[c] = 0``)."""
    col = w[..., const_idx : const_idx + 1] + w @ m[..., :, None]
    return torch.cat([w[..., :const_idx], col, w[..., const_idx + 1 :]], dim=-1)


def _zero_at(m, const_idx):
    m = m.clone()
    m[..., const_idx] = 0.0
    return m


def _centered_problem(w_fn, h, wts, const_idx, reduce=lambda t: t):
    """Exact feature centering against the constant column.

    The raw Gram mixes features of scale 1e2-1e3, so ``0.5 tr(W H W^T)``
    cancels 6-8 digits against a noise-scale cost.  ``h'_j = h_j - m_j
    h_const`` with ``W' = W S`` (``S = I + m e_const^T``) is an exact change
    of basis (``W' h' == W h``) that shrinks the Gram to the data's
    variance; it is a convergence fix, not a device workaround.

    ``m`` is the weighted feature sum over its constant entry (the weight
    total, the constant feature being 1).  ``reduce`` sums a tensor over the
    processes holding the other observations: it is applied to the ``[F]``
    feature sum and to the centered ``[F, F]`` Gram."""
    s = reduce(wts @ h)
    m = _zero_at(s / torch.clamp_min(s[const_idx], 1.0), const_idx)
    hc = h - m[None, :] * h[:, const_idx : const_idx + 1]

    def w_fn_c(x):
        return shift_constant(w_fn(x), m, const_idx)

    return w_fn_c, reduce(_gram(hc, wts))


def centered_stats(kind, data, mask=None, reduce=lambda t: t):
    """``(W', H')``: the centered coefficient map and Gram of ``kind``'s
    objective on ``data`` (:func:`_centered_problem`), ``mask [n]``
    optional.  With ``reduce``, a sum over the processes holding the rest of
    the observations, ``data`` is one block of them and the result is the
    problem of the whole."""
    w_fn, _, feats_fn, const_idx = _OBJECTIVES[kind]
    h = feats_fn(data)
    return _centered_problem(w_fn, h, _weights(h, mask), const_idx, reduce)


def centered_from_gram(w_fn, g_raw, const_idx):
    """The centered problem from a RAW Gram ``G = sum w h h^T``.

    The centering mean comes from G itself (``m_j = G[j, c] / G[c, c]``, the
    constant feature being 1), and the centered Gram is the congruence
    ``(I - m e_c^T) G (I - m e_c^T)^T``: the same problem as
    :func:`_centered_problem` with one reduction of the raw Gram, at the
    price of an ``eps * (raw scale)`` perturbation when it is built.
    ``parallel.sharded.sharded_us_feature_lm`` reduces twice instead (the
    feature sum, then the centered Gram)."""
    f_n = g_raw.shape[-1]
    m = g_raw[:, const_idx] / torch.clamp_min(g_raw[const_idx, const_idx], 1.0)
    m = _zero_at(m, const_idx)
    e_c = torch.zeros(f_n, dtype=g_raw.dtype, device=g_raw.device)
    e_c[const_idx] = 1.0
    s = torch.eye(f_n, dtype=g_raw.dtype, device=g_raw.device) - torch.outer(m, e_c)

    def w_fn_c(x):
        return shift_constant(w_fn(x), m, const_idx)

    return w_fn_c, s @ g_raw @ s.T


def us_feature_lm(
    kind: str,
    data,
    x0: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    config: LMConfig = LMConfig(),
) -> LMResult:
    """One ultrasound-calibration LM refit from centered sufficient statistics."""
    w_fn_c, gram = centered_stats(kind, data, mask)
    return feature_lm(w_fn_c, gram, x0, config)


def us_feature_lm_batched(
    kind: str,
    data,
    x0: torch.Tensor,
    masks: Optional[torch.Tensor] = None,
    config: LMConfig = LMConfig(),
) -> LMResult:
    """B independent refits on SHARED data with per-problem masks and starts.

    ``x0 [B, P]``, ``masks [B, n]`` (None: every observation in every
    problem).  The per-problem centered Grams come from one ``einsum`` over
    the shared features; the B solves run in lockstep with no per-iteration
    work in n.
    """
    if masks is None:
        w_fn_c, gram = centered_stats(kind, data)
        return feature_lm_planar(w_fn_c, gram.expand(x0.shape[0], *gram.shape), x0, config)
    w_fn, _, feats_fn, const_idx = _OBJECTIVES[kind]
    h = feats_fn(data)

    # Per-problem exact centering in two stages.  Stage 1 centers the
    # features on the global mean m_g (no raw-scale cancellation when the
    # Grams are built); stage 2 recovers each problem's own mean m_b from
    # its stage-1 Gram (m_b = G[:, c] / G[c, c]) and applies the rank-1
    # congruence (I - m_b e_c^T) G (I - m_b e_c^T)^T on entries of the
    # masks' offset scale.  Since m_b[c] == 0 the two compose exactly to
    # I - (m_g + m_b) e_c^T, so problem b's coefficient map is W S with
    # m = m_g + m_b.
    m_g = _zero_at(torch.sum(h, dim=0) / max(h.shape[0], 1), const_idx)
    hc = h - m_g[None, :] * h[:, const_idx : const_idx + 1]
    g1 = torch.einsum("ni,nj,bn->bij", hc, hc, masks.to(h.dtype))
    gc = g1[:, :, const_idx]                                  # [B, F]
    gcc = g1[:, const_idx, const_idx]                         # [B]
    m_b = _zero_at(gc / torch.clamp_min(gcc, 1.0)[:, None], const_idx)
    grams = (g1 - m_b[:, :, None] * gc[:, None, :] - gc[:, :, None] * m_b[:, None, :]
             + gcc[:, None, None] * m_b[:, :, None] * m_b[:, None, :])

    def w_fn_m(x, m):
        return shift_constant(w_fn(x), m, const_idx)

    return feature_lm_planar(w_fn_m, grams, x0, config, w_args=(m_g[None, :] + m_b,))
