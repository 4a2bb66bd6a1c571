"""Batched hypothesize and vote for the ultrasound calibrations: crosswire,
calibrated pointer and plane phantom (counterpart of
``lsqrrecipes_tpu/ops/us_fast.py``).

The engine's generic path fits each hypothesis with the estimator's f64 SVD
pseudo-inverse (a 12x12 SVD per crosswire sample,
``SinglePointTargetUSCalibrationParametersEstimator.cxx:120-270``).  Here
the whole hypothesize and vote is batched f32 arithmetic with the batch on
the last axis (lanes form, lists of ``[B]`` tensors):

  * the minimal system by the equilibrated Householder QR
    (:func:`lsqrrecipes_tpu_torch.linalg.small.qr_solve_lanes`), whose pivot
    gate is the f32 analogue of the reference's FLT_EPSILON rank test;
  * the closest rotation (the reference's SVD ``U V^T``, ``cxx:220-229``)
    by five Newton polar steps ``X <- (X + X^-T) / 2`` with adjugate
    inverses: the raw frame ``[c1/|c1|, c2/|c2|, r1 x r2]`` has ``det >= 0``,
    so its polar factor is the rotation the SVD gives;
  * the gimbal-safe '+sqrt' Euler-ZYX extraction (``cxx:230-247``);
  * a compact vote using R2's orthogonality, ``|R2 img + t2 - t1|^2 =
    |img + R2^T t2 - R2^T t1|^2``: each residual component is affine in 15
    per-observation features ``[u, v, 1, R2^T t2 3, vec(R2) 9]`` (pointer: 6,
    ``[u, v, 1, w 3]`` with ``w = R2^T (p - t2)``), three ``torch.matmul``
    products in full f32.

The plane phantom (k = 31) fits the null vector of its homogeneous 31x31
system in two stages: the f32 subspace of :mod:`lsqrrecipes_tpu_torch.ops.
phantom_qr` (the kernel B6 on the card) and a float64 Rayleigh-Ritz on it,
then the reference's reconstruction (together one kernel on the card,
``csrc/phantom_ritz.cu``); its vote is one ``[B, 31] @ [31, n]`` product.

Counts can differ from the f64 vote by border points, as the fused sweeps'
do.  The crosswire and pointer fits run no kernel (the JAX package has none
on their path either).
"""

import ctypes
import functools
import operator
from typing import Callable, NamedTuple

import numpy as np
import torch

from lsqrrecipes_tpu_torch import kernels
from lsqrrecipes_tpu_torch.config import HALF_PI, SMALL_ANGLE
from lsqrrecipes_tpu_torch.device import as_tensor, full_f32_matmul, generator_device
from lsqrrecipes_tpu_torch.linalg.small import (
    cholesky_solve_lanes,
    qr_solve_lanes,
    rsqrt,
    scalar_like,
)
from lsqrrecipes_tpu_torch.ops import phantom_qr
from lsqrrecipes_tpu_torch.ransac.sampling import structured_shift_table
from lsqrrecipes_tpu_torch.tree import tree_leaves, tree_map
from lsqrrecipes_tpu_torch.utils import profiling

# ---------------------------------------------------------------------------
# Lanes-form 3x3 helpers (nested lists of [B] tensors)
# ---------------------------------------------------------------------------


def _cof3_lanes(x):
    """Cofactor matrix of a lanes-form 3x3 (cyclic-index expansion)."""
    c = [[None] * 3 for _ in range(3)]
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            c[i][j] = x[i1][j1] * x[i2][j2] - x[i1][j2] * x[i2][j1]
    return c


def polar3_lanes(m, iters: int = 5):
    """Closest rotation to a lanes-form 3x3 with ``det > 0`` by Newton polar
    iteration ``X <- (X + X^-T) / 2`` -> ``(R, ok)``; ``ok`` is False where a
    step's ``|det| <= 1e-9``.  Each product, sum and the division ``1 / det``
    is its own correctly rounded operation (the CUDA kernels' arithmetic)."""
    x = m
    ok = None
    one = scalar_like(1.0, m[0][0])
    for _ in range(iters):
        c = _cof3_lanes(x)
        det = x[0][0] * c[0][0] + x[0][1] * c[0][1] + x[0][2] * c[0][2]
        good = det.abs() > 1e-9
        ok = good if ok is None else ok & good
        inv = one / torch.where(good, det, one)
        x = [[0.5 * (x[i][j] + c[i][j] * inv) for j in range(3)] for i in range(3)]
    return x, ok


def euler_zyx_plus_lanes(r):
    """Lanes-form '+sqrt' Euler-ZYX extraction with the gimbal branch
    (``SinglePointTarget...cxx:230-247``) -> ``(wz, wy, wx)``."""
    wy = torch.atan2(-r[2][0], torch.sqrt(r[0][0] ** 2 + r[1][0] ** 2))
    gimbal = ~(((wy - HALF_PI).abs() > SMALL_ANGLE) & ((wy + HALF_PI).abs() > SMALL_ANGLE))
    cy = torch.where(gimbal, torch.ones_like(wy), torch.cos(wy))
    wz = torch.where(gimbal, torch.zeros_like(wy), torch.atan2(r[1][0] / cy, r[0][0] / cy))
    wx = torch.where(gimbal, torch.atan2(r[0][1], r[1][1]),
                     torch.atan2(r[2][1] / cy, r[2][2] / cy))
    return wz, wy, wx


def orthonormalize_lanes(c1, c2):
    """Scales and closest rotation from the raw scaled columns (length-3
    lists of ``[B]``) -> ``(m_x, m_y, r3, ok)``: ``n = |c|^2`` gated at
    ``1e-20``, ``1 / sqrt(max(n, 1e-30))`` in two rounded steps, the cross
    product, :func:`polar3_lanes`, ``m = n / sqrt(n)``."""
    n1 = c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2]
    n2 = c2[0] * c2[0] + c2[1] * c2[1] + c2[2] * c2[2]
    ok = (n1 > 1e-20) & (n2 > 1e-20)
    i1 = rsqrt(torch.clamp_min(n1, 1e-30))
    i2 = rsqrt(torch.clamp_min(n2, 1e-30))
    r1 = [c1[i] * i1 for i in range(3)]
    r2 = [c2[i] * i2 for i in range(3)]
    r3col = [
        r1[1] * r2[2] - r1[2] * r2[1],
        r1[2] * r2[0] - r1[0] * r2[2],
        r1[0] * r2[1] - r1[1] * r2[0],
    ]
    rot, pok = polar3_lanes([[r1[i], r2[i], r3col[i]] for i in range(3)])
    return n1 * i1, n2 * i2, rot, ok & pok


# ---------------------------------------------------------------------------
# Minimal fits.  Slot features per sampled observation:
#   crosswire: [vec(R2) 9, t2 3, u, v]           (F = 14)
#   pointer:   [vec(R2) 9, t2 3, u, v, p 3]      (F = 17)
# The systems below are shared with the fused sweeps' plain versions.
# ---------------------------------------------------------------------------


def crosswire_system(slot, k: int):
    """Rows and right-hand side of the minimal ``3k x 12`` system
    ``[u R2 | v R2 | R2 | -I] x = -t2`` (``SinglePointTarget...cxx:120-270``)
    from ``slot(a, f)``, the ``[B]`` lane of feature f of sample slot a."""
    zero = torch.zeros_like(slot(0, 12))
    one = zero + 1.0
    rows, rhs = [], []
    for a in range(k):
        u, v = slot(a, 12), slot(a, 13)
        for j in range(3):
            row = [None] * 12
            for c in range(3):
                r_jc = slot(a, 3 * j + c)
                row[c] = u * r_jc
                row[3 + c] = v * r_jc
                row[6 + c] = r_jc
                row[9 + c] = -one if j == c else zero
            rows.append(row)
            rhs.append(-slot(a, 9 + j))
    return rows, rhs


def pointer_system(slot, k: int):
    """Rows and right-hand side of the minimal ``3k x 9`` system
    ``[u R2 | v R2 | R2] x = p - t2`` (``SinglePointTarget...cxx:763-914``)."""
    rows, rhs = [], []
    for a in range(k):
        u, v = slot(a, 12), slot(a, 13)
        for j in range(3):
            row = [None] * 9
            for c in range(3):
                r_jc = slot(a, 3 * j + c)
                row[c] = u * r_jc
                row[3 + c] = v * r_jc
                row[6 + c] = r_jc
            rows.append(row)
            rhs.append(slot(a, 14 + j) - slot(a, 9 + j))
    return rows, rhs


def _params_columns(x_t, m_x, m_y, r3, angles):
    """``[x_t..., wz, wy, wx, m_x, m_y, m_x R3(:,1), m_y R3(:,2), R3(:,3)]``."""
    return (list(x_t) + list(angles) + [m_x, m_y]
            + [m_x * r3[i][0] for i in range(3)]
            + [m_y * r3[i][1] for i in range(3)]
            + [r3[i][2] for i in range(3)])


def _crosswire_fit_slots(slot_pl, k: int):
    """Minimal crosswire fits of planes ``slot_pl[k, 14, B]`` ->
    ``(params [B, 20], valid [B])``."""
    rows, rhs = crosswire_system(lambda a, f: slot_pl[a, f], k)
    x, valid = qr_solve_lanes(rows, rhs)
    m_x, m_y, r3, ok = orthonormalize_lanes(x[0:3], x[3:6])
    cols = _params_columns(x[9:12] + x[6:9], m_x, m_y, r3, euler_zyx_plus_lanes(r3))
    return torch.stack(cols, dim=-1), valid & ok


def _pointer_fit_slots(slot_pl, k: int):
    """Minimal pointer fits of planes ``slot_pl[k, 17, B]`` ->
    ``(params [B, 17], valid [B])``."""
    rows, rhs = pointer_system(lambda a, f: slot_pl[a, f], k)
    x, valid = qr_solve_lanes(rows, rhs)
    m_x, m_y, r3, ok = orthonormalize_lanes(x[0:3], x[3:6])
    cols = _params_columns(x[6:9], m_x, m_y, r3, euler_zyx_plus_lanes(r3))
    return torch.stack(cols, dim=-1), valid & ok


# ---------------------------------------------------------------------------
# Plane phantom (k = 31): the null vector of the homogeneous 31x31 system
# (``PlanePhantomUSCalibrationParametersEstimator.cxx:137-355``) in two
# stages.  The f32 stage (B6, ops/phantom_qr.py) factors A itself and runs
# two steps of block inverse iteration: at the reference noise sigma_31 ~
# 2e-7 sigma_0 and sigma_30 ~ 1e-5 sigma_0, and the f32 backward error sits
# between them, so four vectors capture the null direction without resolving
# the pair.  The float64 Rayleigh-Ritz projects ``A^T A`` onto that span and
# resolves it.  The JAX package projects in double-single f32 pairs to avoid
# the TPU's emulated f64; the H100 has native f64, so here W = A V and
# S = W^T W are plain float64 (the JAX package's other branch).
#
# The Rayleigh-Ritz, the rank gate and the reconstruction run as one kernel
# per chunk on the card (``csrc/phantom_ritz.cu``, one thread a hypothesis)
# and as :func:`phantom_ritz_plain` on the CPU.  The plain version is the
# kernel's specification: every sum runs in the kernel's order
# (:func:`_sum_in_order`, or Python's ``sum`` from 0 where the kernel adds to
# 0 too), and every product, sum, division and square root is its own
# correctly rounded operation, so on the card the two agree bit for bit.
# ---------------------------------------------------------------------------

# The reference's FLT_EPSILON-relative rank gate (``cxx:205-218``): sigma_30
# must exceed FLT_EPS max(sigma_0, 1).
_PHANTOM_FLT_EPS = 1.192092896e-07
# sigma_0's power iteration starts from the uniform unit vector, in f32.
_PHANTOM_P0 = float(np.float32(1.0 / np.sqrt(31.0)))


def phantom_systems(slot_pl):
    """The homogeneous 31x31 systems of planes ``slot_pl[31, 14, B]``: row a
    is ``[u vec(R2), v vec(R2), vec(R2), t2, 1]`` of slot a
    (``PlanePhantom...cxx:137-203``), ``[31 rows, 31 columns, B]`` in the
    planes' dtype, without column equilibration (the reference's SVD runs on
    the raw system)."""
    r_feat = slot_pl[:, 0:9]
    u_feat, v_feat = slot_pl[:, 12:13], slot_pl[:, 13:14]
    return torch.cat([u_feat * r_feat, v_feat * r_feat, r_feat, slot_pl[:, 9:12],
                      torch.ones_like(u_feat)], dim=1)


def _plane_phantom_fit_slots(slot_pl, k: int):
    """k = 31 minimal fits of planes ``slot_pl[31, 14, B]`` (the engine's
    dtype) -> ``(params [B, 41], valid [B])``.  The f32 rounding of
    :func:`phantom_systems`, packed by :func:`~lsqrrecipes_tpu_torch.ops.
    phantom_qr.pack_systems`, goes to :func:`~lsqrrecipes_tpu_torch.ops.
    phantom_qr.phantom_subspace`, then the systems and the subspace to
    :func:`phantom_ritz`."""
    a_pl = phantom_systems(slot_pl)                               # [31, 31, B]
    v_pl = phantom_qr.phantom_subspace(phantom_qr.pack_systems(a_pl))
    return phantom_ritz(a_pl, v_pl)


def _sum_in_order(terms):
    """``((t0 + t1) + t2) + ...``, each addition rounded: the kernel's order."""
    return functools.reduce(operator.add, terms)


def _unit_lanes(c, tiny):
    nrm = torch.sqrt(sum(ci * ci for ci in c))
    inv = 1.0 / torch.clamp_min(nrm, tiny)
    return [ci * inv for ci in c]


def _phantom_sigma0_sq(a32):
    """sigma_0^2 of each f32 system ``a32[31 rows, 31 columns, B]`` by two
    power-iteration steps on ``A^T A`` from the uniform vector and a Rayleigh
    quotient, in f32 -> ``[B]``: never above sigma_0^2, and on the phantom's
    systems within a factor of about 2 below it.  ``A p`` sums over the
    columns, ``A^T (A p)`` over the rows, each in index order."""
    def gram_apply(p):                                              # p [31, B]
        ap = _sum_in_order(p[c] * a32[:, c] for c in range(31))       # A p
        return _sum_in_order(a32[r] * ap[r] for r in range(31))       # A^T A p

    def norm_rows(p):
        return p * rsqrt(torch.clamp_min(_sum_in_order(pc * pc for pc in p), 1e-30))

    pv = torch.full_like(a32[0], _PHANTOM_P0)
    for _ in range(2):
        pv = norm_rows(gram_apply(pv))
    return _sum_in_order(pv * gram_apply(pv))


def _check_ritz_inputs(a_pl, v_pl):
    if a_pl.ndim != 3 or a_pl.shape[:2] != (31, 31):
        raise ValueError(f"a_pl must be [31, 31, B], got {tuple(a_pl.shape)}")
    if a_pl.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"a_pl must be float32 or float64, got {a_pl.dtype}")
    if tuple(v_pl.shape) != (phantom_qr.Q, 31, a_pl.shape[2]):
        raise ValueError(f"v_pl must be [4, 31, {a_pl.shape[2]}], got {tuple(v_pl.shape)}")
    if v_pl.dtype != torch.float32:
        raise ValueError(f"v_pl must be float32, got {v_pl.dtype}")
    if v_pl.device != a_pl.device:
        raise ValueError("a_pl and v_pl must be on one device")


def phantom_ritz_plain(a_pl, v_pl):
    """The k = 31 fit's tail in plain PyTorch: the Rayleigh-Ritz null vector
    in ``a_pl``'s dtype, the rank gate, and the reference's reconstruction
    (``PlanePhantom...cxx:204-355``) in lanes form.  ``a_pl [31, 31, B]``
    float32 or float64, ``v_pl [4, 31, B]`` f32 from B6 -> ``(params [B, 41]
    in a_pl's dtype, valid [B])``; ``valid`` needs every subspace entry
    finite."""
    _check_ritz_inputs(a_pl, v_pl)
    dt = a_pl.dtype
    q = phantom_qr.Q
    fac_ok = torch.isfinite(v_pl).all(dim=1).all(dim=0)
    v64 = v_pl.to(dt)
    w = _sum_in_order(a_pl[:, c] * v64[:, c, None] for c in range(31))   # W = A V, [q, 31, B]
    s = _sum_in_order(w[:, None, r] * w[None, :, r] for r in range(31))  # S = W^T W
    sg = [[s[i, j] for j in range(q)] for i in range(q)]
    tiny = torch.finfo(dt).tiny
    trace = sg[0][0] + sg[1][1] + sg[2][2] + sg[3][3]
    shift = 100.0 * torch.finfo(dt).eps * trace + tiny
    s_ll = [[sg[i][j] + shift if i == j else sg[i][j] for j in range(q)] for i in range(q)]
    zeros_b, ones_b = torch.zeros_like(trace), torch.ones_like(trace)

    # Smallest Ritz vector: the first subspace vector is the f32 null
    # estimate, so e_0 overlaps it; two shifted inverse-iteration steps
    # polish it to the working precision.
    c = [ones_b] + [zeros_b] * (q - 1)
    for _ in range(2):
        c, _ = cholesky_solve_lanes(s_ll, c, q)
        c = _unit_lanes(c, tiny)
    x_pl = sum(c[j][None, :] * v64[j] for j in range(q))            # [31, B]
    xn = 1.0 / torch.clamp_min(torch.sqrt(_sum_in_order(xi * xi for xi in x_pl)), tiny)
    xq = [x_pl[i] * xn for i in range(31)]

    # Rank gate s[29] > FLT_EPS max(s[0], 1): sigma_30^2 by the deflated
    # second Ritz value (an over-estimate, so never laxer than the
    # reference), sigma_0^2 by power iteration in f32.
    def deflate(y):
        dot = sum(ci * yi for ci, yi in zip(c, y))
        return _unit_lanes([yi - dot * ci for ci, yi in zip(c, y)], tiny)

    y = deflate([zeros_b, ones_b] + [zeros_b] * (q - 2))
    for _ in range(2):
        y, _ = cholesky_solve_lanes(s_ll, y, q)
        y = deflate(y)
    sy = [sum(sg[i][j] * y[j] for j in range(q)) for i in range(q)]
    lam1 = sum(y[i] * sy[i] for i in range(q))
    sig0_sq = _phantom_sigma0_sq(a_pl.to(torch.float32)).to(dt)
    rank_ok = lam1 > _PHANTOM_FLT_EPS**2 * torch.clamp_min(sig0_sq, 1.0)

    # Reconstruction on the 31 lanes of the null vector.
    denom = torch.sqrt(xq[27] ** 2 + xq[28] ** 2 + xq[29] ** 2)
    nondeg = denom > 1e-30
    invd = 1.0 / torch.where(nondeg, denom, ones_b)
    xr = [xi * invd for xi in xq]
    r1 = [xr[27], xr[28], xr[29]]                       # R1 row 3 (the plane normal)
    t1_z = xr[30]
    wy1 = torch.atan2(-r1[0], torch.sqrt(r1[1] ** 2 + r1[2] ** 2))
    gimbal = ~(((wy1 - HALF_PI).abs() > SMALL_ANGLE) & ((wy1 + HALF_PI).abs() > SMALL_ANGLE))
    cy1 = torch.where(gimbal, ones_b, torch.cos(wy1))
    wx1 = torch.where(gimbal, zeros_b, torch.atan2(r1[1] / cy1, r1[2] / cy1))

    inv = [1.0 / torch.where(r1[j].abs() > 1e-30, r1[j], ones_b) for j in range(3)]
    three = scalar_like(3.0, trace)      # a true division on the card too
    c1, c2, t3 = ([sum(xr[base + 3 * j + cc] * inv[j] for j in range(3)) / three
                   for cc in range(3)] for base in (0, 9, 18))
    m_x, m_y, r3, ok = orthonormalize_lanes(c1, c2)
    wz3, wy3, wx3 = euler_zyx_plus_lanes(r3)
    m1 = [m_x * r1[j] * r3[cc][0] for j in range(3) for cc in range(3)]
    m2 = [m_y * r1[j] * r3[cc][1] for j in range(3) for cc in range(3)]
    m3 = [r1[j] * t3[cc] for j in range(3) for cc in range(3)]
    cols = [wy1, wx1, t1_z, *t3, wz3, wy3, wx3, m_x, m_y, *m1, *m2, *m3, *r1]
    valid = fac_ok & rank_ok & nondeg & ok
    return torch.stack(cols, dim=-1), valid


def phantom_ritz_cuda(a_pl, v_pl):
    """Launch ``csrc/phantom_ritz.cu`` on the current stream; same contract as
    :func:`phantom_ritz_plain`.  ``a_pl`` must be contiguous and ``v_pl`` the
    ``[4, 31, B]`` view of B6's ``[B, 4, 32]`` output, which the kernel reads
    in place.  The constants go in as arguments, so no tensor is made from a
    Python number.  Raises on other input and when the build or the launch
    fails."""
    _check_ritz_inputs(a_pl, v_pl)
    if v_pl.permute(2, 0, 1).stride() != (phantom_qr.Q * phantom_qr.ROWS, phantom_qr.ROWS, 1):
        raise ValueError("v_pl must be the [4, 31, B] view of B6's [B, 4, 32] output")
    kernels.check_inputs(dtypes=(torch.float32, torch.float64), a_pl=a_pl)
    b = a_pl.shape[2]
    if b >= 2**31:
        raise ValueError("phantom_ritz supports fewer than 2^31 hypotheses")
    dt = a_pl.dtype
    params = torch.empty((b, 41), dtype=dt, device=a_pl.device)
    valid = torch.empty((b,), dtype=torch.bool, device=a_pl.device)
    if b:
        finfo = torch.finfo(dt)
        with torch.cuda.device(a_pl.device):
            stream = torch.cuda.current_stream().cuda_stream
            kernels.PHANTOM_RITZ.launch(
                a_pl.data_ptr(), v_pl.data_ptr(), ctypes.c_int(b),
                ctypes.c_int(dt == torch.float64), ctypes.c_double(100.0 * finfo.eps),
                ctypes.c_double(finfo.tiny), ctypes.c_double(_PHANTOM_FLT_EPS**2),
                ctypes.c_double(HALF_PI), ctypes.c_double(SMALL_ANGLE),
                ctypes.c_float(_PHANTOM_P0), params.data_ptr(), valid.data_ptr(), stream)
    return params, valid


def phantom_ritz(a_pl, v_pl):
    """The plane phantom's fit after B6: ``a_pl [31, 31, B]`` and B6's
    subspace ``v_pl [4, 31, B]`` -> ``(params [B, 41], valid [B])``.  CUDA
    tensors launch the kernel, CPU tensors run :func:`phantom_ritz_plain`."""
    fn = phantom_ritz_cuda if a_pl.is_cuda else phantom_ritz_plain
    return fn(a_pl, v_pl)


# ---------------------------------------------------------------------------
# Compact votes (R2-orthogonality form) and slot features, all f32
# ---------------------------------------------------------------------------


def _to_f32(x):
    return x.to(torch.float32)


def _features_crosswire(data):
    """``[n, 15]`` = ``[u, v, 1, R2^T t2 3, vec(R2) 9]``."""
    frames, q = data
    r2, q32 = _to_f32(frames.r), _to_f32(q)
    rt2 = torch.einsum("nij,ni->nj", r2, _to_f32(frames.t))
    ones = torch.ones((q32.shape[0], 1), dtype=torch.float32, device=q32.device)
    return torch.cat([q32, ones, rt2, r2.reshape(-1, 9)], dim=-1)


def _vote_rows_crosswire(params):
    """``a_j [B, 15]``: ``e_j = u c1_j + v c2_j + t3_j + (R2^T t2)_j -
    (R2 col j) . t1``; vec(R2) is row-major, so column j sits at 3k + j."""
    b, dt, dev = params.shape[0], params.dtype, params.device
    t1 = params[:, 0:3]
    rows = []
    for j in range(3):
        rblock = torch.zeros((b, 3, 3), dtype=dt, device=dev)
        rblock[:, :, j] = -t1
        unit = torch.zeros((b, 3), dtype=dt, device=dev)
        unit[:, j] = 1.0
        rows.append(torch.cat([params[:, 11 + j : 12 + j], params[:, 14 + j : 15 + j],
                               params[:, 3 + j : 4 + j], unit, rblock.reshape(b, 9)], dim=-1))
    return rows


def _features_pointer(data):
    """``[n, 6]`` = ``[u, v, 1, R2^T (p - t2) 3]``."""
    frames, q, p = data
    r2, q32 = _to_f32(frames.r), _to_f32(q)
    w = torch.einsum("nij,ni->nj", r2, _to_f32(p) - _to_f32(frames.t))
    ones = torch.ones((q32.shape[0], 1), dtype=torch.float32, device=q32.device)
    return torch.cat([q32, ones, w], dim=-1)


def _vote_rows_pointer(params):
    """``a_j [B, 6]``: ``e_j = u c1_j + v c2_j + t3_j - w_j``."""
    b, dt, dev = params.shape[0], params.dtype, params.device
    rows = []
    for j in range(3):
        unit = torch.zeros((b, 3), dtype=dt, device=dev)
        unit[:, j] = -1.0
        rows.append(torch.cat([params[:, 8 + j : 9 + j], params[:, 11 + j : 12 + j],
                               params[:, j : j + 1], unit], dim=-1))
    return rows


def _slot_features_crosswire(data):
    """``[n, 14]`` = ``[vec(R2) 9, t2 3, u, v]`` (f32)."""
    frames, q = data
    return torch.cat([_to_f32(frames.r).reshape(-1, 9), _to_f32(frames.t), _to_f32(q)], dim=-1)


def _slot_features_pointer(data):
    """``[n, 17]`` = ``[vec(R2) 9, t2 3, u, v, p 3]`` (f32)."""
    frames, q, p = data
    return torch.cat([_to_f32(frames.r).reshape(-1, 9), _to_f32(frames.t), _to_f32(q),
                      _to_f32(p)], dim=-1)


def _features_phantom(data):
    """``[n, 31]`` = ``[u vec(R2) 9, v vec(R2) 9, vec(R2) 9, t2 3, 1]`` (f32)."""
    frames, q = data
    r2, q32 = _to_f32(frames.r).reshape(-1, 9), _to_f32(q)
    ones = torch.ones((q32.shape[0], 1), dtype=torch.float32, device=q32.device)
    return torch.cat([q32[:, 0:1] * r2, q32[:, 1:2] * r2, r2, _to_f32(frames.t), ones], dim=-1)


def _vote_rows_phantom(params):
    """The single residual ``a [B, 31] = [m1, m2, m3, r1_row3, t1_z]``
    (``PlanePhantom...cxx:73-117``)."""
    return [torch.cat([params[:, 11:41], params[:, 2:3]], dim=-1)]


def _slot_features_phantom(data):
    """The crosswire slot layout ``[vec(R2) 9, t2 3, u, v]`` in the data's
    own dtype: the k = 31 fit runs in the engine's f64."""
    frames, q = data
    return torch.cat([frames.r.reshape(-1, 9), frames.t, q], dim=-1)


def _samples_to_slot_features(kind, samples):
    """Engine samples (a tree with leading ``[B, k]``) -> ``[B, k, F]``."""
    flat = tree_map(lambda a: a.reshape(-1, *a.shape[2:]), samples)
    f = _KINDS[kind].slot_features(flat)
    leading = tree_leaves(samples)[0].shape[:2]
    return f.reshape(*leading, f.shape[-1])


class _Kind(NamedTuple):
    """One calibration's sweep, in the field order of the JAX package's
    ``_KINDS`` tuples."""

    fit: Callable            # (slot planes [k, F, B], k) -> (params [B, P], valid [B])
    k: int
    vote_rows: Callable      # params [B, P] -> the vote's affine rows, each [B, K]
    features: Callable       # data -> vote features [n, K]
    slot_features: Callable  # data -> slot features [n, F]
    nparams: int


_KINDS = {
    "crosswire": _Kind(_crosswire_fit_slots, 4, _vote_rows_crosswire,
                       _features_crosswire, _slot_features_crosswire, 20),
    "pointer": _Kind(_pointer_fit_slots, 3, _vote_rows_pointer,
                     _features_pointer, _slot_features_pointer, 17),
    "plane_phantom": _Kind(_plane_phantom_fit_slots, 31, _vote_rows_phantom,
                           _features_phantom, _slot_features_phantom, 41),
}


def _fit_vote_chunk(kind, delta_sq, slot_pl, feats):
    """Fit and vote planes ``slot_pl[k, F, B]`` -> ``(counts [B] with -1
    where the fit is degenerate, params [B, P])``; traced as the leaves
    ``sweep.fit`` and ``sweep.vote``."""
    spec = _KINDS[kind]
    with profiling.leaf("sweep.fit"):
        params, valid = spec.fit(slot_pl, spec.k)
    with profiling.leaf("sweep.vote"):
        d2 = None
        with full_f32_matmul():
            for a_j in spec.vote_rows(params.to(feats.dtype)):
                e = a_j @ feats.T
                d2 = e * e if d2 is None else d2 + e * e
        counts = torch.sum(d2 < delta_sq, dim=-1)
        return torch.where(valid, counts, torch.full_like(counts, -1)), params


def _chunk_size(bsz, n, k=4):
    """Hypotheses per chunk: about 4M ``[chunk, n]`` vote cells, a multiple
    of 128, at least 128, at most ``bsz``."""
    c = max(256, (1 << 22) // max(n, k * k))
    c = max(128, (c // 128) * 128)
    return min(bsz, c)


def fit_and_vote_planes(kind, delta_sq, planes, feats):
    """Fit and vote ``planes[k, F, B]`` against the vote features ``feats
    [n, K]`` chunk by chunk along B, the chunk from :func:`_chunk_size` ->
    ``(counts [B] with -1 where the fit is degenerate, params [B, P])``."""
    chunk = _chunk_size(planes.shape[-1], feats.shape[0], _KINDS[kind].k)
    counts, params = [], []
    for b0 in range(0, planes.shape[-1], chunk):
        c, p = _fit_vote_chunk(kind, delta_sq, planes[..., b0 : b0 + chunk], feats)
        counts.append(c)
        params.append(p)
    return torch.cat(counts), torch.cat(params)


def build_sampling_planes(kind, data, generator, groups: int, perm=None):
    """Planes ``[k, F, groups * n]`` of the structured hypothesis set and
    the vote features ``[n, K]``: lane ``g * n + i`` of slot j holds the
    slot features of observation ``perm[(i + s_gj) % n]``, with the shifts of
    :func:`~lsqrrecipes_tpu_torch.ransac.sampling.structured_shift_table`
    (the hypotheses of ``structured_samples`` with the same ``perm``)."""
    spec = _KINDS[kind]
    k = spec.k
    feats_elem = spec.slot_features(data)     # [n, F]
    n = feats_elem.shape[0]
    dev = feats_elem.device
    if perm is None:
        perm = torch.randperm(n, generator=generator, device=generator_device(generator, dev))
    perm = as_tensor(perm, dev, torch.int64)
    table = torch.as_tensor(np.asarray(structured_shift_table(n, k, groups)) % n, device=dev)
    rows = torch.arange(n, device=dev)
    idx = perm[(rows[None, :, None] + table[:, None, :]) % n]      # [G, n, k]
    planes = feats_elem[idx.reshape(groups * n, k)].permute(1, 2, 0)
    return planes.contiguous(), spec.features(data)


def structured_sweep(kind, est, data, generator, groups: int, perm=None):
    """Structured hypothesize and vote on planar lanes (the sample tree is
    never materialised) -> ``(counts int64[B], params f32[B, P])``, counts
    -1 where the fit is degenerate.  Traced as the layer span ``sweep``: the
    leaf ``sweep.prep`` (the permutation, the shift table, the slot planes
    and the vote features), then per chunk the leaves ``sweep.fit`` and
    ``sweep.vote``; the counter ``sweep.chunks`` counts the chunks (on the
    card, the plane phantom's B6 launches)."""
    with profiling.span("sweep"):
        with profiling.leaf("sweep.prep"):
            planes, feats = build_sampling_planes(kind, data, generator, groups, perm)
        b = planes.shape[-1]
        profiling.count("sweep.chunks", -(-b // _chunk_size(b, feats.shape[0], _KINDS[kind].k)))
        return fit_and_vote_planes(kind, float(est.delta_squared), planes, feats)


def fit_and_vote(kind, est, samples, data):
    """Batched hypothesize and vote on materialised samples (the engine's
    ``fit_and_vote`` hook): ``samples`` is the estimator's data tree with
    leading ``[B, k]`` -> ``(counts int64[B], params f32[B, P])``."""
    planes = _samples_to_slot_features(kind, samples).permute(1, 2, 0)
    return fit_and_vote_planes(kind, float(est.delta_squared), planes, _KINDS[kind].features(data))
