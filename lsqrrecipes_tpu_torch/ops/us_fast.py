"""Batched hypothesize and vote for the crosswire and calibrated-pointer
ultrasound calibrations (counterpart of the crosswire/pointer half of
``lsqrrecipes_tpu/ops/us_fast.py``; the plane phantom is not ported yet).

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

Counts can differ from the f64 vote by border points, as the fused sweeps'
do.  No kernel runs here: the JAX package has none on this path either.
"""

import numpy as np
import torch

from lsqrrecipes_tpu_torch.config import HALF_PI, SMALL_ANGLE
from lsqrrecipes_tpu_torch.device import as_tensor, full_f32_matmul, generator_device
from lsqrrecipes_tpu_torch.linalg.small import qr_solve_lanes, rsqrt, scalar_like
from lsqrrecipes_tpu_torch.ransac.sampling import structured_shift_table
from lsqrrecipes_tpu_torch.tree import tree_leaves, tree_map

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


def _samples_to_slot_features(kind, samples):
    """Engine samples (a tree with leading ``[B, k]``) -> ``[B, k, F]``."""
    flat = tree_map(lambda a: a.reshape(-1, *a.shape[2:]), samples)
    f = _KINDS[kind][4](flat)
    leading = tree_leaves(samples)[0].shape[:2]
    return f.reshape(*leading, f.shape[-1])


# kind: (fit, k, vote rows, vote features, slot features, n params)
_KINDS = {
    "crosswire": (_crosswire_fit_slots, 4, _vote_rows_crosswire,
                  _features_crosswire, _slot_features_crosswire, 20),
    "pointer": (_pointer_fit_slots, 3, _vote_rows_pointer,
                _features_pointer, _slot_features_pointer, 17),
}


def _fit_vote_chunk(kind, delta_sq, slot_pl, feats):
    """Fit and vote planes ``slot_pl[k, F, B]`` -> ``(counts [B] with -1
    where the fit is degenerate, params [B, P])``."""
    fit, k, vote_rows, _, _, _ = _KINDS[kind]
    params, valid = fit(slot_pl, k)
    d2 = None
    with full_f32_matmul():
        for a_j in vote_rows(params.to(feats.dtype)):
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


def _fit_and_vote_planes(kind, delta_sq, chunk, planes, feats):
    """Fit and vote ``planes[k, F, B]`` chunk by chunk along B."""
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
    _, k, _, features, slot_features, _ = _KINDS[kind]
    feats_elem = slot_features(data)          # [n, F]
    n = feats_elem.shape[0]
    dev = feats_elem.device
    if perm is None:
        perm = torch.randperm(n, generator=generator, device=generator_device(generator, dev))
    perm = as_tensor(perm, dev, torch.int64)
    table = torch.as_tensor(np.asarray(structured_shift_table(n, k, groups)) % n, device=dev)
    rows = torch.arange(n, device=dev)
    idx = perm[(rows[None, :, None] + table[:, None, :]) % n]      # [G, n, k]
    planes = feats_elem[idx.reshape(groups * n, k)].permute(1, 2, 0)
    return planes.contiguous(), features(data)


def structured_sweep(kind, est, data, generator, groups: int, perm=None):
    """Structured hypothesize and vote on planar lanes (the sample tree is
    never materialised) -> ``(counts int64[B], params f32[B, P])``, counts
    -1 where the fit is degenerate."""
    planes, feats = build_sampling_planes(kind, data, generator, groups, perm)
    chunk = _chunk_size(planes.shape[-1], feats.shape[0], _KINDS[kind][1])
    return _fit_and_vote_planes(kind, float(est.delta_squared), chunk, planes, feats)


def fit_and_vote(kind, est, samples, data):
    """Batched hypothesize and vote on materialised samples (the engine's
    ``fit_and_vote`` hook): ``samples`` is the estimator's data tree with
    leading ``[B, k]`` -> ``(counts int64[B], params f32[B, P])``."""
    planes = _samples_to_slot_features(kind, samples).permute(1, 2, 0)
    feats = _KINDS[kind][3](data)
    chunk = _chunk_size(planes.shape[-1], feats.shape[0], _KINDS[kind][1])
    return _fit_and_vote_planes(kind, float(est.delta_squared), chunk, planes, feats)
