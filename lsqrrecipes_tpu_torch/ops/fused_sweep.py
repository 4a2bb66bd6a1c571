"""Whole-sweep fused RANSAC (counterpart of ``lsqrrecipes_tpu/ops/fused_sweep.py``)
for the point families ``sphere3d``, ``plane3d``, ``line3d``, ``line2d`` and
``dense_linear6``, the rigid-body families ``pivot``,
``absolute_orientation`` and ``ray3d``, and the ultrasound-calibration
families ``crosswire`` and ``pointer``.

One call evaluates ``groups * n_fit`` hypotheses and returns only the best
one.  Sampling is gather-free: each of the ``k`` sample slots draws from FOUR
independent permutations of the (replication-padded) per-observation feature
rows laid out as one ``[F, 5 n_fit]`` plane (perm0|perm1|perm2|perm3|perm0),
and group ``g`` takes for slot ``j`` the 128-aligned window at
``shift_units(g, j)`` of it, hashed from ``g`` (no shift table).  Each
family's minimal fit runs per lane; its vote counts the live columns of the
packed rows ``P`` (padding columns carry a 1e30 guard or a zero ones-row)
that fall in the family's band:

  * sphere3d: Cramer circumsphere, ``|w |p - c|^2 + o| < 1`` on live
    columns of ``P = [x, y, z, 1, |p|^2]``, expanded as the TPU closure's
    ``|P^T A|`` with ``A = [w(-2c), w|c|^2 + o, w]`` but about P's column 0,
    not the origin (four FMAs per cell in the kernel);
  * plane3d: cross-product normal, ``|P^T A| < 1`` with
    ``A = [w n, o, w]`` on ``P = [x, y, z, 1, guard]``;
  * line2d: two-point normal, the same band on ``P = [x, y, 1, guard]``;
  * line3d: two-point direction ``u`` through ``a``, ``|p-a|^2 -
    (u.(p-a))^2 < delta^2`` on live columns of ``P = [x, y, z, 1, guard]``,
    expanded as the TPU closure does into ``|p|^2 - 2a.p`` and ``u.p - u.a``
    but about P's column 0, not the origin (seven FMAs per cell in the
    kernel);
  * dense_linear6: 6x6 normal-equation Cholesky over six rows ``[a | b]``,
    ``|a.x - b| < delta`` per cell on ``P = [a(6), b, 1, guard]`` (six FMAs
    per cell in the kernel);
  * pivot: 3x3 Schur/Cramer solve over three frames (slot features
    ``[vec(R) 9, t 3, R^T t 3]``), ``|R t_D + t - t_W|^2 < delta^2`` from the
    three residual components per cell on ``P = [t, R^T t, vec(R), 1, guard]``;
  * absolute_orientation: orthonormal frames of three point pairs (slot
    features ``[p1, p2]``), ``R = R2 R1^T``, ``|R p1 + t - p2|^2 < delta^2``
    on ``P = [p1, p2, 1, guard]`` (eleven FMAs per cell in the kernel); the
    kernel's ``[vec(R), t]`` becomes ``[q, t]`` on the host
    (``_POSTPROCESS``);
  * ray3d: midpoint of the common perpendicular of two rays (slot features
    ``[p, n]``), ``t = n.(x-p) >= 0`` and ``|x-p|^2 - t^2 (2 - |n|^2) <
    delta^2`` on ``P = [p, n, n.p, 1, |n|^2, |p|^2]``;
  * crosswire: the minimal ``12 x 12`` system ``[u R2 | v R2 | R2 | -I] x =
    -t2`` of four tracked images (slot features ``[vec(R2) 9, t2 3, u, v]``)
    by equilibrated Householder QR, the scaled columns orthonormalised by
    five Newton polar steps, ``|e|^2 < delta^2`` with ``e_j = u c1_j + v c2_j +
    t3_j + (R2^T t2)_j - (R2 col j).t1`` on ``P = [u, v, 1, R2^T t2, vec(R2),
    guard]``; the kernel's ``[t1, t3, c1, c2, c3]`` become the estimator's 20
    parameters on the host (``_POSTPROCESS``);
  * pointer: the ``9 x 9`` system ``[u R2 | v R2 | R2] x = p - t2`` of three
    images (slot features ``[..., p 3]``), ``e_j = u c1_j + v c2_j + t3_j -
    w_j`` (two FMAs and a subtraction in the kernel) on ``P = [u, v, 1, w =
    R2^T (p - t2), guard]``; ``[t3, c1, c2, c3]`` become 17 parameters on
    the host.

Degenerate lanes count 0 outright.  On CUDA tensors :func:`sweep` launches
the family's hand-written kernel (``csrc/fused_sweep_sphere3d.cu``,
``csrc/fused_sweep_points.cu``, ``csrc/fused_sweep_rigid.cu``,
``csrc/fused_sweep_us.cu``); on CPU tensors it runs :func:`sweep_plain`,
which repeats the kernels' fits and votes operation by operation (every
vote's FMAs through ``linalg.small.fma_f32``, but plane3d's and line2d's,
whose plain votes are one matrix product).
"""

import ctypes

import torch

from lsqrrecipes_tpu_torch import kernels
from lsqrrecipes_tpu_torch.config import SPHERE_EPS
from lsqrrecipes_tpu_torch.device import as_tensor, draw_devices, generator_device
from lsqrrecipes_tpu_torch.estimators.us_calibration import _extract_euler_plus
from lsqrrecipes_tpu_torch.geometry import rotations
from lsqrrecipes_tpu_torch.linalg.small import fma_f32, qr_solve_lanes, scalar_like
from lsqrrecipes_tpu_torch.linalg.small import rsqrt as _rsqrt
from lsqrrecipes_tpu_torch.ops import us_fast
from lsqrrecipes_tpu_torch.ops.vote import _sum_sq_rows
from lsqrrecipes_tpu_torch.tree import n_obs, tree_leaves, tree_map
from lsqrrecipes_tpu_torch.utils import profiling

_HASH_A = 1103515245   # odd => bijection of the shift-tuple index space
_GUARD = 1e30          # pad-column sentinel: |e| >> 1 for any live hypothesis
_NORM2_EPS = 1e-20     # f32 collinearity gate on the squared cross-product norm

# name: (k_slots, feat_rows, n_param_rows, with_pp, dim): ``dim`` is the
# width of a point family's ``[n, dim]`` data, None for the families whose
# data is a Frame, a Ray3D, a point pair or an ultrasound tuple (see _DATA);
# n_param_rows counts the kernel's rows (absolute_orientation's 12 become
# [q, t] on the host, crosswire's 15 and pointer's 12 the estimators' 20
# and 17 parameters).
_FAMILIES = {
    "sphere3d": (4, 3, 4, True, 3),
    "plane3d": (3, 3, 6, False, 3),
    "line3d": (2, 3, 6, True, 3),
    "line2d": (2, 2, 4, False, 2),
    "dense_linear6": (6, 7, 6, False, 7),
    "pivot": (3, 15, 6, False, None),
    "absolute_orientation": (3, 6, 12, False, None),
    "ray3d": (2, 6, 3, False, None),
    "crosswire": (4, 14, 15, False, None),
    "pointer": (3, 17, 12, False, None),
}

# Cells of one plain-version chunk: bounds its [vote_cols, chunk] temporaries
# (float64 ones in the families whose votes round FMAs through fma_f32).
_PLAIN_CELLS = 1 << 25
_PLAIN_CELLS_FMA = dict.fromkeys(("sphere3d", "line3d", "crosswire", "pointer", "dense_linear6",
                                  "pivot", "absolute_orientation", "ray3d"), 1 << 22)

# Hypotheses per fit-and-vote chunk of the ultrasound kernels, and the rows
# of their workspace f32[rows, chunk] (crosswire's 54.5 MB at 2^20,
# pointer's 41.9 MB).
US_CHUNK = 1 << 20
_US_WORKSPACE_ROWS = {"crosswire": 13, "pointer": 10}


def sweep_static(n: int, k_slots: int):
    """Static shift-hash constants ``(m, b, mask)``; n must be ``128 * 2^k``
    lanes and the k-slot hash must fit in 31 bits (else ``ValueError``)."""
    if n % 128:
        raise ValueError("fused sweep requires n divisible by 128")
    m = (4 * n) // 128
    b = m.bit_length() - 1
    if (1 << b) != m:
        raise ValueError("fused sweep requires n = 128 * 2^k")
    if k_slots * b > 31:
        raise ValueError("shift hash exceeds 31 bits")
    return m, b, (1 << (k_slots * b)) - 1


def fit_size(n: int, k_slots: int) -> int:
    """Smallest sampling width ``128 * 2^j >= n`` whose shift hash fits.

    Data sizes that are not ``128 * 2^k`` are REPLICATED up to ``fit_size``
    for the sampling planes only; the vote always runs against the original
    observations with 1e30 guard padding, so inlier counts stay exact.
    """
    nf = 128
    while nf < n:
        nf *= 2
    sweep_static(nf, k_slots)  # raises if the shift hash cannot cover nf
    return nf


def shift_units(g, j, b, m, mask):
    """Slot-j window index (in 128-lane units) for group g.

    ``g`` is a Python int or an int64 tensor; the product is exact there and
    ``& mask`` keeps the low bits that the TPU kernel's int32 (and the CUDA
    kernel's uint32) wraparound keeps.
    """
    return (((g * _HASH_A) & mask) >> (b * j)) & (m - 1)


def slot_planes(points, perms, k_slots: int):
    """Per-slot coordinate planes ``[k_slots * d, 5n]`` f32 (row ``d*j + c``):
    for slot j the permutations ``perms[4j .. 4j+3]`` of the ``n`` points,
    concatenated and wrap-padded with the first."""
    n, d = points.shape
    if len(perms) != 4 * k_slots:
        raise ValueError(f"need {4 * k_slots} permutations, got {len(perms)}")
    pts32 = points.to(torch.float32)
    rows = []
    for j in range(k_slots):
        planes = [
            pts32[as_tensor(perms[4 * j + i], points.device, torch.int64)].T
            for i in range(4)
        ]
        rows.append(torch.cat(planes + [planes[0]], dim=1))
    return torch.cat(rows, dim=0)


def draw_slot_perms(n: int, k_slots: int, generator=None, device=None):
    """The ``4 * k_slots`` random permutations of ``range(n)`` that
    :func:`slot_planes` takes, drawn from ``generator`` -> int64 ``[4k, n]``.
    ``device=None``: the generator's device, else CUDA."""
    gdev, dev = draw_devices(generator, device)
    return torch.stack([
        torch.randperm(n, generator=generator, device=gdev)
        for _ in range(4 * k_slots)
    ]).to(dev)


def _pad_features(feats, n_fit: int):
    """Tile a ``[n, F]`` feature matrix up to ``[n_fit, F]`` by repetition."""
    n = feats.shape[0]
    if n == n_fit:
        return feats
    reps = -(-n_fit // n)
    return torch.cat([feats] * reps, dim=0)[:n_fit]


def pack_feature_rows(points, with_pp: bool):
    """``[n, d] -> P[d+2, n_pad]`` f32 feature rows for the band product:
    ``[coords..., 1, guard]`` where guard is ``|p|^2`` (``with_pp``) or 0 on
    live columns and 1e30 on padding columns."""
    n, d = points.shape
    n_pad = -(-n // 128) * 128
    pts = points.to(torch.float32)
    p = torch.zeros((d + 2, n_pad), dtype=torch.float32, device=points.device)
    p[0:d, :n] = pts.T
    p[d, :n] = 1.0
    p[d + 1, n:] = _GUARD
    if with_pp:
        p[d + 1, :n] = _sum_sq_rows(pts.T)
    return p


def _sum3(a, b, c):
    """``(a + b) + c`` elementwise (the TPU kernels' order)."""
    return a + b + c


def _pivot_features(frames):
    """Frame batch -> per-observation slot features ``[n, 15]`` =
    ``[vec(R) 9, t 3, R^T t 3]``."""
    r = frames.r.to(torch.float32)
    t = frames.t.to(torch.float32)
    return torch.cat([r.reshape(r.shape[0], 9), t, _rt_times(r, t)], dim=1)


def _pivot_p(frames):
    """Vote rows ``[17, n_pad]`` = ``[t 3, R^T t 3, vec(R) 9, 1, guard]``."""
    f = _pivot_features(frames)
    return pack_feature_rows(torch.cat([f[:, 9:15], f[:, 0:9]], dim=1), False)


def _absor_features(data):
    """``(first[n, 3], second[n, 3])`` -> slot features ``[n, 6]``."""
    first, second = data
    return torch.cat([first.to(torch.float32), second.to(torch.float32)], dim=1)


def _absor_p(data):
    """Vote rows ``[8, n_pad]`` = ``[p1 3, p2 3, 1, guard]``."""
    return pack_feature_rows(_absor_features(data), False)


def _ray_features(rays):
    """Ray3D batch -> slot features ``[n, 6]`` = ``[p, n]``."""
    return torch.cat([rays.p.to(torch.float32), rays.n.to(torch.float32)], dim=1)


def _ray_p(rays):
    """Vote rows ``[10, n_pad]`` = ``[p 3, n 3, n.p, 1, |n|^2, |p|^2]``; the
    ``|p|^2`` row is the 1e30 guard on padding columns."""
    f = _ray_features(rays)
    pts, dirs = f[:, 0:3].T, f[:, 3:6].T
    n = f.shape[0]
    p = torch.zeros((10, -(-n // 128) * 128), dtype=torch.float32, device=f.device)
    p[0:6, :n] = f.T
    p[6, :n] = _sum3(*(dirs * pts))
    p[7, :n] = 1.0
    p[8, :n] = _sum_sq_rows(dirs)
    p[9, :] = _GUARD
    p[9, :n] = _sum_sq_rows(pts)
    return p


def _rt_times(r, v):
    """``R^T v`` per observation, ``(R^T v)_j = (R_0j v_0 + R_1j v_1) + R_2j v_2``."""
    return torch.stack([_sum3(r[:, 0, j] * v[:, 0], r[:, 1, j] * v[:, 1], r[:, 2, j] * v[:, 2])
                        for j in range(3)], dim=1)


def _us_rows(q, rest):
    """Pixels ``q [n, 2]`` and ``rest [n, K]`` -> ``P [K + 4, n_pad]`` f32 =
    ``[u, v, 1, rest, guard]``, the guard 0 live and 1e30 on padding columns."""
    n, width = rest.shape
    p = torch.zeros((width + 4, -(-n // 128) * 128), dtype=torch.float32, device=q.device)
    p[0:2, :n] = q.to(torch.float32).T
    p[2, :n] = 1.0
    p[3 : width + 3, :n] = rest.T
    p[width + 3, n:] = _GUARD
    return p


def _crosswire_p(data):
    """Vote rows ``[16, n_pad]`` = ``[u, v, 1, R2^T t2 3, vec(R2) 9, guard]``."""
    frames, q = data
    r, t = frames.r.to(torch.float32), frames.t.to(torch.float32)
    return _us_rows(q, torch.cat([_rt_times(r, t), r.reshape(-1, 9)], dim=1))


def _pointer_p(data):
    """Vote rows ``[7, n_pad]`` = ``[u, v, 1, w 3, guard]``, ``w = R2^T (p - t2)``."""
    frames, q, p = data
    r = frames.r.to(torch.float32)
    return _us_rows(q, _rt_times(r, p.to(torch.float32) - frames.t.to(torch.float32)))


def _us_check(n_leaves):
    """Data check of the ultrasound families: ``(Frame, q[n, 2])`` or
    ``(Frame, q[n, 2], p[n, 3])``."""
    def check(d):
        return (isinstance(d, tuple) and not hasattr(d, "_fields") and len(d) == n_leaves
                and hasattr(d[0], "r") and getattr(d[1], "ndim", 0) == 2 and d[1].shape[1] == 2
                and (n_leaves == 2 or (getattr(d[2], "ndim", 0) == 2 and d[2].shape[1] == 3)))
    return check


# The families whose data is not one [n, dim] point tensor:
# name: (slot features, vote rows P, data check, rows of P).
_DATA = {
    "pivot": (_pivot_features, _pivot_p,
              lambda d: hasattr(d, "r") and hasattr(d, "t"), 17),
    "absolute_orientation": (
        _absor_features, _absor_p,
        lambda d: isinstance(d, tuple) and len(d) == 2
        and getattr(d[0], "ndim", 0) == 2 and d[0].shape[1] == 3, 8),
    "ray3d": (_ray_features, _ray_p, lambda d: hasattr(d, "p") and hasattr(d, "n"), 10),
    "crosswire": (us_fast._slot_features_crosswire, _crosswire_p, _us_check(2), 16),
    "pointer": (us_fast._slot_features_pointer, _pointer_p, _us_check(3), 7),
}


def slot_features(family: str, data):
    """Per-observation slot features ``[n, feat_rows]`` f32 of ``data``."""
    if family in _DATA:
        return _DATA[family][0](data)
    return data.to(torch.float32)


def pack_p(family: str, data):
    """The family's packed vote rows ``P`` of ``data``."""
    if family in _DATA:
        return _DATA[family][1](data)
    return pack_feature_rows(data, _FAMILIES[family][3])


def _p_rows(family: str) -> int:
    return _DATA[family][3] if family in _DATA else _FAMILIES[family][1] + 2


def _data_ok(family: str, data) -> bool:
    if family in _DATA:
        return bool(_DATA[family][2](data))
    return getattr(data, "ndim", 0) == 2 and data.shape[1] == _FAMILIES[family][4]


def supports_data(family: str, data) -> bool:
    """True if the fused sweep covers this (family, data) pair."""
    if family not in _FAMILIES or not _data_ok(family, data):
        return False
    try:
        fit_size(n_obs(data), _FAMILIES[family][0])
    except ValueError:
        return False
    return True


# ---------------------------------------------------------------------------
# The fits that the kernels compute, in plain PyTorch.  Each takes f32 lane
# tensors pts[j][c] (slot j, coordinate c) in its TPU closure's operation
# order; every operation is a separate rounding, as in the CUDA kernels'
# __f*_rn arithmetic, so the two agree bit for bit.
# ---------------------------------------------------------------------------


def circumsphere(pts):
    """Cramer circumsphere of f32 lane tensors ``pts[j][c]`` (slot j,
    coordinate c) in the TPU kernels' exact operation order (the sphere3d
    closure, the per-step sweep and the planar fit-and-vote share it) ->
    ``(center [cx, cy, cz], r, degenerate)``."""
    rows = [[pts[0][c] - pts[i][c] for c in range(3)] for i in (1, 2, 3)]
    rhs = [
        rows[i][0] * (pts[0][0] + pts[i + 1][0])
        + rows[i][1] * (pts[0][1] + pts[i + 1][1])
        + rows[i][2] * (pts[0][2] + pts[i + 1][2])
        for i in range(3)
    ]

    def cof(i, j):
        i1, i2 = [a for a in range(3) if a != i]
        j1, j2 = [a for a in range(3) if a != j]
        v = rows[i1][j1] * rows[i2][j2] - rows[i1][j2] * rows[i2][j1]
        return v if (i + j) % 2 == 0 else -v

    adj = [[cof(j, i) for j in range(3)] for i in range(3)]  # transpose
    det = rows[0][0] * adj[0][0] + rows[0][1] * adj[1][0] + rows[0][2] * adj[2][0]
    degenerate = det.abs() < SPHERE_EPS
    det2 = torch.where(degenerate, torch.ones_like(det), 2.0 * det)
    center = [
        (adj[i][0] * rhs[0] + adj[i][1] * rhs[1] + adj[i][2] * rhs[2]) / det2
        for i in range(3)
    ]
    d = [pts[0][c] - center[c] for c in range(3)]
    r = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return center, r, degenerate


def sphere3d_fit(pts, delta):
    """Circumsphere + band scale for f32 lane tensors ``pts[j][c]`` and
    ``delta`` (a float or an f32 scalar tensor), in the TPU closure's exact
    operation order: ``hi = (r + delta)^2``, ``lo = max(r - delta, 0)^2``,
    ``w = 2 / (hi - lo)``, ``o = -(hi + lo) / (hi - lo)`` (``w = 0, o = 2``
    on degenerate lanes, which never agree).

    Returns ``(center [cx, cy, cz], r, degenerate, [w, o])``; see
    :func:`sphere_band_rows` for the vote's rows.
    """
    center, r, degenerate = circumsphere(pts)
    rp = r + delta
    hi = rp * rp
    lo_root = torch.clamp_min(r - delta, 0.0)
    lo = lo_root * lo_root
    width = torch.clamp_min(hi - lo, 1e-30)
    zero, two = torch.zeros_like(r), torch.full_like(r, 2.0)
    w = torch.where(degenerate, zero, 2.0 / width)
    o = torch.where(degenerate, two, -(hi + lo) / width)
    return center, r, degenerate, [w, o]


def sphere_band_rows(center, scale, origin):
    """The sphere kernels' band rows ``A = [w(-2c'), w|c'|^2 + o, w]`` of
    ``|[x', y', z', 1, |p'|^2] . A| < 1``, ``|e| = |w |p - c|^2 + o|``,
    expanded about ``origin`` (the vote's centre, three f32 scalars): ``c' =
    c - origin`` with each component one f32 subtraction, ``|c'|^2`` in
    coordinate order (``csrc/sphere_fit.cuh`` ``band_rows``).  ``scale`` is
    :func:`sphere3d_fit`'s ``[w, o]``."""
    w, o = scale
    c = [center[k] - origin[k] for k in range(3)]
    cc = c[0] * c[0] + c[1] * c[1] + c[2] * c[2]
    return [w * (-2.0 * c[0]), w * (-2.0 * c[1]), w * (-2.0 * c[2]), w * cc + o, w]


def _signed_band(n_rows, d_off, degenerate, delta):
    """Band rows ``[w n, o, w]`` of ``|(n.p - d_off) / delta| < 1``:
    degenerate lanes get ``w = 0, o = 2`` (they never agree)."""
    inv_delta = scalar_like(1.0 / float(delta), d_off)
    w = torch.where(degenerate, torch.zeros_like(d_off), inv_delta)
    o = torch.where(degenerate, torch.full_like(d_off, 2.0), -d_off * inv_delta)
    return [w * n for n in n_rows] + [o, w]


def plane3d_fit(pts, delta):
    """Cross-product plane through three points
    (``PlaneParametersEstimator.hxx:48-69``), degenerate when the squared
    normal is below 1e-20 -> ``(params [n, s0], degenerate, band rows[5])``."""
    s = pts
    v1 = [s[1][c] - s[0][c] for c in range(3)]
    v2 = [s[2][c] - s[0][c] for c in range(3)]
    nx = v1[1] * v2[2] - v1[2] * v2[1]
    ny = v1[2] * v2[0] - v1[0] * v2[2]
    nz = v1[0] * v2[1] - v1[1] * v2[0]
    norm2 = nx * nx + ny * ny + nz * nz
    degenerate = norm2 < scalar_like(_NORM2_EPS, norm2)
    inv = _rsqrt(torch.where(degenerate, torch.ones_like(norm2), norm2))
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    d_off = nx * s[0][0] + ny * s[0][1] + nz * s[0][2]
    band = _signed_band([nx, ny, nz], d_off, degenerate, delta)
    return [nx, ny, nz, s[0][0], s[0][1], s[0][2]], degenerate, band


def line2d_fit(pts, delta):
    """Two-point 2D line (``Line2DParametersEstimator.cxx:11-32``): n the
    unit perpendicular of p1 - p0, degenerate when the points are closer
    than delta -> ``(params [nx, ny, x0, y0], degenerate, band rows[4])``."""
    x0, y0 = pts[0][0], pts[0][1]
    x1, y1 = pts[1][0], pts[1][1]
    dx, dy = x1 - x0, y1 - y0
    dist2 = dx * dx + dy * dy
    degenerate = dist2 < scalar_like(float(delta) * float(delta), dist2)
    inv = _rsqrt(torch.where(degenerate, torch.ones_like(dist2), dist2))
    nx, ny = dy * inv, -dx * inv
    d_off = nx * x0 + ny * y0
    return [nx, ny, x0, y0], degenerate, _signed_band([nx, ny], d_off, degenerate, delta)


def line3d_fit(pts, delta):
    """Two-point 3D line (``LineParametersEstimator.hxx:23-48``): u the unit
    direction of a - p1 through a = p0, degenerate when the points are
    closer than delta -> ``(params [u, a], degenerate, vote rows [u, a])``."""
    a, p1 = pts[0], pts[1]
    d = [a[c] - p1[c] for c in range(3)]
    dist2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    degenerate = dist2 < scalar_like(float(delta) * float(delta), dist2)
    inv = _rsqrt(torch.where(degenerate, torch.ones_like(dist2), dist2))
    params = [d[c] * inv for c in range(3)] + list(a)
    return params, degenerate, params


def _sphere3d_rows(pts, delta):
    """``(params [c, r], degenerate, vote rows [c, w, o])``: the band rows
    are formed about the vote's centre in :func:`_sphere3d_vote`."""
    center, r, degenerate, scale = sphere3d_fit(pts, scalar_like(float(delta), pts[0][0]))
    return center + [r], degenerate, center + scale


def _split_delta(delta):
    """``(delta, cross_eps)``: the ray family's pack, or ``(delta, 0)``."""
    if isinstance(delta, (tuple, list)):
        return float(delta[0]), float(delta[1])
    return float(delta), 0.0


def _cross(u, v):
    return [u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2], u[0] * v[1] - u[1] * v[0]]


def _dot3(u, v):
    return _sum3(u[0] * v[0], u[1] * v[1], u[2] * v[2])


def pivot_fit(pts, delta):
    """Pivot calibration from three frames (slot features ``[vec(R) 9, t 3,
    R^T t 3]``): with ``S = sum R``, ``v = sum t``, ``u = sum R^T t``, solve
    ``(9I - S S^T) t_W = 3v - S u`` by Cramer (degenerate when ``|det| <
    1e-6``), then ``t_D = (S^T t_W - u) / 3`` -> ``(params [t_D, t_W],
    degenerate, vote rows = params)``."""
    def ssum(c):
        return _sum3(pts[0][c], pts[1][c], pts[2][c])

    s = [[ssum(3 * j + k) for k in range(3)] for j in range(3)]
    v = [ssum(9 + a) for a in range(3)]
    u = [ssum(12 + a) for a in range(3)]

    def dotr(a, b):
        return _sum3(s[a][0] * s[b][0], s[a][1] * s[b][1], s[a][2] * s[b][2])

    n00, n11, n22 = 9.0 - dotr(0, 0), 9.0 - dotr(1, 1), 9.0 - dotr(2, 2)
    n01, n02, n12 = -dotr(0, 1), -dotr(0, 2), -dotr(1, 2)
    r = [3.0 * v[j] - _sum3(s[j][0] * u[0], s[j][1] * u[1], s[j][2] * u[2]) for j in range(3)]
    c00 = n11 * n22 - n12 * n12
    c01 = n02 * n12 - n01 * n22
    c02 = n01 * n12 - n02 * n11
    det = _sum3(n00 * c00, n01 * c01, n02 * c02)
    degenerate = det.abs() < scalar_like(1e-6, det)
    det = torch.where(degenerate, torch.ones_like(det), det)
    c11 = n00 * n22 - n02 * n02
    c12 = n01 * n02 - n00 * n12
    c22 = n00 * n11 - n01 * n01
    tw = [_sum3(a * r[0], b * r[1], c * r[2]) / det
          for a, b, c in ((c00, c01, c02), (c01, c11, c12), (c02, c12, c22))]
    three = scalar_like(3.0, det)
    td = [(_sum3(s[0][k] * tw[0], s[1][k] * tw[1], s[2][k] * tw[2]) - u[k]) / three
          for k in range(3)]
    params = td + tw
    return params, degenerate, params


def absolute_orientation_fit(pts, delta):
    """Rigid transform of three point pairs (slot features ``[p1, p2]``):
    per set ``x = normalize(q0 - mean)``, ``y`` by Gram-Schmidt from ``q1 -
    mean``, ``z = x cross y`` (degenerate when ``|z|^2 < 1e-12``); ``R = R2
    R1^T``, ``t = mean2 - R mean1`` -> ``(rows [vec(R) 9, t 3], degenerate,
    vote rows = rows)``."""
    floor, three = scalar_like(1e-30, pts[0][0]), scalar_like(3.0, pts[0][0])

    def build_frame(q):
        mean = [_sum3(q[0][c], q[1][c], q[2][c]) / three for c in range(3)]
        x = [q[0][c] - mean[c] for c in range(3)]
        xr = _rsqrt(torch.maximum(_dot3(x, x), floor))
        x = [x[c] * xr for c in range(3)]
        y = [q[1][c] - mean[c] for c in range(3)]
        d = _dot3(y, x)
        y = [y[c] - d * x[c] for c in range(3)]
        yr = _rsqrt(torch.maximum(_dot3(y, y), floor))
        y = [y[c] * yr for c in range(3)]
        z = _cross(x, y)
        return x, y, z, mean, _dot3(z, z) < scalar_like(1e-12, floor)

    x1, y1, z1, m1, d1 = build_frame([p[0:3] for p in pts])
    x2, y2, z2, m2, d2 = build_frame([p[3:6] for p in pts])
    r = [[_sum3(x2[a] * x1[b], y2[a] * y1[b], z2[a] * z1[b]) for b in range(3)]
         for a in range(3)]
    t = [m2[a] - _dot3(r[a], m1) for a in range(3)]
    rows = [r[a][b] for a in range(3) for b in range(3)] + t
    return rows, d1 | d2, rows


def ray3d_fit(pts, delta):
    """Midpoint of the common perpendicular of two rays (slot features
    ``[p, n]``), degenerate when ``|na x nb|^2 < cross_eps`` or either ray
    parameter is negative -> ``(params x, degenerate, vote rows x)``."""
    cross_eps = scalar_like(_split_delta(delta)[1], pts[0][0])
    pa, na = pts[0][0:3], pts[0][3:6]
    pb, nb = pts[1][0:3], pts[1][3:6]
    p21 = [pb[c] - pa[c] for c in range(3)]
    cr = _cross(na, nb)
    denom = _dot3(cr, cr)
    nonparallel = denom >= cross_eps
    safe = torch.where(nonparallel, denom, torch.ones_like(denom))
    t1 = _dot3(cr, _cross(p21, nb)) / safe
    t2 = _dot3(cr, _cross(p21, na)) / safe
    degenerate = ~(nonparallel & (t1 >= 0) & (t2 >= 0))
    x = [0.5 * (pa[c] + t1 * na[c] + pb[c] + t2 * nb[c]) for c in range(3)]
    return x, degenerate, x


def dense_linear6_fit(pts, delta):
    """Six rows ``[a 6, b]`` -> normal equations ``(A^T A) x = A^T b``, an
    unrolled Cholesky whose pivots below 1e-10 flag the degenerate case,
    forward and back substitution -> ``(params x, degenerate, vote rows x)``."""
    eps = scalar_like(1e-10, pts[0][0])

    def dot6(i, j):
        acc = pts[0][i] * pts[0][j]
        for s in range(1, 6):
            acc = acc + pts[s][i] * pts[s][j]
        return acc

    m = {(i, j): dot6(i, j) for i in range(6) for j in range(i, 6)}
    v = [dot6(i, 6) for i in range(6)]
    l = {}
    degenerate = None
    for i in range(6):
        s = m[i, i]
        for k in range(i):
            s = s - l[i, k] * l[i, k]
        bad = s < eps
        degenerate = bad if degenerate is None else degenerate | bad
        l[i, i] = torch.sqrt(torch.maximum(s, eps))
        for j in range(i + 1, 6):
            t = m[i, j]
            for k in range(i):
                t = t - l[j, k] * l[i, k]
            l[j, i] = t / l[i, i]
    y = [None] * 6
    for i in range(6):
        t = v[i]
        for k in range(i):
            t = t - l[i, k] * y[k]
        y[i] = t / l[i, i]
    x = [None] * 6
    for i in reversed(range(6)):
        t = y[i]
        for k in range(i + 1, 6):
            t = t - l[k, i] * x[k]
        x[i] = t / l[i, i]
    return x, degenerate, x


def _us_fit(system, k, pts):
    """The ultrasound fits' common part: ``system``'s rows by
    :func:`~lsqrrecipes_tpu_torch.linalg.small.qr_solve_lanes`, then the
    scaled columns ``x[0:3], x[3:6]`` to ``c1 = m_x R3(:,0)``, ``c2 = m_y
    R3(:,1)``, ``c3 = R3(:,2)`` by :func:`~lsqrrecipes_tpu_torch.ops.us_fast.
    orthonormalize_lanes` -> ``(x, c1, c2, c3, degenerate)``."""
    rows, rhs = system(lambda a, f: pts[a][f], k)
    x, ok = qr_solve_lanes(rows, rhs)
    m_x, m_y, rot, ok_rot = us_fast.orthonormalize_lanes(x[0:3], x[3:6])
    c1 = [m_x * rot[i][0] for i in range(3)]
    c2 = [m_y * rot[i][1] for i in range(3)]
    c3 = [rot[i][2] for i in range(3)]
    return x, c1, c2, c3, ~(ok & ok_rot)


def crosswire_fit(pts, delta):
    """Crosswire calibration from four tracked images (slot features
    ``[vec(R2) 9, t2 3, u, v]``): the ``12 x 12`` system by QR, the rotation
    by polar iteration -> ``(rows [t1 3, t3 3, c1 3, c2 3, c3 3], degenerate,
    vote rows = rows)``."""
    x, c1, c2, c3, degenerate = _us_fit(us_fast.crosswire_system, 4, pts)
    rows = x[9:12] + x[6:9] + c1 + c2 + c3
    return rows, degenerate, rows


def pointer_fit(pts, delta):
    """Pointer calibration from three tracked images (slot features
    ``[vec(R2) 9, t2 3, u, v, p 3]``): the ``9 x 9`` system by QR, the
    rotation by polar iteration -> ``(rows [t3 3, c1 3, c2 3, c3 3],
    degenerate, vote rows = rows)``."""
    x, c1, c2, c3, degenerate = _us_fit(us_fast.pointer_system, 3, pts)
    rows = x[6:9] + c1 + c2 + c3
    return rows, degenerate, rows


_FITS = {
    "sphere3d": _sphere3d_rows,
    "plane3d": plane3d_fit,
    "line3d": line3d_fit,
    "line2d": line2d_fit,
    "dense_linear6": dense_linear6_fit,
    "pivot": pivot_fit,
    "absolute_orientation": absolute_orientation_fit,
    "ray3d": ray3d_fit,
    "crosswire": crosswire_fit,
    "pointer": pointer_fit,
}


def _band_vote(p_vote, rows, delta):
    """``#{columns: |P^T A| < 1}`` per hypothesis (one product)."""
    return ((p_vote.T @ torch.stack(rows)).abs() < 1.0).sum(dim=0)


def sphere_band_e(a_rows, x, y, z, pp):
    """The sphere kernels' band value of a cell (the sphere3d sweep's and the
    per-step sweep's), ``e = fma(a4, |p|^2, fma(a2, z, fma(a1, y, fma(a0, x,
    a3))))`` with each FMA rounded once as CUDA's ``__fmaf_rn``
    (:func:`~lsqrrecipes_tpu_torch.linalg.small.fma_f32`); the band rows and
    the point rows broadcast together."""
    a0, a1, a2, a3, a4 = a_rows
    return fma_f32(a4, pp, fma_f32(a2, z, fma_f32(a1, y, fma_f32(a0, x, a3))))


def _sphere3d_vote(p_vote, rows, delta):
    """``#{live columns: |w |p - c|^2 + o| < 1}`` in the kernel's per-cell
    arithmetic: points and centres taken relative to P's column 0, ``c0``
    (``x' = x - c0_x``, ... and ``|p'|^2 = (x'^2 + y'^2) + z'^2``; P's
    ``|p|^2`` row is not read), then :func:`sphere_band_e` with
    :func:`sphere_band_rows` about ``c0``; live where the ones row (3) is
    nonzero.  ``rows`` are :func:`_sphere3d_rows`' ``[c, w, o]``."""
    c0 = p_vote[0:3, 0]
    x, y, z = ((p_vote[k] - c0[k])[:, None] for k in range(3))
    a_rows = sphere_band_rows(rows[0:3], rows[3:5], c0)
    e = sphere_band_e(a_rows, x, y, z, _sum3(x * x, y * y, z * z))
    return ((e.abs() < 1.0) & _live(p_vote, 3)).sum(dim=0)


def _line3d_vote(p_vote, rows, delta):
    """``#{live columns: |p - a|^2 - (u.(p - a))^2 < delta^2}`` in the
    kernel's per-cell arithmetic, each FMA rounded once as CUDA's
    ``__fmaf_rn`` (:func:`~lsqrrecipes_tpu_torch.linalg.small.fma_f32`).
    Points and anchor are first taken relative to the centre ``c`` = P's
    column 0 (``p' = p - c``, ``a' = a - c``), so that the expansion's terms
    scale with the cloud's extent and not with its offset: ``t =
    fma(-2a'_z, z', fma(-2a'_y, y', fma(-2a'_x, x', |p'|^2)))`` with
    ``|p'|^2 = (x'^2 + y'^2) + z'^2``, ``e1 = fma(u_z, z', fma(u_y, y',
    fma(u_x, x', -u.a')))``, and the count where ``fma(-e1, e1, t) < delta^2
    - |a'|^2``."""
    u0, u1, u2, *a = rows
    c = p_vote[0:3, 0]
    x, y, z = ((p_vote[k] - c[k])[:, None] for k in range(3))
    pp = _sum3(x * x, y * y, z * z)
    a0, a1, a2 = (a[k] - c[k] for k in range(3))
    t = fma_f32(-2.0 * a0, x, pp)                       # -2a' is exact
    t = fma_f32(-2.0 * a1, y, t)
    t = fma_f32(-2.0 * a2, z, t)
    e1 = fma_f32(u0, x, -_sum3(u0 * a0, u1 * a1, u2 * a2))
    e1 = fma_f32(u1, y, e1)
    e1 = fma_f32(u2, z, e1)
    thr = scalar_like(float(delta) * float(delta), a0) - _sum3(a0 * a0, a1 * a1, a2 * a2)
    inside = (fma_f32(-e1, e1, t) < thr) & _live(p_vote, 3)
    return inside.sum(dim=0)


def _live(p_vote, row):
    """``[cols, 1]`` mask of the live columns (the ones row is nonzero)."""
    return (p_vote[row] != 0)[:, None]


def _pivot_vote(p_vote, rows, delta):
    """``|R t_D + t - t_W|^2 < delta^2`` per cell in the kernel's
    arithmetic, each FMA rounded once as CUDA's ``__fmaf_rn`` (``fma_f32``):
    ``e_j = fma(R_j2, td_2, fma(R_j1, td_1, fma(R_j0, td_0, t_j))) -
    tw_j``, the subtraction last, and ``|e|^2`` as :func:`_fma_norm_vote`
    (rows of P: t 0-2, vec(R) 6-14, ones 15)."""
    td, tw = rows[:3], rows[3:]
    col = [p_vote[r][:, None] for r in range(15)]
    e = []
    for j in range(3):
        acc = col[j]
        for k in range(3):
            acc = fma_f32(col[6 + 3 * j + k], td[k], acc)
        e.append(acc - tw[j])
    return _fma_norm_vote(p_vote, e, delta, 15)


def _absor_vote(p_vote, rows, delta):
    """``|R p1 + t - p2|^2 < delta^2`` per cell in the kernel's arithmetic,
    each FMA rounded once as CUDA's ``__fmaf_rn`` (``fma_f32``): ``e_j =
    fma(R_j2, z1, fma(R_j1, y1, fma(R_j0, x1, t_j))) - p2_j``, the
    subtraction last, and ``|e|^2`` as :func:`_fma_norm_vote` (rows of P: p1
    0-2, p2 3-5, ones 6)."""
    col = [p_vote[r][:, None] for r in range(6)]
    e = []
    for j in range(3):
        acc = rows[9 + j]
        for k in range(3):
            acc = fma_f32(rows[3 * j + k], col[k], acc)
        e.append(acc - col[3 + j])
    return _fma_norm_vote(p_vote, e, delta, 6)


def _ray3d_vote(p_vote, rows, delta):
    """``t = n.(x - p) >= 0`` and ``|x - p|^2 - t^2 (2 - |n|^2) < delta^2``
    per cell in the kernel's arithmetic, each FMA rounded once as CUDA's
    ``__fmaf_rn`` (``fma_f32``): ``v = x - p``, ``t = fma(n_z, v_z, fma(n_y,
    v_y, n_x v_x))``, ``|v|^2`` likewise, ``w = 2 - |n|^2`` and the test
    ``fma(-(t t), w, |v|^2) < delta^2`` (rows of P: p 0-2, n 3-5, ones 7,
    |n|^2 8)."""
    d = _split_delta(delta)[0]
    v = [rows[c] - p_vote[c][:, None] for c in range(3)]
    n = [p_vote[3 + c][:, None] for c in range(3)]
    t = fma_f32(n[2], v[2], fma_f32(n[1], v[1], n[0] * v[0]))
    d2 = fma_f32(v[2], v[2], fma_f32(v[1], v[1], v[0] * v[0]))
    e = fma_f32(-(t * t), (2.0 - p_vote[8])[:, None], d2)
    inside = (t >= 0) & (e < scalar_like(d * d, t))
    return (inside & _live(p_vote, 7)).sum(dim=0)


def _dense6_vote(p_vote, rows, delta):
    """``|a.x - b| < delta`` per cell in the kernel's arithmetic, ``e =
    fma(a5, x5, ... fma(a1, x1, fma(a0, x0, -b)))`` with each FMA rounded
    once as CUDA's ``__fmaf_rn`` (``fma_f32``) (rows of P: a 0-5, b 6, ones
    7)."""
    e = -p_vote[6][:, None]
    for c in range(6):
        e = fma_f32(p_vote[c][:, None], rows[c], e)
    return ((e.abs() < scalar_like(float(delta), e)) & _live(p_vote, 7)).sum(dim=0)


def _fma_norm_vote(p_vote, e, delta, live_row):
    """``#{live columns: fma(e_2, e_2, fma(e_1, e_1, e_0 e_0)) < delta^2}``,
    each FMA rounded once as CUDA's ``__fmaf_rn`` (``fma_f32``)."""
    dist2 = fma_f32(e[2], e[2], fma_f32(e[1], e[1], e[0] * e[0]))
    d = float(delta)
    return ((dist2 < scalar_like(d * d, dist2)) & _live(p_vote, live_row)).sum(dim=0)


def _crosswire_vote(p_vote, rows, delta):
    """``|e|^2 < delta^2`` per cell in the kernel's arithmetic, each FMA
    rounded once as CUDA's ``__fmaf_rn`` (``fma_f32``): ``e_j =
    fma(R2[2][j], -t1_2, fma(R2[1][j], -t1_1, fma(R2[0][j], -t1_0, fma(v,
    c2_j, fma(u, c1_j, t3_j + (R2^T t2)_j)))))``, ``|e|^2 = fma(e_2, e_2,
    fma(e_1, e_1, e_0 e_0))`` (rows of P: u 0, v 1, ones 2, R2^T t2 3-5,
    vec(R2) 6-14, so ``R2[k][j]`` is row ``6 + 3k + j``)."""
    t1, t3, c1, c2 = rows[0:3], rows[3:6], rows[6:9], rows[9:12]
    col = [p_vote[r][:, None] for r in range(15)]
    e = []
    for j in range(3):
        acc = fma_f32(col[0], c1[j], t3[j] + col[3 + j])
        acc = fma_f32(col[1], c2[j], acc)
        for k in range(3):
            acc = fma_f32(col[6 + 3 * k + j], -t1[k], acc)
        e.append(acc)
    return _fma_norm_vote(p_vote, e, delta, 2)


def _pointer_vote(p_vote, rows, delta):
    """``|e|^2 < delta^2`` per cell in the kernel's arithmetic, each FMA
    rounded once as CUDA's ``__fmaf_rn`` (``fma_f32``): ``e_j = fma(v, c2_j,
    fma(u, c1_j, t3_j)) - w_j``, the subtraction last as in the TPU
    closure's ``((u c1_j + v c2_j) + t3_j) - w_j``, and ``|e|^2 = fma(e_2,
    e_2, fma(e_1, e_1, e_0 e_0))`` (rows of P: u 0, v 1, ones 2, w 3-5)."""
    t3, c1, c2 = rows[0:3], rows[3:6], rows[6:9]
    col = [p_vote[r][:, None] for r in range(6)]
    e = [fma_f32(col[1], c2[j], fma_f32(col[0], c1[j], t3[j])) - col[3 + j] for j in range(3)]
    return _fma_norm_vote(p_vote, e, delta, 2)


_VOTES = {
    "sphere3d": _sphere3d_vote,
    "plane3d": _band_vote,
    "line3d": _line3d_vote,
    "line2d": _band_vote,
    "dense_linear6": _dense6_vote,
    "pivot": _pivot_vote,
    "absolute_orientation": _absor_vote,
    "ray3d": _ray3d_vote,
    "crosswire": _crosswire_vote,
    "pointer": _pointer_vote,
}


def _absor_post(rows):
    """Kernel rows ``[vec(R) 9, t 3]`` -> estimator params ``[q 4, t 3]`` in f64."""
    r = rows[0:9].to(torch.float64).reshape(3, 3)
    return torch.cat([rotations.quaternion_from_matrix(r), rows[9:12].to(torch.float64)])


def _us_post(rows):
    """Kernel rows ``[translations..., c1 3, c2 3, c3 3]`` -> ``[translations,
    w_z, w_y, w_x, m_x, m_y, c1, c2, c3]`` in f64: the scales are the column
    norms and the angles the '+sqrt' Euler-ZYX extraction of
    ``[c1/m_x, c2/m_y, c3]``."""
    v = rows.to(torch.float64)
    c1, c2, c3 = v[-9:-6], v[-6:-3], v[-3:]
    m_x, m_y = torch.linalg.vector_norm(c1), torch.linalg.vector_norm(c2)
    one = torch.ones_like(m_x)
    r3 = torch.stack([c1 / torch.where(m_x > 0, m_x, one), c2 / torch.where(m_y > 0, m_y, one),
                      c3], dim=1)
    derived = torch.stack([*_extract_euler_plus(r3), m_x, m_y])
    return torch.cat([v[:-9], derived, c1, c2, c3])


# Host-side conversion of the winner's kernel rows to the estimator's layout.
_POSTPROCESS = {"absolute_orientation": _absor_post, "crosswire": _us_post,
                "pointer": _us_post}


# ---------------------------------------------------------------------------
# The sweep: plain version, CUDA wrapper, dispatch
# ---------------------------------------------------------------------------


def _sweep_args(family, coords, p, n_fit, num_groups, vote_cols):
    if family not in _FAMILIES:
        raise ValueError(f"fused family {family!r} is not ported")
    k_slots, feat_rows = _FAMILIES[family][:2]
    rows = k_slots * feat_rows
    if coords.ndim != 2 or coords.shape[0] != rows or coords.shape[1] != 5 * n_fit:
        raise ValueError(f"coords must be [{rows}, {5 * n_fit}], got {tuple(coords.shape)}")
    if p.ndim != 2 or p.shape[0] != _p_rows(family):
        raise ValueError(f"p must be [{_p_rows(family)}, n_pad], got {tuple(p.shape)}")
    if not 0 < vote_cols <= p.shape[1]:
        raise ValueError(f"vote_cols must be in (0, {p.shape[1]}], got {vote_cols}")
    if num_groups < 1 or num_groups * n_fit >= 2**31:
        raise ValueError("the sweep supports 1 to 2^31 / n_fit groups")
    if coords.device != p.device:
        raise ValueError("coords and p lie on different devices")
    return sweep_static(n_fit, k_slots)


def sweep_plain(family, coords, p, n_fit, num_groups, vote_cols, delta):
    """Plain PyTorch version of the family's kernel.

    Evaluates hypotheses ``h = g * n_fit + lane`` for ``g < num_groups`` and
    returns ``(count int32[], params f32[n_param_rows], index int64[])`` of
    the best: the highest count, ties to the lowest ``h``.  ``delta`` is a
    float, or ray3d's ``(delta, cross_eps)``.
    """
    m, b, mask = _sweep_args(family, coords, p, n_fit, num_groups, vote_cols)
    k_slots, feat_rows = _FAMILIES[family][:2]
    dev = coords.device
    coords = coords.to(torch.float32)
    p_vote = p[:, :vote_cols].to(torch.float32)
    lanes = torch.arange(n_fit, device=dev)
    gchunk = max(1, _PLAIN_CELLS_FMA.get(family, _PLAIN_CELLS) // (n_fit * vote_cols))
    best = None   # (count, index, params)
    for g0 in range(0, num_groups, gchunk):
        g = torch.arange(g0, min(num_groups, g0 + gchunk), device=dev, dtype=torch.int64)
        pts = []
        for j in range(k_slots):
            cols = (shift_units(g, j, b, m, mask) * 128)[:, None] + lanes[None, :]
            pts.append([coords[feat_rows * j + c][cols] for c in range(feat_rows)])
        params, degenerate, rows = _FITS[family](pts, delta)
        counts = _VOTES[family](p_vote, [x.reshape(-1) for x in rows], delta)
        counts = torch.where(degenerate.reshape(-1), 0, counts)
        i = int(torch.argmax(counts))                             # first max
        count = int(counts[i])
        if best is None or count > best[0]:
            best = (count, g0 * n_fit + i, torch.stack([x.reshape(-1)[i] for x in params]))
    count, index, params = best
    return (torch.tensor(count, dtype=torch.int32, device=dev), params,
            torch.tensor(index, dtype=torch.int64, device=dev))


def sweep_cuda(family, coords, p, n_fit, num_groups, vote_cols, delta):
    """Launch the family's kernel on the current stream; same contract as
    :func:`sweep_plain`.  Raises on a non-CUDA, non-f32 or non-contiguous
    input, and when the build or the launch fails.  The kernel's constants
    are the double values rounded once to f32, as the TPU closures' Python
    floats are."""
    m, b, mask = _sweep_args(family, coords, p, n_fit, num_groups, vote_cols)
    kernels.check_inputs(coords=coords, p=p)
    npr = _FAMILIES[family][2]
    dev = coords.device
    best_key = torch.empty((1,), dtype=torch.int64, device=dev)
    best_out = torch.empty((npr + 1,), dtype=torch.float32, device=dev)
    best_index = torch.empty((1,), dtype=torch.int64, device=dev)
    head = (coords.data_ptr(), coords.shape[1], p.data_ptr(), p.shape[1],
            vote_cols, n_fit, num_groups, b, m, mask)
    tail = (best_key.data_ptr(), best_out.data_ptr(), best_index.data_ptr())
    if family in _US_WORKSPACE_ROWS:
        chunk = min(num_groups * n_fit, US_CHUNK)
        workspace = torch.empty((_US_WORKSPACE_ROWS[family], chunk), dtype=torch.float32,
                                device=dev)
        tail += (workspace.data_ptr(), chunk)
    delta, cross_eps = _split_delta(delta)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if family == "sphere3d":
            consts = (ctypes.c_float(delta),)
        elif family in kernels.RIGID_FAMILIES + kernels.US_FAMILIES:
            consts = (ctypes.c_float(delta), ctypes.c_float(delta * delta),
                      ctypes.c_float(cross_eps))
        else:
            consts = (ctypes.c_float(1.0 / delta), ctypes.c_float(delta * delta))
        kernels.FUSED_SWEEPS[family].launch(*head, *consts, *tail, stream)
    return best_out[npr].to(torch.int32), best_out[:npr], best_index[0]


def sweep(family, coords, p, n_fit, num_groups, vote_cols, delta):
    """The sweep on ``coords``' device: the family's CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if coords.is_cuda:
        return sweep_cuda(family, coords, p, n_fit, num_groups, vote_cols, delta)
    return sweep_plain(family, coords, p, n_fit, num_groups, vote_cols, delta)


def sphere3d_sweep_plain(coords, p, n_fit, num_groups, vote_cols, delta):
    """:func:`sweep_plain` for ``sphere3d``."""
    return sweep_plain("sphere3d", coords, p, n_fit, num_groups, vote_cols, delta)


def sphere3d_sweep_cuda(coords, p, n_fit, num_groups, vote_cols, delta):
    """:func:`sweep_cuda` for ``sphere3d`` (``csrc/fused_sweep_sphere3d.cu``)."""
    return sweep_cuda("sphere3d", coords, p, n_fit, num_groups, vote_cols, delta)


def sphere3d_sweep(coords, p, n_fit, num_groups, vote_cols, delta):
    """:func:`sweep` for ``sphere3d``."""
    return sweep("sphere3d", coords, p, n_fit, num_groups, vote_cols, delta)


# ---------------------------------------------------------------------------
# Public driver
# ---------------------------------------------------------------------------


def fused_sweep(
    family: str,
    data,
    generator=None,
    total_groups: int = 1,
    delta=1.0,
    groups_per_step: int = 1,
    vote_subsample: int = 0,
    *,
    perms=None,
    vote_perm=None,
    device=None,
):
    """Run a whole fused sweep -> ``(best_count int32[], best_params)`` in the
    estimator's parameter order (sphere ``[c, r]``, plane ``[n, s0]``,
    line3d ``[u, a]``, line2d ``[nx, ny, x0, y0]``, dense_linear6 ``x``,
    pivot ``[t_D, t_W]``, ray3d ``x``: f32; absolute_orientation ``[q, t]``,
    crosswire's 20 and pointer's 17 parameters: f64, converted from the
    kernel's rows on the host).

    ``data``: the estimator's data (numpy goes to ``device``, default CUDA;
    tensors stay on their device): ``[n, dim]`` points or rows, a ``Frame``
    (pivot), a ``(first, second)`` pair (absolute_orientation), a
    ``Ray3D`` (ray3d), ``(Frame, q)`` (crosswire) or ``(Frame, q, p)``
    (pointer).  ``delta`` is a float, or ray3d's ``(delta,
    cross_eps)``.  ``groups_per_step`` keeps the JAX package's set of
    evaluated groups, ``ceil(total_groups / gps) * gps``.
    ``vote_subsample`` (a multiple of 128, ``<= n``) ranks on the first
    ``vote_subsample`` observations of a random order, so the count
    returned is the winner's subsample count; 0 = exact full vote.

    Randomness comes from ``generator``, or explicitly: ``perms`` are the
    ``4 * k_slots`` slot-plane permutations of ``range(fit_size(n))`` and
    ``vote_perm`` the subsample permutation of ``range(n)``.
    """
    if family not in _FAMILIES:
        raise ValueError(f"fused family {family!r} is not ported")
    with profiling.span("sweep"):
        data = as_tensor(data, device)
        if not _data_ok(family, data):
            raise ValueError(f"data of type {type(data).__name__} does not fit the {family} sweep")
        with profiling.leaf("sweep.prep"):
            coords, p, n_fit, vote_cols = sweep_inputs(
                family, data, generator, vote_subsample, perms=perms, vote_perm=vote_perm
            )
        num_groups = -(-total_groups // groups_per_step) * groups_per_step
        if not isinstance(delta, (tuple, list)):
            delta = float(delta)
        with profiling.leaf("sweep.launch"):
            count, params, _index = sweep(family, coords, p, n_fit, num_groups, vote_cols, delta)
        post = _POSTPROCESS.get(family)
        if post is None:
            return count, params
        with profiling.leaf("sweep.post"):
            return count, post(params)


def sweep_inputs(family: str, data, generator=None, vote_subsample: int = 0,
                 *, perms=None, vote_perm=None):
    """Host side of :func:`fused_sweep` -> ``(coords, p, n_fit, vote_cols)``:
    the slot planes, the packed (optionally subsample-permuted) vote rows
    and the sizes the kernel takes.  ``data`` is a tensor or a tree of
    tensors on one device."""
    k_slots = _FAMILIES[family][0]
    n = n_obs(data)
    dev = tree_leaves(data)[0].device
    n_fit = fit_size(n, k_slots)
    if vote_subsample:
        if vote_subsample % 128 or not 0 < vote_subsample <= n:
            raise ValueError("vote_subsample must be a multiple of 128 in (0, n]")
        if vote_perm is None:
            vote_perm = torch.randperm(n, generator=generator,
                                       device=generator_device(generator, dev))
        vote_perm = as_tensor(vote_perm, dev, torch.int64)
        p = pack_p(family, tree_map(lambda leaf: leaf[vote_perm], data))
        vote_cols = vote_subsample
    else:
        p = pack_p(family, data)
        vote_cols = p.shape[1]
    if perms is None:
        perms = draw_slot_perms(n_fit, k_slots, generator, dev)
    coords = slot_planes(_pad_features(slot_features(family, data), n_fit), perms, k_slots)
    return coords, p, n_fit, vote_cols


def reference_samples(family: str, data, perms, total_groups: int):
    """Plain reconstruction of the sweep's hypothesis set (tests):
    ``[total_groups * n_fit, k_slots, feat_rows]`` slot features, the
    engine's ``[B, k, d]`` layout for the point families (pivot rows are
    ``[vec(R) 9, t 3, R^T t 3]``, absolute_orientation ``[p1, p2]``, ray3d
    ``[p, n]``, crosswire ``[vec(R2) 9, t2 3, u, v]``, pointer ``[..., p 3]``)."""
    k_slots, feat_rows = _FAMILIES[family][:2]
    n = fit_size(n_obs(data), k_slots)
    m, b, mask = sweep_static(n, k_slots)
    planes = slot_planes(_pad_features(slot_features(family, data), n), perms, k_slots)
    slots = []
    for j in range(k_slots):
        segs = []
        for g in range(total_groups):
            s = int(shift_units(g, j, b, m, mask)) * 128
            segs.append(planes[feat_rows * j : feat_rows * (j + 1), s : s + n])
        slots.append(torch.cat(segs, dim=1))          # [F, B]
    return torch.stack(slots, dim=0).permute(2, 0, 1)  # [B, k, F]
