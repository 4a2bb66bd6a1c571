"""Whole-sweep fused RANSAC for the point families ``sphere3d``, ``plane3d``,
``line3d`` and ``line2d`` (counterpart of ``lsqrrecipes_tpu/ops/fused_sweep.py``).

One call evaluates ``groups * n_fit`` hypotheses and returns only the best
one.  Sampling is gather-free: each of the ``k`` sample slots draws from FOUR
independent permutations of the (replication-padded) data laid out as one
``[d, 5 n_fit]`` plane (perm0|perm1|perm2|perm3|perm0), and group ``g`` takes
for slot ``j`` the 128-aligned window at ``shift_units(g, j)`` of it, hashed
from ``g`` (no shift table).  Each family's minimal fit runs per lane; its
vote counts the columns of the packed point rows ``P = [coords, 1, guard]``
(a 1e30 guard on padding columns) that fall in the family's band:

  * sphere3d: Cramer circumsphere, ``|P^T A| < 1`` with
    ``A = [w(-2c), w|c|^2 + o, w]`` on ``P = [x, y, z, 1, |p|^2]``;
  * plane3d: cross-product normal, ``|P^T A| < 1`` with
    ``A = [w n, o, w]`` on ``P = [x, y, z, 1, guard]``;
  * line2d: two-point normal, the same band on ``P = [x, y, 1, guard]``;
  * line3d: two-point direction ``u`` through ``a``, ``|p-a|^2 -
    (u.(p-a))^2 < delta^2`` computed from ``p - a`` per cell on live columns.

Degenerate lanes count 0 outright.  On CUDA tensors :func:`sweep` launches
the family's hand-written kernel (``csrc/fused_sweep_sphere3d.cu``,
``csrc/fused_sweep_points.cu``); on CPU tensors it runs :func:`sweep_plain`,
which repeats the kernels' fits operation by operation.
"""

import ctypes

import torch

from lsqrrecipes_tpu_torch import kernels
from lsqrrecipes_tpu_torch.config import SPHERE_EPS
from lsqrrecipes_tpu_torch.device import as_tensor, generator_device
from lsqrrecipes_tpu_torch.ops.vote import _sum_sq_rows

_HASH_A = 1103515245   # odd => bijection of the shift-tuple index space
_GUARD = 1e30          # pad-column sentinel: |e| >> 1 for any live hypothesis
_NORM2_EPS = 1e-20     # f32 collinearity gate on the squared cross-product norm

# name: (k_slots, feat_rows, n_param_rows, with_pp, dim)
_FAMILIES = {
    "sphere3d": (4, 3, 4, True, 3),
    "plane3d": (3, 3, 6, False, 3),
    "line3d": (2, 3, 6, True, 3),
    "line2d": (2, 2, 4, False, 2),
}

# Cells of one plain-version chunk: bounds its [vote_cols, chunk] temporaries.
_PLAIN_CELLS = 1 << 25


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


def draw_slot_perms(n: int, k_slots: int, generator=None, device="cpu"):
    """The ``4 * k_slots`` random permutations of ``range(n)`` that
    :func:`slot_planes` takes, drawn from ``generator`` -> int64 ``[4k, n]``."""
    gdev = generator_device(generator, device)
    return torch.stack([
        torch.randperm(n, generator=generator, device=gdev)
        for _ in range(4 * k_slots)
    ]).to(device)


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


def supports_data(family: str, data) -> bool:
    """True if the fused sweep covers this (family, data) pair."""
    if family not in _FAMILIES:
        return False
    k_slots, dim = _FAMILIES[family][0], _FAMILIES[family][4]
    if getattr(data, "ndim", 0) != 2 or data.shape[1] != dim:
        return False
    try:
        fit_size(data.shape[0], k_slots)
    except ValueError:
        return False
    return True


# ---------------------------------------------------------------------------
# The fits that the kernels compute, in plain PyTorch.  Each takes f32 lane
# tensors pts[j][c] (slot j, coordinate c) in its TPU closure's operation
# order; every operation is a separate rounding, as in the CUDA kernels'
# __f*_rn arithmetic, so the two agree bit for bit.
# ---------------------------------------------------------------------------


def _f32(value, like):
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _rsqrt(x):
    """``1 / sqrt(x)`` as two correctly rounded operations (``lax.rsqrt``'s
    value; CUDA's ``rsqrtf`` and ``torch.rsqrt`` on the card are approximate)."""
    return torch.ones_like(x) / torch.sqrt(x)


def sphere3d_fit(pts, delta):
    """Cramer circumsphere + band rows for f32 lane tensors ``pts[j][c]``
    and ``delta`` (a float or an f32 scalar tensor), in the TPU closure's
    exact operation order.

    Returns ``(center [cx, cy, cz], r, degenerate, a_rows[5])``.
    """
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
    cx, cy, cz = center
    d = [pts[0][c] - center[c] for c in range(3)]
    r = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])

    cc = cx * cx + cy * cy + cz * cz
    rp = r + delta
    hi = rp * rp
    lo_root = torch.clamp_min(r - delta, 0.0)
    lo = lo_root * lo_root
    width = torch.clamp_min(hi - lo, 1e-30)
    zero, two = torch.zeros_like(r), torch.full_like(r, 2.0)
    w = torch.where(degenerate, zero, 2.0 / width)
    o = torch.where(degenerate, two, -(hi + lo) / width)
    a_rows = [w * (-2.0 * cx), w * (-2.0 * cy), w * (-2.0 * cz), w * cc + o, w]
    return center, r, degenerate, a_rows


def _signed_band(n_rows, d_off, degenerate, delta):
    """Band rows ``[w n, o, w]`` of ``|(n.p - d_off) / delta| < 1``:
    degenerate lanes get ``w = 0, o = 2`` (they never agree)."""
    inv_delta = _f32(1.0 / float(delta), d_off)
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
    degenerate = norm2 < _f32(_NORM2_EPS, norm2)
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
    degenerate = dist2 < _f32(float(delta) * float(delta), dist2)
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
    degenerate = dist2 < _f32(float(delta) * float(delta), dist2)
    inv = _rsqrt(torch.where(degenerate, torch.ones_like(dist2), dist2))
    params = [d[c] * inv for c in range(3)] + list(a)
    return params, degenerate, params


def _sphere3d_rows(pts, delta):
    center, r, degenerate, a_rows = sphere3d_fit(pts, _f32(float(delta), pts[0][0]))
    return center + [r], degenerate, a_rows


_FITS = {
    "sphere3d": _sphere3d_rows,
    "plane3d": plane3d_fit,
    "line3d": line3d_fit,
    "line2d": line2d_fit,
}


def _band_vote(p_vote, rows, delta):
    """``#{columns: |P^T A| < 1}`` per hypothesis (one product)."""
    return ((p_vote.T @ torch.stack(rows)).abs() < 1.0).sum(dim=0)


def _line3d_vote(p_vote, rows, delta):
    """``#{live columns: |v|^2 - (u.v)^2 < delta^2}``, ``v = p - a``, in
    the kernel's per-cell order (no product, no fused multiply-add)."""
    u0, u1, u2, a0, a1, a2 = rows
    x, y, z = (p_vote[c][:, None] for c in range(3))
    v0, v1, v2 = x - a0, y - a1, z - a2
    e1 = u0 * v0 + u1 * v1 + u2 * v2
    e2 = v0 * v0 + v1 * v1 + v2 * v2
    dist2 = e2 - e1 * e1
    live = (p_vote[3] != 0)[:, None]
    inside = (dist2 < _f32(float(delta) * float(delta), dist2)) & live
    return inside.sum(dim=0)


_VOTES = {
    "sphere3d": _band_vote,
    "plane3d": _band_vote,
    "line3d": _line3d_vote,
    "line2d": _band_vote,
}


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
    if p.ndim != 2 or p.shape[0] != feat_rows + 2:
        raise ValueError(f"p must be [{feat_rows + 2}, n_pad], got {tuple(p.shape)}")
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
    the best: the highest count, ties to the lowest ``h``.
    """
    m, b, mask = _sweep_args(family, coords, p, n_fit, num_groups, vote_cols)
    k_slots, feat_rows = _FAMILIES[family][:2]
    dev = coords.device
    coords = coords.to(torch.float32)
    p_vote = p[:, :vote_cols].to(torch.float32)
    lanes = torch.arange(n_fit, device=dev)
    gchunk = max(1, _PLAIN_CELLS // (n_fit * vote_cols))
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
    input, and when the build or the launch fails."""
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
    delta = float(delta)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if family == "sphere3d":
            consts = (ctypes.c_float(delta),)
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
    delta: float = 1.0,
    groups_per_step: int = 1,
    vote_subsample: int = 0,
    *,
    perms=None,
    vote_perm=None,
    device=None,
):
    """Run a whole fused sweep -> ``(best_count int32[], best_params
    f32[n_param_rows])`` in the family's parameter order (sphere ``[c, r]``,
    plane ``[n, s0]``, line3d ``[u, a]``, line2d ``[nx, ny, x0, y0]``).

    ``data``: ``[n, dim]`` points (numpy goes to ``device``, default CUDA; a
    tensor stays on its device).  ``groups_per_step`` keeps the JAX
    package's set of evaluated groups, ``ceil(total_groups / gps) * gps``.
    ``vote_subsample`` (a multiple of 128, ``<= n``) ranks on the first
    ``vote_subsample`` columns of a random observation order, so the count
    returned is the winner's subsample count; 0 = exact full vote.

    Randomness comes from ``generator``, or explicitly: ``perms`` are the
    ``4 * k_slots`` slot-plane permutations of ``range(fit_size(n))`` and
    ``vote_perm`` the subsample permutation of ``range(n)``.
    """
    if family not in _FAMILIES:
        raise ValueError(f"fused family {family!r} is not ported")
    pts = as_tensor(data, device)
    coords, p, n_fit, vote_cols = sweep_inputs(
        family, pts, generator, vote_subsample, perms=perms, vote_perm=vote_perm
    )
    num_groups = -(-total_groups // groups_per_step) * groups_per_step
    count, params, _index = sweep(family, coords, p, n_fit, num_groups, vote_cols, float(delta))
    return count, params


def sweep_inputs(family: str, pts, generator=None, vote_subsample: int = 0,
                 *, perms=None, vote_perm=None):
    """Host side of :func:`fused_sweep` -> ``(coords, p, n_fit, vote_cols)``:
    the slot planes, the packed (optionally subsample-permuted) feature rows
    and the sizes the kernel takes."""
    k_slots, _, _, with_pp, _ = _FAMILIES[family]
    n = pts.shape[0]
    n_fit = fit_size(n, k_slots)
    if vote_subsample:
        if vote_subsample % 128 or not 0 < vote_subsample <= n:
            raise ValueError("vote_subsample must be a multiple of 128 in (0, n]")
        if vote_perm is None:
            vote_perm = torch.randperm(
                n, generator=generator, device=generator_device(generator, pts.device)
            )
        vote_perm = as_tensor(vote_perm, pts.device, torch.int64)
        p = pack_feature_rows(pts[vote_perm], with_pp)
        vote_cols = vote_subsample
    else:
        p = pack_feature_rows(pts, with_pp)
        vote_cols = p.shape[1]
    if perms is None:
        perms = draw_slot_perms(n_fit, k_slots, generator, pts.device)
    coords = slot_planes(_pad_features(pts.to(torch.float32), n_fit), perms, k_slots)
    return coords, p, n_fit, vote_cols


def reference_samples(family: str, data, perms, total_groups: int):
    """Plain reconstruction of the sweep's hypothesis set (tests):
    ``[total_groups * n_fit, k_slots, feat_rows]`` samples, the engine's
    ``[B, k, d]`` layout."""
    k_slots, feat_rows = _FAMILIES[family][:2]
    n = fit_size(data.shape[0], k_slots)
    m, b, mask = sweep_static(n, k_slots)
    planes = slot_planes(_pad_features(data.to(torch.float32), n), perms, k_slots)
    slots = []
    for j in range(k_slots):
        segs = []
        for g in range(total_groups):
            s = int(shift_units(g, j, b, m, mask)) * 128
            segs.append(planes[feat_rows * j : feat_rows * (j + 1), s : s + n])
        slots.append(torch.cat(segs, dim=1))          # [F, B]
    return torch.stack(slots, dim=0).permute(2, 0, 1)  # [B, k, F]
