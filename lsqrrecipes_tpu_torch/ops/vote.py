"""Fused RANSAC votes (counterpart of ``lsqrrecipes_tpu/ops/vote.py``:
``pack_points``, ``sphere_vote_counts`` and ``plane_vote_counts``).

Each vote counts inliers for a batch of hypotheses without materialising
the ``[B, n]`` distance matrix: on a CUDA tensor it launches its
hand-written kernel (``csrc/sphere_vote.cu``, ``csrc/plane_vote.cu``); on a
CPU tensor it runs its plain version, the same predicate and arithmetic in
plain PyTorch.
"""

import ctypes

import torch

from lsqrrecipes_tpu_torch import kernels
from lsqrrecipes_tpu_torch.device import as_tensor
from lsqrrecipes_tpu_torch.linalg.small import fma_f32

# Rows of one plain-version chunk: bounds its [chunk, n_pad] temporaries.
_PLAIN_CELLS = 1 << 24


def _round_up(x, m):
    return -(-x // m) * m


def _sum_sq_rows(rows):
    """``sum_k rows[k]^2`` added in row order (the TPU kernel's order)."""
    total = rows[0] * rows[0]
    for k in range(1, rows.shape[0]):
        total = total + rows[k] * rows[k]
    return total


def pack_points(points):
    """``[n, d] -> (points_t[d, n_pad] f32, valid[1, n_pad] f32, n)`` with
    ``n_pad`` the next multiple of 128; padding columns are 0 and invalid."""
    n, d = points.shape
    n_pad = _round_up(n, 128)
    points_t = torch.zeros((d, n_pad), dtype=torch.float32, device=points.device)
    points_t[:, :n] = points.to(torch.float32).T
    valid = torch.zeros((1, n_pad), dtype=torch.float32, device=points.device)
    valid[0, :n] = 1.0
    return points_t, valid, n


def _check_vote_args(params, points_t, valid):
    if params.ndim != 2 or params.shape[1] != 4:
        raise ValueError(f"params must be [B, 4], got {tuple(params.shape)}")
    if points_t.ndim != 2 or points_t.shape[0] != 3:
        raise ValueError(f"points_t must be [3, n_pad], got {tuple(points_t.shape)}")
    if valid.shape != (1, points_t.shape[1]):
        raise ValueError(f"valid must be [1, {points_t.shape[1]}], got {tuple(valid.shape)}")
    devices = {params.device, points_t.device, valid.device}
    if len(devices) != 1:
        raise ValueError(f"params, points_t and valid lie on different devices: {devices}")


def centre(points_t):
    """``f32[3, 1]``: the point the sphere votes are taken about, column 0
    of ``points_t`` (:func:`pack_points` puts a live point there; zeros when
    there is no column).  Expanded about the origin, ``|p|^2 - 2 c.p +
    |c|^2`` cancels: 1e4 from the origin ``ulp(|p|^2)`` is 32, against a
    band of 40 at r = 10, delta = 1.  About a point of the cloud its terms
    scale with the cloud's extent instead."""
    pts = points_t.to(torch.float32)
    if pts.shape[1] == 0:
        return pts.new_zeros((pts.shape[0], 1))
    return pts[:, 0:1]


def sq_minus_2cp(mx, my, mz, x, y, z, pp):
    """``|p'|^2 - 2 c'.p'`` as the sphere votes' three fused multiply-adds,
    ``fma(mz, z', fma(my, y', fma(mx, x', |p'|^2)))`` with ``m = -2c'``, each
    rounded once as CUDA's ``__fmaf_rn``
    (:func:`~lsqrrecipes_tpu_torch.linalg.small.fma_f32`); the hypotheses'
    and the points' rows broadcast together."""
    return fma_f32(mz, z, fma_f32(my, y, fma_f32(mx, x, pp)))


def sphere_vote_counts_plain(params, points_t, valid, delta):
    """Plain PyTorch version of the kernel: ``int32[B]`` counts of valid
    columns with ``lo2 < |p - c|^2 < (r + delta)^2``.

    It repeats the kernel's f32 arithmetic operation by operation, so the
    two give equal counts.  Points and centres are taken relative to
    :func:`centre` ``c0`` (``p' = p - c0``, ``c' = c - c0``, each one f32
    subtraction), ``|p'|^2 = (x'^2 + y'^2) + z'^2``, then ``|p'|^2 - 2
    c'.p'`` as three fused multiply-adds ``fma(-2c'z, z', fma(-2c'y, y',
    fma(-2c'x, x', |p'|^2)))``, each rounded once as CUDA's ``__fmaf_rn``
    (:func:`~lsqrrecipes_tpu_torch.linalg.small.fma_f32`), then ``+
    |c'|^2``; no matrix product.
    """
    _check_vote_args(params, points_t, valid)
    params = params.to(torch.float32)
    c0 = centre(points_t)
    rel = points_t.to(torch.float32) - c0
    pp = _sum_sq_rows(rel)[None, :]
    live = valid.to(torch.float32) != 0
    delta = torch.tensor(delta, dtype=torch.float32, device=params.device)
    chunk = max(1, _PLAIN_CELLS // max(1, rel.shape[1]))
    out = []
    for b0 in range(0, params.shape[0], chunk):
        prm = params[b0 : b0 + chunk]
        c = prm[:, 0:3] - c0.T
        r = prm[:, 3]
        m = -2.0 * c                            # exact
        t = sq_minus_2cp(m[:, 0:1], m[:, 1:2], m[:, 2:3], rel[0], rel[1], rel[2], pp)
        d2 = t + _sum_sq_rows(c.T)[:, None]
        rp = r + delta
        rm = r - delta
        hi2 = (rp * rp)[:, None]
        lo2 = torch.where(rm >= 0.0, rm * rm, -torch.inf)[:, None]
        agree = (d2 < hi2) & (d2 > lo2) & live
        out.append(agree.sum(dim=1, dtype=torch.int32))
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=params.device)
    return torch.cat(out)


def sphere_vote_counts_cuda(params, points_t, valid, delta):
    """Launch ``csrc/sphere_vote.cu`` on the current stream -> ``int32[B]``.

    Raises on a non-CUDA, non-f32, non-contiguous or misshapen input, and
    when the build or the launch fails.
    """
    _check_vote_args(params, points_t, valid)
    kernels.check_inputs(params=params, points_t=points_t, valid=valid)
    b, n_pad = params.shape[0], points_t.shape[1]
    if b >= 2**31 or n_pad >= 2**31:
        raise ValueError("sphere_vote_counts supports fewer than 2^31 hypotheses and points")
    counts = torch.empty((b,), dtype=torch.int32, device=params.device)
    if b == 0:
        return counts
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.SPHERE_VOTE.launch(
            params.data_ptr(), points_t.data_ptr(), valid.data_ptr(),
            n_pad, b, ctypes.c_float(float(delta)), counts.data_ptr(), stream,
        )
    return counts


def sphere_vote_counts(params, points_t, valid, delta, *, device=None):
    """Inlier counts for sphere hypotheses -> ``int32[B]``.

    params: ``[B, 4]`` (center, radius) float32; ``points_t``/``valid`` from
    :func:`pack_points`.  Numpy params go to ``device`` (default CUDA), a
    tensor stays on its device, and the points follow the params.  On CUDA
    this launches the kernel (any B; the TPU kernel's 512-row blocks do not
    apply); on the CPU it runs :func:`sphere_vote_counts_plain`.
    """
    params = as_tensor(params, device)
    points_t = as_tensor(points_t, params.device)
    valid = as_tensor(valid, params.device)
    if params.is_cuda:
        return sphere_vote_counts_cuda(
            params.to(torch.float32).contiguous(), points_t.contiguous(),
            valid.contiguous(), delta,
        )
    return sphere_vote_counts_plain(params, points_t, valid, delta)


def _check_plane_args(params, points_t, valid):
    if points_t.ndim != 2 or points_t.shape[0] not in (2, 3):
        raise ValueError(f"points_t must be [2 or 3, n_pad], got {tuple(points_t.shape)}")
    d = points_t.shape[0]
    if params.ndim != 2 or params.shape[1] != d + 1:
        raise ValueError(f"params must be [B, {d + 1}], got {tuple(params.shape)}")
    if valid.shape != (1, points_t.shape[1]):
        raise ValueError(f"valid must be [1, {points_t.shape[1]}], got {tuple(valid.shape)}")
    devices = {params.device, points_t.device, valid.device}
    if len(devices) != 1:
        raise ValueError(f"params, points_t and valid lie on different devices: {devices}")
    return d


def plane_vote_counts_plain(params, points_t, valid, delta_sq):
    """Plain PyTorch version of the kernel: ``int32[B]`` counts of valid
    columns with ``(n.p - offset)^2 < delta_sq`` for rows ``[n (d), offset]``.

    It repeats the kernel's f32 arithmetic operation by operation (``n.p``
    summed elementwise in coordinate order, no matrix product), so the two
    give equal counts.
    """
    d = _check_plane_args(params, points_t, valid)
    params = params.to(torch.float32)
    pts = points_t.to(torch.float32)
    live = valid.to(torch.float32) != 0
    delta_sq = torch.tensor(delta_sq, dtype=torch.float32, device=params.device)
    chunk = max(1, _PLAIN_CELLS // max(1, pts.shape[1]))
    out = [torch.zeros((0,), dtype=torch.int32, device=params.device)]
    for b0 in range(0, params.shape[0], chunk):
        prm = params[b0 : b0 + chunk]
        s = prm[:, 0:1] * pts[0]
        for c in range(1, d):
            s = s + prm[:, c : c + 1] * pts[c]
        s = s - prm[:, d : d + 1]
        agree = (s * s < delta_sq) & live
        out.append(agree.sum(dim=1, dtype=torch.int32))
    return torch.cat(out)


def plane_vote_counts_cuda(params, points_t, valid, delta_sq):
    """Launch ``csrc/plane_vote.cu`` on the current stream -> ``int32[B]``.

    Raises on a non-CUDA, non-f32, non-contiguous or misshapen input, and
    when the build or the launch fails.
    """
    d = _check_plane_args(params, points_t, valid)
    kernels.check_inputs(params=params, points_t=points_t, valid=valid)
    b, n_pad = params.shape[0], points_t.shape[1]
    if b >= 2**31 or n_pad >= 2**31:
        raise ValueError("plane_vote_counts supports fewer than 2^31 hypotheses and points")
    counts = torch.empty((b,), dtype=torch.int32, device=params.device)
    if b == 0:
        return counts
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernels.PLANE_VOTE.launch(
            params.data_ptr(), points_t.data_ptr(), valid.data_ptr(), d, n_pad, b,
            ctypes.c_float(float(delta_sq)), counts.data_ptr(), stream,
        )
    return counts


def plane_vote_counts(params, points_t, valid, delta_sq, *, device=None):
    """Inlier counts for plane / 2D-line signed-distance hypotheses ->
    ``int32[B]``.

    params: ``[B, d+1]`` rows ``[normal (d), offset]`` with offset = n.a, d
    2 or 3; agree iff ``(n.p - offset)^2 < delta_sq``.  ``points_t``/``valid``
    from :func:`pack_points`.  Numpy params go to ``device`` (default CUDA),
    a tensor stays on its device, and the points follow the params.  On CUDA
    this launches the kernel (any B); on the CPU it runs
    :func:`plane_vote_counts_plain`.
    """
    params = as_tensor(params, device)
    points_t = as_tensor(points_t, params.device)
    valid = as_tensor(valid, params.device)
    if params.is_cuda:
        return plane_vote_counts_cuda(
            params.to(torch.float32).contiguous(), points_t.contiguous(),
            valid.contiguous(), delta_sq,
        )
    return plane_vote_counts_plain(params, points_t, valid, delta_sq)
