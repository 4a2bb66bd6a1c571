"""Per-step sphere RANSAC (counterpart of ``lsqrrecipes_tpu/ops/sphere_ransac.py``).

Two fit-and-vote kernels with their host side:

  * the planar fit-and-vote (:func:`sphere_fit_and_vote_planar`) takes an
    already sampled ``sxyz[12, B]`` plane (rows ``[x0..x3, y0..y3, z0..z3]``,
    built by :func:`planar_sphere_samples` from one permutation and the
    structured shift table), fits each column's circumsphere and counts the
    points with ``lo <= |p - c|^2 < hi`` (``hi = (r + delta)^2``, ``lo =
    max(r - delta, 0)^2``) as two bounds on ``|p'|^2 - 2 c'.p'``, three
    fused multiply-adds; degenerate lanes are pushed out by a 1e30 shift;
  * the per-step sweep (:func:`megakernel_call`) samples inside the kernel:
    hypothesis ``(g, i)`` takes slot ``j`` from column ``shifts[g, j] + i``
    of the doubled slot planes ``coords2[12, 2n]`` (four permutations, one per
    slot, each written twice), fits it and counts ``|e| < 1`` for the K = 5
    affine band ``e = w |p - c|^2 + o`` (``w = 0, o = 2`` on degenerate
    lanes), evaluated as four fused multiply-adds.
    :func:`fast_sphere_ransac_sweep` launches it once per step on a distinct
    slice of one ``steps * groups`` table of 128-aligned shift quadruples
    (:func:`mega_group_shifts`) and keeps the running best on the device.

Both expand ``|p - c|^2`` about the packed points' column 0 (``p - c0``,
``c - c0``), not the origin, so that a cloud far from the origin keeps its
band (:func:`~lsqrrecipes_tpu_torch.ops.vote.centre`); the fits are not
centred.  Both return ``counts int32[B]`` and ``params_t f32[8, B]``
(``[cx, cy, cz, r, degenerate, 0, 0, 0]``).  On CUDA tensors they launch the hand-written
kernels (``csrc/sphere_ransac.cu``); on CPU tensors they run the plain
versions, which repeat the kernels' arithmetic operation by operation (the
FMAs through :func:`~lsqrrecipes_tpu_torch.linalg.small.fma_f32`, the exact
float32 FMA).
"""

import ctypes
import functools

import numpy as np
import torch

from lsqrrecipes_tpu_torch import kernels
from lsqrrecipes_tpu_torch.device import as_tensor, generator_device
from lsqrrecipes_tpu_torch.linalg.small import scalar_like
from lsqrrecipes_tpu_torch.ops.fused_sweep import (
    circumsphere,
    sphere3d_fit,
    sphere_band_e,
    sphere_band_rows,
)
from lsqrrecipes_tpu_torch.ops.vote import _sum_sq_rows, centre, sq_minus_2cp
from lsqrrecipes_tpu_torch.ransac.sampling import structured_shift_table

_BIG = 1e30          # degenerate lanes' shift of the upper bound
# Cells of one plain-version chunk: bounds its [chunk, n_pad] temporaries.
_PLAIN_CELLS = 1 << 24


def group_shifts(groups: int, k: int, n: int):
    """Static per-group distinct nonzero shifts: slots 1..k-1 of
    :func:`~lsqrrecipes_tpu_torch.ransac.sampling.structured_shift_table`
    (slot 0 is unshifted) -> int64 ``[groups, k - 1]``."""
    return structured_shift_table(n, k, groups)[:, 1:]


def planar_sphere_samples(generator, points, groups: int, *, perm=None, device=None):
    """``points[n, 3] -> sxyz[12, groups * n]`` float32, rows ``[x0, x1, x2,
    x3, y0, ..., z3]``: slot j of hypothesis ``(g, i)`` is ``perm[(i +
    s_gj) % n]`` with the shifts of :func:`group_shifts` (slot 0 unshifted),
    the hypothesis set of ``structured_samples``.  ``perm`` (a permutation of
    ``range(n)``) is drawn from ``generator`` when not given."""
    points = as_tensor(points, device)
    n = points.shape[0]
    dev = points.device
    if perm is None:
        perm = torch.randperm(n, generator=generator, device=generator_device(generator, dev))
    perm = as_tensor(perm, dev, torch.int64)
    p = points.to(torch.float32)[perm]
    table = torch.as_tensor(structured_shift_table(n, 4, groups), device=dev)
    idx = (torch.arange(n, device=dev)[None, :, None] + table[:, None, :]) % n  # [G, n, 4]
    slots = p[idx.reshape(-1, 4)]                                             # [B, 4, 3]
    return slots.permute(2, 1, 0).reshape(12, groups * n).contiguous()


def _check_points(points_t, valid):
    if points_t.ndim != 2 or points_t.shape[0] != 3:
        raise ValueError(f"points_t must be [3, n_pad], got {tuple(points_t.shape)}")
    if valid.shape != (1, points_t.shape[1]):
        raise ValueError(f"valid must be [1, {points_t.shape[1]}], got {tuple(valid.shape)}")


def _check_planar_args(sxyz, points_t, valid):
    if sxyz.ndim != 2 or sxyz.shape[0] != 12:
        raise ValueError(f"sxyz must be [12, B], got {tuple(sxyz.shape)}")
    _check_points(points_t, valid)
    if len({sxyz.device, points_t.device, valid.device}) != 1:
        raise ValueError("sxyz, points_t and valid lie on different devices")


def _params_rows(center, r, degenerate):
    """``params_t [8, B]``: ``[cx, cy, cz, r, degenerate, 0, 0, 0]``."""
    zero = torch.zeros_like(r)
    return torch.stack(center + [r, degenerate.to(r.dtype), zero, zero, zero])


def _plain_points(points_t, valid):
    """``(c0, x', y', z', |p'|^2, live)``: the votes' centre ``c0`` (column 0,
    :func:`~lsqrrecipes_tpu_torch.ops.vote.centre`, as three f32 scalars)
    and the packed points' rows relative to it, f32."""
    c0 = centre(points_t)
    rel = points_t.to(torch.float32) - c0
    return c0[:, 0], rel[0], rel[1], rel[2], _sum_sq_rows(rel), valid[0] != 0


def sphere_fit_and_vote_planar_plain(sxyz, points_t, valid, delta):
    """Plain PyTorch version of the planar fit-and-vote kernel: ``(counts
    int32[B], params_t f32[8, B])``, the kernel's arithmetic operation by
    operation: points and centres relative to the packed points' column 0,
    ``c0`` (``p' = p - c0``, ``c' = c - c0``), ``t = fma(-2c'z, z',
    fma(-2c'y, y', fma(-2c'x, x', |p'|^2)))`` with each FMA rounded once as
    on the card (:func:`~lsqrrecipes_tpu_torch.ops.vote.sq_minus_2cp`), agree
    iff ``t < (hi - |c'|^2) - 1e30 deg`` and ``t >= lo - |c'|^2`` on valid
    columns: the negations of ``(|c'|^2 - hi) + 1e30 deg`` and ``|c'|^2 -
    lo`` bit for bit, so for finite values the JAX kernel's ``(s + a) +
    |p'|^2 < 0`` and ``>= 0`` with ``s = -2c'.p'`` unfused."""
    _check_planar_args(sxyz, points_t, valid)
    sxyz = sxyz.to(torch.float32)
    c0, x, y, z, pp, live = _plain_points(points_t, valid)
    delta = scalar_like(float(delta), x)
    big, zero = scalar_like(_BIG, x), scalar_like(0.0, x)
    b = sxyz.shape[1]
    chunk = max(1, _PLAIN_CELLS // max(1, x.shape[0]))
    counts, params = [torch.zeros((0,), dtype=torch.int32, device=x.device)], []
    for b0 in range(0, b, chunk):
        rows = sxyz[:, b0 : b0 + chunk]
        center, r, degenerate = circumsphere([[rows[4 * c + j] for c in range(3)]
                                              for j in range(4)])
        cx, cy, cz = (center[k] - c0[k] for k in range(3))
        cc = cx * cx + cy * cy + cz * cz
        rp = r + delta
        hi = rp * rp
        lo_root = torch.clamp_min(r - delta, 0.0)
        lo = lo_root * lo_root
        upper = ((hi - cc) - torch.where(degenerate, big, zero))[:, None]
        lower = (lo - cc)[:, None]
        t = sq_minus_2cp((-2.0 * cx)[:, None], (-2.0 * cy)[:, None], (-2.0 * cz)[:, None],
                         x, y, z, pp)
        agree = (t < upper) & (t >= lower) & live
        counts.append(agree.sum(dim=1, dtype=torch.int32))
        params.append(_params_rows(center, r, degenerate))
    params_t = torch.cat(params, dim=1) if params else sxyz.new_zeros((8, 0))
    return torch.cat(counts), params_t


def sphere_fit_and_vote_planar_cuda(sxyz, points_t, valid, delta):
    """Launch the planar fit-and-vote kernel (``csrc/sphere_ransac.cu``) on
    the current stream; same contract as
    :func:`sphere_fit_and_vote_planar_plain`.  Raises on a non-CUDA, non-f32,
    non-contiguous or misshapen input, and when the build or the launch
    fails."""
    _check_planar_args(sxyz, points_t, valid)
    kernels.check_inputs(sxyz=sxyz, points_t=points_t, valid=valid)
    b, n_pad = sxyz.shape[1], points_t.shape[1]
    if b >= 2**31 or n_pad >= 2**31:
        raise ValueError("the planar fit-and-vote supports fewer than 2^31 hypotheses and points")
    counts = torch.empty((b,), dtype=torch.int32, device=sxyz.device)
    params_t = torch.empty((8, b), dtype=torch.float32, device=sxyz.device)
    if b:
        with torch.cuda.device(sxyz.device):
            kernels.SPHERE_PLANAR_VOTE.launch(
                sxyz.data_ptr(), points_t.data_ptr(), valid.data_ptr(), b, n_pad,
                ctypes.c_float(float(delta)), counts.data_ptr(), params_t.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            )
    return counts, params_t


def sphere_fit_and_vote_planar(sxyz, points_t, valid, delta, *, device=None):
    """``sxyz[12, B] -> (counts int32[B], params_t f32[8, B])``.

    ``params_t`` rows 0-3 are ``[cx, cy, cz, r]``; extract the winner with
    ``params_t[:4, best]``.  Degenerate (near-coplanar) samples count 0.
    ``points_t``/``valid`` from :func:`~lsqrrecipes_tpu_torch.ops.vote.pack_points`.
    Numpy ``sxyz`` goes to ``device`` (default CUDA), a tensor stays on its
    device and the points follow it.  On CUDA this launches the kernel (any
    B), on the CPU it runs :func:`sphere_fit_and_vote_planar_plain`.
    """
    sxyz = as_tensor(sxyz, device, torch.float32)
    points_t = as_tensor(points_t, sxyz.device, torch.float32)
    valid = as_tensor(valid, sxyz.device, torch.float32)
    if sxyz.is_cuda:
        return sphere_fit_and_vote_planar_cuda(sxyz.contiguous(), points_t.contiguous(),
                                               valid.contiguous(), delta)
    return sphere_fit_and_vote_planar_plain(sxyz, points_t, valid, delta)


def mega_group_shifts(groups: int, n: int, seed: int = 987654321):
    """Static per-group slot-shift quadruples, all multiples of 128 in
    ``[0, n)`` -> int64 ``[groups, 4]``, distinct while the pool of
    ``(n / 128)^4`` lasts.  The same ``default_rng(seed + n)`` draws as the
    JAX package, so both give identical tables; callers that want distinct
    hypothesis sets across steps ask for ``steps * groups`` and slice.  The
    draws are a pure function of the arguments and take about a second at
    the bench's 12,800 groups on the host, so tables are cached (the JAX
    package draws them once per trace)."""
    return _mega_table(int(groups), int(n), int(seed)).copy()


@functools.lru_cache(maxsize=16)
def _mega_table(groups, n, seed):
    options = np.arange(0, n, 128)
    rng = np.random.default_rng(seed + n)
    combos = set()
    shifts = np.zeros((groups, 4), dtype=np.int64)
    g = 0
    while g < groups:
        c = tuple(rng.choice(options, size=4))
        if c in combos:
            if len(combos) >= len(options) ** 4:
                combos.clear()  # exhausted: allow repeats
            continue
        combos.add(c)
        shifts[g] = c
        g += 1
    shifts.flags.writeable = False
    return shifts


def _slot_planes(points, generator, n, perms=None):
    """Four independent permutations -> doubled coordinate planes
    ``[12, 2n]`` f32 (rows ``3j + c``).  ``perms`` (``[4, n]``) are drawn
    from ``generator`` when not given."""
    dev = points.device
    if perms is None:
        gdev = generator_device(generator, dev)
        perms = [torch.randperm(n, generator=generator, device=gdev) for _ in range(4)]
    pts32 = points.to(torch.float32)
    rows = []
    for j in range(4):
        p = pts32[as_tensor(perms[j], dev, torch.int64)].T     # [3, n]
        rows.append(torch.cat([p, p], dim=1))                  # [3, 2n]
    return torch.cat(rows, dim=0)


def _check_mega_args(shifts, coords2, points_t, valid):
    if shifts.ndim != 2 or shifts.shape[1] != 4:
        raise ValueError(f"shifts must be [G, 4], got {tuple(shifts.shape)}")
    if coords2.ndim != 2 or coords2.shape[0] != 12 or coords2.shape[1] % 2:
        raise ValueError(f"coords2 must be [12, 2n], got {tuple(coords2.shape)}")
    _check_points(points_t, valid)
    if len({shifts.device, coords2.device, points_t.device, valid.device}) != 1:
        raise ValueError("shifts, coords2, points_t and valid lie on different devices")
    n = coords2.shape[1] // 2
    if shifts.shape[0] * n >= 2**31:
        raise ValueError("the per-step sweep supports fewer than 2^31 hypotheses")
    return n


def megakernel_call_plain(shifts, coords2, points_t, valid, delta):
    """Plain PyTorch version of the per-step sweep kernel: ``(counts
    int32[G n], params_t f32[8, G n])`` for the hypotheses ``h = g n + i``,
    the kernel's arithmetic operation by operation (``e = fma(a4, |p'|^2,
    fma(a2, z', fma(a1, y', fma(a0, x', a3))))`` on the points relative to
    their column 0 with the band rows about it, each FMA rounded once as on
    the card, valid columns only)."""
    n = _check_mega_args(shifts, coords2, points_t, valid)
    coords2 = coords2.to(torch.float32)
    c0, x, y, z, pp, live = _plain_points(points_t, valid)
    delta = scalar_like(float(delta), x)
    lanes = torch.arange(n, device=x.device)
    gchunk = max(1, _PLAIN_CELLS // (n * max(1, x.shape[0])))
    counts, params = [torch.zeros((0,), dtype=torch.int32, device=x.device)], []
    for g0 in range(0, shifts.shape[0], gchunk):
        sh = shifts[g0 : g0 + gchunk].to(torch.int64)
        pts = []
        for j in range(4):
            cols = (sh[:, j : j + 1] + lanes[None, :]).reshape(-1)
            pts.append([coords2[3 * j + c][cols] for c in range(3)])
        center, r, degenerate, scale = sphere3d_fit(pts, delta)
        a = sphere_band_rows(center, scale, c0)
        e = sphere_band_e([row[:, None] for row in a], x, y, z, pp)
        counts.append(((e.abs() < 1.0) & live).sum(dim=1, dtype=torch.int32))
        params.append(_params_rows(center, r, degenerate))
    params_t = torch.cat(params, dim=1) if params else coords2.new_zeros((8, 0))
    return torch.cat(counts), params_t


def _mega_launch(shifts, coords2, points_t, valid, delta):
    """The kernel launch on checked inputs (``shifts`` int32, each in
    ``[0, n]``)."""
    n = coords2.shape[1] // 2
    b = shifts.shape[0] * n
    counts = torch.empty((b,), dtype=torch.int32, device=coords2.device)
    params_t = torch.empty((8, b), dtype=torch.float32, device=coords2.device)
    if b:
        with torch.cuda.device(coords2.device):
            kernels.SPHERE_MEGA.launch(
                shifts.data_ptr(), coords2.data_ptr(), points_t.data_ptr(), valid.data_ptr(),
                n, points_t.shape[1], shifts.shape[0], ctypes.c_float(float(delta)),
                counts.data_ptr(), params_t.data_ptr(), torch.cuda.current_stream().cuda_stream,
            )
    return counts, params_t


def _check_mega_cuda(shifts, coords2, points_t, valid):
    _check_mega_args(shifts, coords2, points_t, valid)
    kernels.check_inputs(coords2=coords2, points_t=points_t, valid=valid)
    if shifts.dtype != torch.int32 or not shifts.is_contiguous():
        raise ValueError("shifts must be a contiguous int32 CUDA tensor")


def megakernel_call_cuda(shifts, coords2, points_t, valid, delta):
    """Launch the per-step sweep kernel (``csrc/sphere_ransac.cu``) on the
    current stream; same contract as :func:`megakernel_call_plain`.  Raises
    on a non-CUDA, misshapen or out-of-range input (a shift outside ``[0,
    n]``), and when the build or the launch fails."""
    _check_mega_cuda(shifts, coords2, points_t, valid)
    n = coords2.shape[1] // 2
    if shifts.numel() and not (int(shifts.min()) >= 0 and int(shifts.max()) <= n):
        raise ValueError(f"shifts must lie in [0, {n}]")
    return _mega_launch(shifts, coords2, points_t, valid, delta)


def megakernel_call(shifts, coords2, points_t, valid, delta, *, device=None):
    """``shifts[G, 4], coords2[12, 2n] -> (counts int32[G n], params_t f32[8,
    G n])``: hypothesis ``(g, i)`` takes slot j from column ``shifts[g, j] +
    i`` of rows ``3j .. 3j + 2`` of ``coords2``.  Numpy ``coords2`` goes to
    ``device`` (default CUDA), a tensor stays on its device and the rest
    follows it.  On CUDA this launches the kernel, on the CPU it runs
    :func:`megakernel_call_plain`."""
    coords2 = as_tensor(coords2, device, torch.float32)
    dev = coords2.device
    shifts = as_tensor(shifts, dev, torch.int32)
    points_t = as_tensor(points_t, dev, torch.float32)
    valid = as_tensor(valid, dev, torch.float32)
    if coords2.is_cuda:
        return megakernel_call_cuda(shifts.contiguous(), coords2.contiguous(),
                                    points_t.contiguous(), valid.contiguous(), delta)
    return megakernel_call_plain(shifts, coords2, points_t, valid, delta)


def _call(shifts, coords2, points_t, valid, delta):
    """The per-step kernel (CUDA) or its plain version (CPU) on inputs whose
    shifts come from :func:`mega_group_shifts`, so lie in ``[0, n)``."""
    if coords2.is_cuda:
        _check_mega_cuda(shifts, coords2, points_t, valid)
        return _mega_launch(shifts, coords2, points_t, valid, delta)
    return megakernel_call_plain(shifts, coords2, points_t, valid, delta)


def _winner(counts, params_t):
    """``(count, params_t[:4] column)`` of the highest count, ties to the
    lowest index, selected on the device (no host sync)."""
    best = torch.argmax(counts).reshape(1)
    return counts.index_select(0, best)[0], params_t[:4].index_select(1, best)[:, 0]


def fast_sphere_ransac_step(points, points_t, valid, generator, groups, delta, *,
                            coords2=None, device=None):
    """One per-step sweep: four slot permutations, the kernel over ``groups
    * n`` hypotheses, the winner (ties to the lowest index) ->
    ``(best_count int32[], best_params f32[4])``.  ``n`` must be a multiple of
    128 (else ``ValueError``).  ``coords2`` fixes the slot planes.  The
    one-step case of :func:`fast_sphere_ransac_sweep`."""
    return fast_sphere_ransac_sweep(points, points_t, valid, generator, groups, 1, delta,
                                    coords2=coords2, device=device)


def fast_sphere_ransac_sweep(points, points_t, valid, generator, groups, steps, delta, *,
                             coords2=None, device=None):
    """The whole per-step sweep: four slot permutations drawn once, one
    kernel launch per step on a distinct slice of a ``steps * groups`` shift
    table, ``steps * groups * n`` hypotheses in all.  The running best stays
    on the device (no host sync per step): within a step the argmax (ties
    to the lowest index), across steps a later step replaces the best only
    when strictly greater.  -> ``(best_count int32[], best_params f32[4])``."""
    points = as_tensor(points, device)
    n = points.shape[0]
    if n % 128:
        raise ValueError("the per-step sphere sweep requires n divisible by 128")
    dev = points.device
    points_t = as_tensor(points_t, dev, torch.float32).contiguous()
    valid = as_tensor(valid, dev, torch.float32).contiguous()
    all_shifts = torch.as_tensor(mega_group_shifts(steps * groups, n), dtype=torch.int32,
                                 device=dev).reshape(steps, groups, 4)
    if coords2 is None:
        coords2 = _slot_planes(points, generator, n)
    coords2 = as_tensor(coords2, dev, torch.float32).contiguous()
    count = torch.tensor(-1, dtype=torch.int32, device=dev)
    params = torch.zeros((4,), dtype=torch.float32, device=dev)
    for step in range(steps):
        step_count, step_params = _winner(*_call(all_shifts[step], coords2, points_t, valid,
                                                 delta))
        better = step_count > count
        count = torch.where(better, step_count, count)
        params = torch.where(better, step_params, params)
    return count, params


def reference_mega_samples(points, generator, groups, *, coords2=None, device=None):
    """Plain reconstruction of the per-step sweep's hypothesis set (tests):
    ``[groups * n, 4, 3]`` samples, the engine's layout."""
    points = as_tensor(points, device)
    n = points.shape[0]
    shifts = mega_group_shifts(groups, n)
    if coords2 is None:
        coords2 = _slot_planes(points, generator, n)
    planes = as_tensor(coords2, points.device, torch.float32)
    slots = []
    for j in range(4):
        per_group = [planes[3 * j : 3 * j + 3, int(s) : int(s) + n] for s in shifts[:, j]]
        slots.append(torch.cat(per_group, dim=1))            # [3, B]
    return torch.stack(slots, dim=0).permute(2, 0, 1)        # [B, 4, 3]
