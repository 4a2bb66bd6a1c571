"""The f64 structured sphere sweep on lanes (counterpart of
``lsqrrecipes_tpu/ops/planar_points.py``), the generic engine's throughput
driver.

``groups * n`` hypotheses, the same sets as the engine's
``structured_samples`` (one permutation, the static shift table), built as
circular shifts of a ``[3, n]`` plane; the reference's equal-radius Cramer
circumsphere (``SphereParametersEstimator.hxx:80-163``, ``|det| <
SPHERE_EPS`` gate) as lane arithmetic on ``[B]`` vectors; and the
estimator's ``agree`` semantics (``| ||p - c|| - r | < delta``) as the
equivalent squared band ``max(r - delta, 0)^2 < d2 < (r + delta)^2`` with
``d2 = |p|^2 - 2 c.p + |c|^2``, in one of two votes:

  * ``vote="f64"``: the band in float64, the parity oracle (the estimator's
    f64 vote, bit for bit);
  * ``vote="ds"``: certified double-single arithmetic on float32 pairs
    (exact splits of the f64 values, Dekker products, TwoSum sums), which
    decides every cell as real arithmetic over the f64 inputs does except
    within ~2^-45 * scale of a band edge, and so counts as the f64 vote does
    on any data that puts no point there (exactly representable data has no
    rounding at all).

Both run as stock PyTorch operations, as in the JAX package (no kernel).
"""

import torch

from lsqrrecipes_tpu_torch.config import SPHERE_EPS
from lsqrrecipes_tpu_torch.device import as_tensor, generator_device
from lsqrrecipes_tpu_torch.ransac.sampling import structured_shift_table

_F32 = torch.float32
_SPLIT = 4097.0  # 2^12 + 1 (Dekker)


def _pair_of_f64(x):
    """Exact f64 -> (hi, lo) f32 pair: hi = fl32(x), lo = fl32(x - hi)."""
    hi = x.to(_F32)
    return hi, (x - hi.to(x.dtype)).to(_F32)


def _dekker(x):
    """Exact 12-bit split of an f32: x = hi + lo, products of the his exact."""
    t = x * _SPLIT
    hi = t - (t - x)
    return hi, x - hi


def _two_sum(a, b):
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def _ds_point_pack(points):
    """Point-side DS operands, once per sweep: the pair splits and Dekker
    sub-splits of each coordinate and the ``|p|^2`` pair."""
    ph, pl, phh, phl = [], [], [], []
    for d in range(3):
        hi, lo = _pair_of_f64(points[:, d])
        ph.append(hi)
        pl.append(lo)
        hh, hl = _dekker(hi)
        phh.append(hh)
        phl.append(hl)
    p2h, p2l = _pair_of_f64(torch.sum(points * points, dim=-1))
    return ph, pl, phh, phl, p2h, p2l


def _ds_vote_counts(point_pack, c_bt, r, delta):
    """Certified double-single band vote: int32 counts ``[B]`` of
    ``|dist - r| < delta``, every cell's arithmetic native f32 on exact
    pairs (see the module docstring).  ``point_pack`` from
    :func:`_ds_point_pack`."""
    ph, pl, phh, phl, p2h, p2l = point_pack
    ch, cl, chh, chl = [], [], [], []
    for d in range(3):
        hi, lo = _pair_of_f64(c_bt[:, d])
        ch.append(hi)
        cl.append(lo)
        hh, hl = _dekker(hi)
        chh.append(hh)
        chl.append(hl)

    # Per-hypothesis f64 combinations, split once: q_hi = c2 - hi2 and
    # q_lo = c2 - lo2 (their f64 rounding is part of the inputs).
    c2 = torch.sum(c_bt * c_bt, dim=-1)
    rp = r + delta
    rm = r - delta
    qh_hi, qh_lo = _pair_of_f64(c2 - rp * rp)
    ql_hi, ql_lo = _pair_of_f64(c2 - rm * rm)

    # c.p as a pair over the 3 coordinates: exact products, TwoSum sums.
    s = e = None
    for d in range(3):
        prod = ch[d][:, None] * ph[d][None, :]
        err = (
            (chh[d][:, None] * phh[d][None, :] - prod)
            + chh[d][:, None] * phl[d][None, :]
            + chl[d][:, None] * phh[d][None, :]
        ) + chl[d][:, None] * phl[d][None, :]
        cross = ch[d][:, None] * pl[d][None, :] + cl[d][:, None] * ph[d][None, :]
        if s is None:
            s, e = prod, err + cross
        else:
            s, t = _two_sum(s, prod)
            e = e + (t + err + cross)

    # d2 - bound = p2 - 2 c.p + (c2 - bound): the his by TwoSum, the los
    # (all ~2^-24 of the his) summed plainly.
    m2s = -2.0 * s                                 # exact (a power of 2)
    m2e = -2.0 * e
    u, ue = _two_sum(p2h[None, :], m2s)
    v, ve = _two_sum(u, qh_hi[:, None])
    lt_hi = (v + (ue + ve + (p2l[None, :] + m2e + qh_lo[:, None]))) < 0.0
    v2, v2e = _two_sum(u, ql_hi[:, None])
    gt_lo = (v2 + (ue + v2e + (p2l[None, :] + m2e + ql_lo[:, None]))) > 0.0
    # The lower edge vanishes when r < delta; at r == delta, q_lo == c2 and
    # the same comparison is exactly the strict d2 > 0 test.
    gt_lo = gt_lo | ~(rm >= 0.0)[:, None]
    return torch.sum(lt_hi & gt_lo, dim=-1, dtype=torch.int32)


def _f64_vote_counts(points, p2, c_bt, c2, r, delta):
    """The squared band in the points' dtype (the parity oracle) -> int32
    counts ``[B]``."""
    d2 = p2[None, :] - 2.0 * (c_bt @ points.T) + c2[:, None]
    rp = r + delta
    rm = r - delta
    hi2 = rp * rp
    lo2 = torch.where(rm >= 0.0, rm * rm, -torch.inf)
    return torch.sum((d2 < hi2[:, None]) & (d2 > lo2[:, None]), dim=-1, dtype=torch.int32)


def _slot_planes(points_t, table, groups, j):
    """Slot j of every group: ``points_t`` rolled left by ``table[g][j]``,
    the groups side by side -> ``[3, groups * n]``."""
    segs = [torch.roll(points_t, -int(table[g][j]), dims=1) for g in range(groups)]
    return segs[0] if groups == 1 else torch.cat(segs, dim=1)


def _permutation(generator, n, dev, perm):
    if perm is None:
        perm = torch.randperm(n, generator=generator, device=generator_device(generator, dev))
    return as_tensor(perm, dev, torch.int64)


def sphere3d_planar_sweep(points, generator, groups: int, delta: float, chunk: int = 0,
                          vote: str = "ds", *, perm=None, device=None):
    """``groups * n`` structured hypotheses -> ``(counts int32[B], params
    [B, 4])`` in the points' dtype (float64 for the reference's semantics).

    The hypothesis sets of ``structured_samples(generator, points, 4,
    groups)`` for the same permutation (``perm``, or drawn from
    ``generator``); degenerate fits count -1.  ``chunk`` bounds the ``[chunk,
    n]`` vote temporaries (0 = the whole batch at once; else it must divide
    B).  ``vote``: ``"ds"`` (certified double-single, the default) or
    ``"f64"`` (the parity oracle).  Numpy points go to ``device`` (default
    CUDA), a tensor stays on its device.
    """
    if vote not in ("ds", "f64"):
        raise ValueError(f"vote must be 'ds' or 'f64', got {vote!r}")
    points = as_tensor(points, device)
    n, d = points.shape
    if d != 3:
        raise ValueError(f"points must be [n, 3], got {tuple(points.shape)}")
    pts_t = points[_permutation(generator, n, points.device, perm)].T
    table = structured_shift_table(n, 4, groups)
    q0, q1, q2, q3 = (_slot_planes(pts_t, table, groups, j) for j in range(4))

    # Equal-radius system rows m_i = q0 - q_(i+1) ([3, B] each), rhs_i =
    # m_i . (q0 + q_(i+1)); centre = adj(M) rhs / (2 det M).
    rest = (q1, q2, q3)
    m = [q0 - q for q in rest]
    rhs = [torch.sum(mi * (q0 + qi), dim=0) for mi, qi in zip(m, rest)]

    def cof(r1, r2, c1, c2):
        return m[r1][c1] * m[r2][c2] - m[r1][c2] * m[r2][c1]

    adj = [[cof((j + 1) % 3, (j + 2) % 3, (i + 1) % 3, (i + 2) % 3)
            for j in range(3)] for i in range(3)]      # adj[i][j] = cofactor(j, i)
    det = m[0][0] * adj[0][0] + m[0][1] * adj[1][0] + m[0][2] * adj[2][0]
    valid = det.abs() >= SPHERE_EPS
    inv2det = 0.5 / torch.where(valid, det, torch.ones_like(det))
    center = torch.stack([(adj[i][0] * rhs[0] + adj[i][1] * rhs[1] + adj[i][2] * rhs[2])
                          * inv2det for i in range(3)])  # [3, B]
    r = torch.sqrt(torch.sum((q0 - center) ** 2, dim=0))

    b = center.shape[1]
    c_bt = center.T
    c2 = torch.sum(c_bt * c_bt, dim=-1)
    if vote == "ds":
        pack = _ds_point_pack(points)     # once per sweep, shared by chunks

        def vote_fn(c_blk, c2_blk, r_blk):
            # The DS vote forms c2 in pairs from the exact f64 centre.
            return _ds_vote_counts(pack, c_blk, r_blk, delta)
    else:
        p2 = torch.sum(points * points, dim=-1)

        def vote_fn(c_blk, c2_blk, r_blk):
            return _f64_vote_counts(points, p2, c_blk, c2_blk, r_blk, delta)

    if chunk and chunk < b:
        if b % chunk:
            raise ValueError(f"chunk {chunk} does not divide {b} hypotheses")
        counts = torch.cat([vote_fn(c_bt[i : i + chunk], c2[i : i + chunk], r[i : i + chunk])
                            for i in range(0, b, chunk)])
    else:
        counts = vote_fn(c_bt, c2, r)
    counts = torch.where(valid, counts, torch.full_like(counts, -1))
    return counts, torch.cat([c_bt, r[:, None]], dim=1)


def planar_samples_reference(points, generator, groups: int, *, perm=None, device=None):
    """The hypothesis set of :func:`sphere3d_planar_sweep` in the engine's
    ``[B, k, d]`` sample layout (tests)."""
    points = as_tensor(points, device)
    n = points.shape[0]
    pts = points[_permutation(generator, n, points.device, perm)]
    table = structured_shift_table(n, 4, groups)
    rows = []
    for g in range(groups):
        slot = [torch.roll(pts, -int(table[g][j]), dims=0) for j in range(4)]
        rows.append(torch.stack(slot, dim=1))           # [n, 4, 3]
    return torch.cat(rows, dim=0)
