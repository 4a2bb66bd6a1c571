"""Closed-form solvers for tiny systems (counterpart of
``lsqrrecipes_tpu/linalg/small.py``: ``solve2``, ``solve3``, the unrolled
Cholesky solves, ``solve_spd``, ``qr_solve_lanes`` and the planar QR pair
``qr_r_planar`` / ``solve_rt_r_planar``).

Pure elementwise tensor arithmetic batched over leading axes, with the same
cofactor arithmetic and operation order as the JAX package; the planar QR
pair follows the operation order of the phantom subspace kernel
(``csrc/phantom_qr.cu``) instead, whose plain version it is built into.
:func:`fma_f32` is CUDA's float32 fused multiply-add, exactly, for the plain
versions of kernels that vote with one.
"""

import torch


def solve2(a, b):
    """Cramer solve of ``a[..., 2, 2] x = b[..., 2]`` -> ``(x, det)``."""
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    safe = torch.where(det == 0, torch.ones_like(det), det)
    x0 = (a[..., 1, 1] * b[..., 0] - a[..., 0, 1] * b[..., 1]) / safe
    x1 = (a[..., 0, 0] * b[..., 1] - a[..., 1, 0] * b[..., 0]) / safe
    return torch.stack([x0, x1], dim=-1), det


def solve3(a, b):
    """Adjugate (Cramer) solve of ``a[..., 3, 3] x = b[..., 3]`` -> ``(x, det)``.

    Same arithmetic as the reference's hand-coded 3D sphere solver
    (``SphereParametersEstimator.hxx:115-163``).
    """
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c10 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c20 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c10 + a[..., 0, 2] * c20

    c01 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c21 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]

    c02 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c12 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]

    safe = torch.where(det == 0, torch.ones_like(det), det)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) / safe
    x1 = (c10 * b0 + c11 * b1 + c12 * b2) / safe
    x2 = (c20 * b0 + c21 * b1 + c22 * b2) / safe
    return torch.stack([x0, x1, x2], dim=-1), det


def cholesky_solve_lanes(a, b, n: int):
    """Unrolled Cholesky solve in LANES form: ``a[i][j]`` and ``b[i]`` are
    lists of same-shaped (typically ``[B]``) tensors, every scalar step its
    own operation, as in the JAX package.  Pivots are floored at the dtype's
    ``tiny``; returns ``(x_list, min_pivot)``."""
    tiny = torch.finfo(b[0].dtype).tiny
    l = [[None] * n for _ in range(n)]
    min_pivot = None
    for j in range(n):
        s = a[j][j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        min_pivot = s if min_pivot is None else torch.minimum(min_pivot, s)
        ljj = torch.sqrt(torch.clamp_min(s, tiny))
        l[j][j] = ljj
        for i in range(j + 1, n):
            t = a[i][j]
            for k in range(j):
                t = t - l[i][k] * l[j][k]
            l[i][j] = t / ljj
    y = [None] * n
    for i in range(n):
        t = b[i]
        for k in range(i):
            t = t - l[i][k] * y[k]
        y[i] = t / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        t = y[i]
        for k in range(i + 1, n):
            t = t - l[k][i] * x[k]
        x[i] = t / l[i][i]
    return x, min_pivot


def cholesky_solve_unrolled(a, b, n: int):
    """Cholesky solve of SPD ``a[..., n, n] x = b[..., n]`` (n static,
    intended n <= ~16), batched over leading axes, with the pivots floored at
    the dtype's ``tiny`` as in :func:`cholesky_solve_lanes`.  Returns ``(x,
    min_pivot)``: ``min_pivot``, the smallest squared diagonal of L, is the
    degeneracy signal (non-SPD inputs give ``min_pivot <= 0``).

    The loops over columns and rows are unrolled; each inner product is one
    ``torch.sum`` over a row of L (some tens of operations for n = 11 where
    the scalar form takes hundreds, which matters on the card, where each is
    a kernel launch), so results equal the lanes form's to rounding."""
    tiny = torch.finfo(a.dtype).tiny
    l = torch.zeros_like(a)
    min_pivot = None
    for j in range(n):
        lj = l[..., j, :j]
        s = a[..., j, j] - torch.sum(lj * lj, dim=-1)
        min_pivot = s if min_pivot is None else torch.minimum(min_pivot, s)
        ljj = torch.sqrt(torch.clamp_min(s, tiny))
        l[..., j, j] = ljj
        if j + 1 < n:
            t = a[..., j + 1 :, j] - torch.sum(l[..., j + 1 :, :j] * lj[..., None, :], dim=-1)
            l[..., j + 1 :, j] = t / ljj[..., None]
    y = torch.zeros_like(b)
    for i in range(n):
        t = b[..., i] - torch.sum(l[..., i, :i] * y[..., :i], dim=-1)
        y[..., i] = t / l[..., i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        t = y[..., i] - torch.sum(l[..., i + 1 :, i] * x[..., i + 1 :], dim=-1)
        x[..., i] = t / l[..., i, i]
    return x, min_pivot


def solve_spd(a, b):
    """SPD solve dispatcher: closed forms for n <= 3, unrolled Cholesky
    beyond.  ``a[..., n, n] x = b[..., n]`` -> ``(x, valid_signal)`` where
    ``valid_signal > 0`` indicates a well-posed system."""
    n = a.shape[-1]
    if n == 1:
        d = a[..., 0, 0]
        return b / torch.where(d == 0, torch.ones_like(d), d)[..., None], d
    if n == 2:
        return solve2(a, b)
    if n == 3:
        return solve3(a, b)
    return cholesky_solve_unrolled(a, b, n)


def scalar_like(value, like):
    """``value`` as a 0-dim tensor of ``like``'s dtype and device.  Dividing
    by it (or by any tensor) is a correctly rounded division on the card
    too, where PyTorch divides by a Python number through its reciprocal;
    the plain versions of the CUDA kernels divide this way to round as
    ``__fdiv_rn`` does."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def fma_f32(a, b, c):
    """``a * b + c`` rounded once to float32, as CUDA's ``__fmaf_rn``:
    float32 tensors (broadcast together) -> float32.

    The product of two float32 values is exact in float64.  The sum ``s = p
    + c`` is rounded in float64 and TwoSum gives its exact error; where the
    error is nonzero and ``s``'s last mantissa bit is even, ``s`` moves one
    ulp toward the error.  That is ``a b + c`` rounded to odd at 53 bits, and
    rounding it to float32 gives the correctly rounded FMA (Boldo and
    Melquiond, 2008: round to odd at p + 2 bits or more, then to nearest).
    Infinities and NaN come out as the FMA's."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(fix, torch.nextafter(s, toward), s).to(torch.float32)


def rsqrt(x):
    """``1 / sqrt(x)`` as two correctly rounded operations (``lax.rsqrt``'s
    value and the kernels' ``rsqrt_rn``; CUDA's ``rsqrtf`` and
    ``torch.rsqrt`` on the card are approximate)."""
    return scalar_like(1.0, x) / torch.sqrt(x)


def qr_solve_lanes(rows, rhs, eps=1e-5):
    """Householder least-squares solve in LANES form.

    ``rows``: list (length R) of lists (length C) of same-shaped tensors (the
    batch, typically ``[B]``) -- the system matrix with every scalar a batch
    tensor; ``rhs``: list of R tensors.  Returns ``(x, ok)`` with ``x`` a
    list of C tensors and ``ok`` a bool tensor, False where a Householder
    pivot collapsed (``norm <= eps``: the rank-deficient case).

    Columns are first scaled to unit norm (``1 / sqrt`` of the sequential
    sum of squares, restored on output) so that the pivot gate is relative.
    Every sum is taken in row order and every product and sum is its own
    rounded operation, so this is the arithmetic of the CUDA sweep kernels'
    ``qr_solve`` (``csrc/fused_sweep_us.cu``) bit for bit, divisions
    included (tensor divisors only).  The lists keep that order explicit:
    an ``[R, C, B]`` tensor with whole-column updates would sum in the
    library's order.
    """
    nr = len(rows)
    nc = len(rows[0])
    a = [[rows[r][c] for c in range(nc)] for r in range(nr)]
    b = list(rhs)
    like = b[0]
    one = scalar_like(1.0, like)
    tiny = torch.finfo(like.dtype).tiny

    inv_scale = []
    for c in range(nc):
        norm2 = a[0][c] * a[0][c]
        for r in range(1, nr):
            norm2 = norm2 + a[r][c] * a[r][c]
        s = rsqrt(torch.clamp_min(norm2, tiny))
        inv_scale.append(s)
        for r in range(nr):
            a[r][c] = a[r][c] * s

    ok = None
    for k in range(nc):
        sigma = a[k][k] * a[k][k]
        for r in range(k + 1, nr):
            sigma = sigma + a[r][k] * a[r][k]
        norm = torch.sqrt(sigma)
        good = norm > eps
        ok = good if ok is None else ok & good
        akk = a[k][k]
        alpha = torch.where(akk >= 0, -norm, norm)
        vk = akk - alpha
        # v^T v = -2 alpha vk, so H = I + v v^T / (alpha vk).
        denom = alpha * vk
        inv_denom = one / torch.where(good, denom, one)
        for j in range(k + 1, nc + 1):
            col = b if j == nc else [a[r][j] for r in range(nr)]
            w = vk * col[k]
            for r in range(k + 1, nr):
                w = w + a[r][k] * col[r]
            w = w * inv_denom
            new = [col[k] + vk * w] + [col[r] + a[r][k] * w for r in range(k + 1, nr)]
            for r, value in zip(range(k, nr), new):
                if j == nc:
                    b[r] = value
                else:
                    a[r][j] = value
        a[k][k] = alpha

    x = [None] * nc
    for i in reversed(range(nc)):
        t = b[i]
        for j in range(i + 1, nc):
            t = t - a[i][j] * x[j]
        diag = a[i][i]
        x[i] = t / torch.where(diag.abs() > eps, diag, one)
    return [x[c] * inv_scale[c] for c in range(nc)], ok


# ---------------------------------------------------------------------------
# Planar Householder R and the R^{-1} R^{-T} solve, in the phantom kernel's
# operation order: matrices are [rows, columns, B] with the batch last, rows
# zero-padded to 32 (one warp's lanes), and every sum over rows is one
# rows_sum32.
# ---------------------------------------------------------------------------

_ROWS = 32


def rows_sum32(x, dim: int = 0):
    """Sum over ``dim`` (at most 32 entries, zero-padded to 32) by halving:
    entry i adds entry i + h for h = 16, 8, 4, 2, 1.  That is the order of a
    32-lane ``__shfl_xor_sync`` butterfly, and ``a + b == b + a`` bit for bit,
    so every lane of the kernel ends with these bits.  ``dim`` is kept, with
    size 1."""
    size = x.shape[dim]
    if size > _ROWS:
        raise ValueError(f"rows_sum32 sums at most {_ROWS} entries, got {size}")
    if size < _ROWS:
        pad = list(x.shape)
        pad[dim] = _ROWS - size
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    h = _ROWS // 2
    while h:
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
        h //= 2
    return x


def _row_masks(n, like):
    """``(ri, live)``: the padded row index ``[32]`` and ``ri < n``."""
    ri = torch.arange(_ROWS, device=like.device)
    return ri, ri < n


def _householder32(m, n: int):
    """n Householder steps on ``m[32, n, B]`` (rows ``>= n`` zero) in the
    kernel's order.  Step j reflects rows j.. with ``v`` = column j below the
    diagonal and ``vk = a_jj - alpha`` in row j; every column c >= j takes
    ``w = inv_denom * (v . col_c)`` and ``col_c + v w`` (column j too, leaving
    a spent reflector below the diagonal).  ``alpha = -sign(a_jj) |col_j|``
    is R's diagonal; ``inv_denom`` is 0 where ``alpha vk`` is 0, so a zero
    column passes through.  Returns ``(m, d_raw [n, B])``."""
    m = m.clone()
    ri, live = _row_masks(n, m)
    dt = m.dtype
    one, zero = scalar_like(1.0, m), scalar_like(0.0, m)
    d_raw = []
    for j in range(n):
        ge = ((ri >= j) & live).to(dt)[:, None]
        gt = ((ri > j) & live).to(dt)[:, None]
        onehot = (ri == j).to(dt)[:, None]
        colj = m[:, j]                                     # [32, B]
        cg = colj * ge
        norm = torch.sqrt(rows_sum32(cg * cg))             # [1, B]
        akk = colj[j : j + 1]
        alpha = torch.where(akk >= 0, -norm, norm)
        vk = akk - alpha
        denom = alpha * vk
        good = denom.abs() > 0
        inv_denom = torch.where(good, one / torch.where(good, denom, one), zero)
        v = colj * gt + onehot * vk                        # [32, B]
        rest = m[:, j:]                                    # [32, n - j, B]
        w = inv_denom[:, None] * rows_sum32(v[:, None] * rest)
        m[:, j:] = rest + v[:, None] * w
        d_raw.append(alpha[0])
    return m, torch.stack(d_raw)


def qr_r_planar(a):
    """Householder QR, R factor only, of ``a[n, n, B]`` (rows, columns, batch
    last; n <= 31): R in the same layout, upper triangle valid, strict lower
    triangle zero.  No column equilibration: the plane phantom's null vector
    is that of the raw system.  A zero pivot column leaves a zero on the
    diagonal; callers clamp the diagonal before inverting.

    The JAX package's ``qr_r_planar`` is a ``lax.scan`` over the steps; here
    each column update is one 32-row reduction (:func:`_householder32`), the
    arithmetic of the phantom subspace kernel, so the two agree to rounding
    (sums are taken in another order)."""
    n = a.shape[0]
    if a.shape[1] != n or n >= _ROWS:
        raise ValueError(f"qr_r_planar needs a[n, n, B] with n < {_ROWS}, got {tuple(a.shape)}")
    m = a.new_zeros((_ROWS,) + tuple(a.shape[1:]))
    m[:n] = a
    m, d_raw = _householder32(m, n)
    idx = torch.arange(n, device=a.device)
    upper = (idx[:, None] <= idx[None, :])[:, :, None]
    r = torch.where(upper, m[:n], torch.zeros_like(m[:n]))
    r[idx, idx] = d_raw
    return r


def solve_rt_r_planar(r_planar, d, v):
    """``z = R^{-1} R^{-T} v``, one inverse-iteration step with the normal
    matrix ``A^T A = R^T R``.  ``r_planar [n, n, B]`` from
    :func:`qr_r_planar` (only its strict upper triangle is read), ``d [n,
    B]`` the diagonal, clamped by the caller, ``v [q, n, B]``; returns ``[q,
    n, B]``.

    The phantom kernel's form: the forward solve ``R^T y = v`` takes one
    masked-column reduction per step, ``y_c = (v_c - sum_{r<c} R_rc y_r) /
    d_c``; the backward solve ``R z = y`` one axpy per step, ``z_c = (y_c -
    acc_c) / d_c`` then ``acc += R[:, c] z_c``."""
    n = d.shape[0]
    ri, _ = _row_masks(n, d)
    dt = v.dtype
    rpad = r_planar.new_zeros((_ROWS,) + tuple(r_planar.shape[1:]))
    rpad[:n] = r_planar
    vpad = v.new_zeros((v.shape[0], _ROWS) + tuple(v.shape[2:]))
    vpad[:, :n] = v
    rcols, onehots = [], []
    y = torch.zeros_like(vpad)
    for c in range(n):
        rc = rpad[:, c] * (ri < c).to(dt)[:, None]          # R[0:c, c], [32, B]
        onehot = (ri == c).to(dt)[:, None]
        rcols.append(rc)
        onehots.append(onehot)
        s = rows_sum32(rc[None] * y, dim=1)                 # [q, 1, B]
        yc = (vpad[:, c : c + 1] - s) / d[c]
        y = y + onehot * yc
    z = torch.zeros_like(vpad)
    acc = torch.zeros_like(vpad)
    for c in reversed(range(n)):
        zc = (y[:, c : c + 1] - acc[:, c : c + 1]) / d[c]
        z = z + onehots[c] * zc
        acc = acc + rcols[c] * zc
    return z[:, :n]
