"""Small dense solves in plain PyTorch operations, in any floating dtype.

Everything here is elementwise arithmetic, ``argmax``, ``gather`` and
matrix products, so the same code runs in float64 (the reference), float32
or bfloat16 (the controls), on the CPU or the card.
"""

import torch


def ge_solve(a, b):
    """Solve ``a x = b`` for ``a [..., N, N]`` and ``b [..., N]`` by Gaussian
    elimination with partial pivoting, columns equilibrated first.  A
    singular system gives non-finite entries, never an error."""
    n = a.shape[-1]
    scale = torch.sqrt(torch.sum(a * a, dim=-2))
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    a = a / scale[..., None, :]
    m = torch.cat([a, b[..., None]], dim=-1)
    rows = torch.arange(n, device=a.device)
    for k in range(n):
        piv = torch.argmax(m[..., k:, k].abs(), dim=-1) + k          # [...]
        order = rows.expand(*m.shape[:-2], n).clone()
        order[..., k] = piv
        order.scatter_(-1, piv[..., None], k)
        m = torch.gather(m, -2, order[..., None].expand_as(m))
        pivot_row = m[..., k : k + 1, :] / m[..., k : k + 1, k : k + 1]
        below = m[..., k + 1 :, k : k + 1]
        m = torch.cat([m[..., :k, :], pivot_row, m[..., k + 1 :, :] - below * pivot_row], dim=-2)
    x = [None] * n
    for i in range(n - 1, -1, -1):
        acc = m[..., i, n]
        for j in range(i + 1, n):
            acc = acc - m[..., i, j] * x[j]
        x[i] = acc
    return torch.stack(x, dim=-1) / scale


def lstsq(a, b):
    """Least-squares solution of ``a x ~ b`` (``a [m, N]``, ``b [m]``) from
    the normal equations, solved by :func:`ge_solve`."""
    return ge_solve(a.T @ a, a.T @ b)


def inv_transpose3(x):
    """``x^{-T}`` of ``x [..., 3, 3]`` by cofactors."""
    c0 = torch.linalg.cross(x[..., :, 1], x[..., :, 2], dim=-1)
    c1 = torch.linalg.cross(x[..., :, 2], x[..., :, 0], dim=-1)
    c2 = torch.linalg.cross(x[..., :, 0], x[..., :, 1], dim=-1)
    det = torch.sum(x[..., :, 0] * c0, dim=-1)
    return torch.stack([c0, c1, c2], dim=-1) / det[..., None, None]


def polar3(x, iters=12):
    """Orthogonal polar factor of ``x [..., 3, 3]`` (the closest rotation
    when ``det x > 0``) by Newton's iteration ``x <- (x + x^{-T}) / 2``."""
    for _ in range(iters):
        x = 0.5 * (x + inv_transpose3(x))
    return x


def euler_zyx(wz, wy, wx):
    """``Rz(wz) Ry(wy) Rx(wx)`` ``[..., 3, 3]``."""
    cz, sz, cy, sy, cx, sx = (torch.cos(wz), torch.sin(wz), torch.cos(wy), torch.sin(wy),
                              torch.cos(wx), torch.sin(wx))
    rows = [
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def euler_angles(r):
    """``(wz, wy, wx)`` of ``r = Rz Ry Rx`` with ``cos wy >= 0``."""
    wy = torch.atan2(-r[..., 2, 0], torch.sqrt(r[..., 0, 0] ** 2 + r[..., 1, 0] ** 2))
    return torch.atan2(r[..., 1, 0], r[..., 0, 0]), wy, torch.atan2(r[..., 2, 1], r[..., 2, 2])


def levenberg_marquardt(residual, jacobian, x0, max_iters=300):
    """Minimise ``0.5 |residual(x)|^2`` from ``x0`` (one problem).  Damped
    normal equations with Marquardt's diagonal; a step is taken only when
    it lowers the cost.  Stops when the damping passes 1e16, or the step
    falls below ``4 eps |x|``, or after ``max_iters`` steps."""
    eps = torch.finfo(x0.dtype).eps
    x = x0
    r = residual(x)
    cost = torch.sum(r * r)
    lam = 1e-3
    for _ in range(max_iters):
        j = jacobian(x)
        jtj, g = j.T @ j, j.T @ r
        a = jtj + lam * torch.diag(torch.diagonal(jtj))
        step = ge_solve(a, -g)
        x_new = x + step
        r_new = residual(x_new)
        cost_new = torch.sum(r_new * r_new)
        if bool(torch.isfinite(cost_new)) and bool(cost_new < cost):
            x, r, cost = x_new, r_new, cost_new
            lam = max(lam / 3.0, 1e-12)
            if bool(torch.sqrt(torch.sum(step * step)) <= 4 * eps * torch.sqrt(torch.sum(x * x))):
                break
        else:
            lam *= 4.0
            if lam > 1e16:
                break
    return x
