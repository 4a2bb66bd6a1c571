"""Plain reference of crosswire ultrasound-probe calibration RANSAC.

Every tracked image ``i`` (pose ``R2_i, t2_i``, pixel ``(u_i, v_i)``) views
one unknown point ``t1``: ``R2_i (u_i c1 + v_i c2 + t3) + t2_i = t1``, with
``c1 = m_x R3(:,1)``, ``c2 = m_y R3(:,2)`` and ``R3 = Rz(wz) Ry(wy) Rx(wx)``.
Params (20): ``[t1 3, t3 3, wz, wy, wx, m_x, m_y, c1 3, c2 3, R3(:,3)]``.

* minimal fit: the 12 equations of four images, ``[u R2 | v R2 | R2 | -I]
  [c1; c2; t3; t1] = -t2``, solved exactly; ``m_x = |c1|``, ``m_y = |c2|``
  and ``R3`` the closest rotation to ``[c1/m_x, c2/m_y, c1/m_x x c2/m_y]``;
* agreement: ``|R2 (u c1 + v c2 + t3) + t2 - t1|^2 < delta^2``;
* refits on the consensus: ANALYTIC, the same system over every inlier by
  least squares, then ``R3`` as above; ITERATIVE, Levenberg-Marquardt over
  ``[t1, t3, wz, wy, wx, m_x, m_y]`` from the analytic fit.

Data: ``(r2 [n, 3, 3], t2 [n, 3], q [n, 2])``; every function computes in
the data's dtype.
"""

import torch

from gpubench.reference import linalg

K = 4


def cast(data, dtype):
    return tuple(leaf.to(dtype) for leaf in data)


def features(data):
    r2, t2, q = data
    return torch.cat([r2.reshape(-1, 9), t2, q], dim=-1)


def _system(r2, t2, q):
    """Rows ``[..., 3 m, 12]`` and right-hand side ``[..., 3 m]`` of the
    calibration system of images ``r2 [..., m, 3, 3]``."""
    u, v = q[..., 0, None, None], q[..., 1, None, None]
    eye = -torch.eye(3, dtype=r2.dtype, device=r2.device).expand(r2.shape)
    a = torch.cat([u * r2, v * r2, r2, eye], dim=-1)
    return a.reshape(*a.shape[:-3], -1, 12), (-t2).reshape(*t2.shape[:-2], -1)


def _pack(c1, c2, t3, t1):
    m_x = torch.sqrt(torch.sum(c1 * c1, dim=-1))
    m_y = torch.sqrt(torch.sum(c2 * c2, dim=-1))
    r1, r2 = c1 / m_x[..., None], c2 / m_y[..., None]
    r3 = linalg.polar3(torch.stack([r1, r2, torch.linalg.cross(r1, r2, dim=-1)], dim=-1))
    return _layout(t1, t3, torch.stack(linalg.euler_angles(r3), dim=-1), m_x, m_y, r3)


def _layout(t1, t3, angles, m_x, m_y, r3):
    return torch.cat([t1, t3, angles, m_x[..., None], m_y[..., None],
                      m_x[..., None] * r3[..., :, 0], m_y[..., None] * r3[..., :, 1],
                      r3[..., :, 2]], dim=-1)


def _from_solution(x):
    return _pack(x[..., 0:3], x[..., 3:6], x[..., 6:9], x[..., 9:12])


def minimal_fit(samples):
    """``[C, 4, 14]`` (``[vec(R2), t2, u, v]`` rows) -> ``(params [C, 20],
    valid [C])``."""
    r2 = samples[..., :9].reshape(*samples.shape[:-1], 3, 3)
    a, b = _system(r2, samples[..., 9:12], samples[..., 12:14])
    params = _from_solution(linalg.ge_solve(a, b))
    return params, torch.isfinite(params).all(dim=-1)


def vote_counts(params, data, delta):
    """Inlier counts ``[C]`` of hypotheses ``[C, 20]``: each residual
    component is ``[u R2_j, v R2_j, R2_j, t2_j, 1] . [c1, c2, t3, 1, -t1_j]``."""
    r2, t2, q = data
    u, v = q[:, 0:1], q[:, 1:2]
    one = torch.ones_like(u)
    d2 = None
    for j in range(3):
        feat = torch.cat([u * r2[:, j], v * r2[:, j], r2[:, j], t2[:, j : j + 1], one], dim=-1)
        coef = torch.cat([params[:, 11:14], params[:, 14:17], params[:, 3:6],
                          torch.ones_like(params[:, :1]), -params[:, j : j + 1]], dim=-1)
        e = coef @ feat.T
        d2 = e * e if d2 is None else d2 + e * e
    return torch.sum(d2 < delta * delta, dim=-1)


def agree(params, data, delta):
    r2, t2, q = data
    img = q[:, 0:1] * params[11:14] + q[:, 1:2] * params[14:17] + params[3:6]
    e = torch.einsum("nij,nj->ni", r2, img) + t2 - params[0:3]
    return torch.sum(e * e, dim=-1) < delta * delta


def refit(data, mask, ls_type):
    """``(params [20], valid)`` of the consensus ``mask``."""
    r2, t2, q = (leaf[mask] for leaf in data)
    if q.shape[0] < K:
        return torch.zeros(20, dtype=q.dtype, device=q.device), False
    a, b = _system(r2, t2, q)
    params = _from_solution(linalg.lstsq(a, b))
    if ls_type == "iterative":

        def residual(x):
            r3 = linalg.euler_zyx(x[6], x[7], x[8])
            img = q[:, 0:1] * (x[9] * r3[:, 0]) + q[:, 1:2] * (x[10] * r3[:, 1]) + x[3:6]
            return (torch.einsum("nij,nj->ni", r2, img) + t2 - x[0:3]).reshape(-1)

        x = linalg.levenberg_marquardt(residual, torch.func.jacfwd(residual), params[:11])
        params = _layout(x[0:3], x[3:6], x[6:9], x[9], x[10], linalg.euler_zyx(x[6], x[7], x[8]))
    return params, bool(torch.isfinite(params).all())
