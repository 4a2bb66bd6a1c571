"""Plain reference of plane-phantom ultrasound-probe calibration RANSAC.

Every pixel of every tracked image ``i`` (pose ``R2_i, t2_i``, pixel ``(u_i,
v_i)``) lies on one unknown plane ``{p: R1_row3 . p + t1_z = 0}``:
``R1_row3 . (R2_i (u_i c1 + v_i c2 + t3) + t2_i) + t1_z = 0``, with ``c1 =
m_x R3(:,1)``, ``c2 = m_y R3(:,2)`` and ``R3 = Rz(wz) Ry(wy) Rx(wx)``
(``PlanePhantomUSCalibrationParametersEstimator.cxx:119-447``).  Params
(41): ``[w1_y, w1_x, t1_z, t3 3, wz, wy, wx, m_x, m_y]`` and 30 derived
entries ``m_x R1_row3_j R3(c,0)`` (9, index ``3 j + c``), ``m_y R1_row3_j
R3(c,1)`` (9), ``R1_row3_j t3_c`` (9) and ``R1_row3`` (3).

* minimal fit: the homogeneous 31 x 31 system of 31 images, rows ``[u
  vec(R2), v vec(R2), vec(R2), t2, 1]``: its null vector (the last right
  singular vector of an SVD), scaled to ``|R1_row3| = 1``; ``t1_z`` its last
  entry; ``c1, c2, t3`` the averages over ``j`` of the three R1-column groups
  divided by ``R1_row3_j``; ``m_x = |c1|``, ``m_y = |c2|``, ``R3`` the
  closest rotation to ``[c1/m_x, c2/m_y, c1/m_x x c2/m_y]``; the plane angles
  from ``R1_row3`` and the R3 angles by the '+sqrt' Euler extraction, each
  with the gimbal branch of ``cxx:230-247``;
* agreement: the plane distance ``e = [u vec(R2), v vec(R2), vec(R2), t2,
  1] . [m1, m2, m3, R1_row3, t1_z]``, ``e^2 < delta^2``;
* refits on the consensus: ANALYTIC, the same null vector over every inlier;
  ITERATIVE, Levenberg-Marquardt over the 11 from the analytic fit, one
  scalar residual per image.

Where this departs from ``.cxx``, it takes the program's gates and rule:

* the rank gate is ``s[29] > FLT_EPS max(s[0], 1)`` (a one-dimensional null
  space) in place of upstream's literal rank-31 test, which an exact minimal
  sample (rank 30) would fail;
* ``|R1_row3| >= EPS`` (``cxx:216-218``'s guard against a null vector with
  no plane normal) and, for a refit, at least 31 images;
* the null vector's sign, which upstream leaves to the SVD, is fixed by
  ``R1_row3[2] >= 0``; the LM's result is held to the same rule (the plane
  mirrored: ``w1_y -> -w1_y``, ``w1_x -> w1_x -+ pi``, ``t1_z -> -t1_z``);
* R3 is the polar factor by Newton's iteration (upstream: ``U V^T`` of an
  SVD, the same rotation).

Data: ``(r2 [n, 3, 3], t2 [n, 3], q [n, 2])``; every function computes in
the data's dtype.
"""

import math

import torch

from gpubench.reference import linalg

K = 31
NPARAMS = 41
FLT_EPS = 1.192092896e-07
EPS = 2.220446049250313e-16                 # DBL_EPSILON, common/Epsilon.h
SMALL_ANGLE = math.radians(0.5)


def cast(data, dtype):
    return tuple(leaf.to(dtype) for leaf in data)


def features(data):
    """``[n, 31]``: ``[u vec(R2), v vec(R2), vec(R2), t2, 1]`` per image."""
    r2, t2, q = data
    r = r2.reshape(-1, 9)
    return torch.cat([q[:, 0:1] * r, q[:, 1:2] * r, r, t2, torch.ones_like(q[:, 0:1])], dim=-1)


def _gimbal(wy):
    return ~(((wy - math.pi / 2).abs() > SMALL_ANGLE) & ((wy + math.pi / 2).abs() > SMALL_ANGLE))


def _euler_plus(r):
    """``(wz, wy, wx)`` of ``r [..., 3, 3] = Rz Ry Rx`` with ``cos wy >= 0``
    and the gimbal branch (``wz = 0``) of ``cxx:230-247``."""
    wy = torch.atan2(-r[..., 2, 0], torch.sqrt(r[..., 0, 0] ** 2 + r[..., 1, 0] ** 2))
    g = _gimbal(wy)
    cy = torch.where(g, torch.ones_like(wy), torch.cos(wy))
    wz = torch.where(g, torch.zeros_like(wy), torch.atan2(r[..., 1, 0] / cy, r[..., 0, 0] / cy))
    wx = torch.where(g, torch.atan2(r[..., 0, 1], r[..., 1, 1]),
                     torch.atan2(r[..., 2, 1] / cy, r[..., 2, 2] / cy))
    return wz, wy, wx


def _plane_angles(r1):
    """``(w1_y, w1_x)`` of the unit normal ``r1 [..., 3]``, with the gimbal
    branch (``w1_x = 0``)."""
    wy = torch.atan2(-r1[..., 0], torch.sqrt(r1[..., 1] ** 2 + r1[..., 2] ** 2))
    g = _gimbal(wy)
    cy = torch.where(g, torch.ones_like(wy), torch.cos(wy))
    return wy, torch.where(g, torch.zeros_like(wy), torch.atan2(r1[..., 1] / cy, r1[..., 2] / cy))


def _normal(w1_y, w1_x):
    return torch.stack([-torch.sin(w1_y), torch.cos(w1_y) * torch.sin(w1_x),
                        torch.cos(w1_y) * torch.cos(w1_x)], dim=-1)


def _layout(w1_y, w1_x, t1_z, t3, angles, m_x, m_y, r3, r1):
    """The 41 params from the 11, R3 ``[..., 3, 3]`` and the normal ``r1``."""
    lead = r1.shape[:-1]
    m1 = m_x[..., None, None] * r1[..., :, None] * r3[..., None, :, 0]
    m2 = m_y[..., None, None] * r1[..., :, None] * r3[..., None, :, 1]
    m3 = r1[..., :, None] * t3[..., None, :]
    return torch.cat([w1_y[..., None], w1_x[..., None], t1_z[..., None], t3, angles,
                      m_x[..., None], m_y[..., None], m1.reshape(*lead, 9),
                      m2.reshape(*lead, 9), m3.reshape(*lead, 9), r1], dim=-1)


def _null_fit(a):
    """``(params [..., 41], valid [...])`` of the homogeneous systems ``a
    [..., m, 31]`` (``m >= 31``)."""
    _, s, vh = torch.linalg.svd(a, full_matrices=False)
    x = vh[..., -1, :]
    rank_ok = s[..., 29] > FLT_EPS * torch.clamp_min(s[..., 0], 1.0)
    x = torch.where(x[..., 29:30] < 0, -x, x)                 # the sign rule
    denom = torch.sqrt(torch.sum(x[..., 27:30] ** 2, dim=-1))
    nondegenerate = denom >= EPS
    x = x / torch.where(nondegenerate, denom, torch.ones_like(denom))[..., None]
    r1, t1_z = x[..., 27:30], x[..., 30]
    w1_y, w1_x = _plane_angles(r1)
    c1, c2, t3 = (torch.mean(x[..., b : b + 9].reshape(*x.shape[:-1], 3, 3) / r1[..., :, None],
                             dim=-2) for b in (0, 9, 18))
    m_x = torch.sqrt(torch.sum(c1 * c1, dim=-1))
    m_y = torch.sqrt(torch.sum(c2 * c2, dim=-1))
    u1, u2 = c1 / m_x[..., None], c2 / m_y[..., None]
    r3 = linalg.polar3(torch.stack([u1, u2, torch.linalg.cross(u1, u2, dim=-1)], dim=-1))
    params = _layout(w1_y, w1_x, t1_z, t3, torch.stack(_euler_plus(r3), dim=-1), m_x, m_y, r3,
                     r1)
    return params, rank_ok & nondegenerate & torch.isfinite(params).all(dim=-1)


def minimal_fit(samples):
    """``[C, 31, 31]`` (:func:`features` rows of 31 images) -> ``(params
    [C, 41], valid [C])``."""
    return _null_fit(samples)


def _vote_row(params):
    """``[..., 31]`` ``[m1, m2, m3, R1_row3, t1_z]``: the plane distance is
    its product with :func:`features`."""
    return torch.cat([params[..., 11:41], params[..., 2:3]], dim=-1)


def vote_counts(params, data, delta):
    """Inlier counts ``[C]`` of hypotheses ``[C, 41]``."""
    e = _vote_row(params) @ features(data).T
    return torch.sum(e * e < delta * delta, dim=-1)


def agree(params, data, delta):
    e = features(data) @ _vote_row(params)
    return e * e < delta * delta


def _signed(x):
    """The 11 under the sign rule: the mirrored plane where ``R1_row3[2] <
    0``."""
    if bool(torch.cos(x[0]) * torch.cos(x[1]) >= 0):
        return x
    wx = x[1] - math.pi if bool(x[1] > 0) else x[1] + math.pi
    return torch.cat([torch.stack([-x[0], wx, -x[2]]), x[3:]])


def refit(data, mask, ls_type):
    """``(params [41], valid)`` of the consensus ``mask``."""
    r2, t2, q = (leaf[mask] for leaf in data)
    if q.shape[0] < K:
        return torch.zeros(NPARAMS, dtype=q.dtype, device=q.device), False
    params, valid = _null_fit(features((r2, t2, q)))
    if ls_type == "iterative":

        def residual(x):
            r3 = linalg.euler_zyx(x[6], x[7], x[8])
            img = q[:, 0:1] * (x[9] * r3[:, 0]) + q[:, 1:2] * (x[10] * r3[:, 1]) + x[3:6]
            return (torch.einsum("nij,nj->ni", r2, img) + t2) @ _normal(x[0], x[1]) + x[2]

        x = linalg.levenberg_marquardt(residual, torch.func.jacfwd(residual), params[:11])
        x = _signed(x)
        params = _layout(x[0], x[1], x[2], x[3:6], x[6:9], x[9], x[10],
                         linalg.euler_zyx(x[6], x[7], x[8]), _normal(x[0], x[1]))
    return params, bool(valid) and bool(torch.isfinite(params).all())
