"""Rotation-representation conversions, batched and branchless (counterpart
of ``lsqrrecipes_tpu/geometry/rotations.py``).

Reproduces the reference ``common/Frame.cxx`` rotation code (quaternion /
matrix / Euler-ZYX / axis-angle conversions with the gimbal-lock and near-pi
guards, ``Frame.cxx:881-988``) as functions over tensors with any leading
batch dimensions.  Every data-dependent branch of the C++ is computed on all
lanes and chosen with ``torch.where``, as the JAX package does with
``jnp.where``, so one call serves a whole batch of hypotheses.

Conventions (identical to the reference):
  * quaternions are ``[s, qx, qy, qz]`` (scalar first), unit norm;
  * Euler angles are ZYX: ``R = Rz(az) @ Ry(ay) @ Rx(ax)`` (``Frame.cxx:626-648``);
  * axis-angle extraction returns ``(angle, axis)`` with ``angle`` in ``[0, pi]``;
  * ``SMALL_ANGLE`` = 0.5 degrees guards the singular zones (``Frame.cxx:7-8``).
"""

import math

import torch

from lsqrrecipes_tpu_torch.config import HALF_PI, SMALL_ANGLE


def _norm(x, keepdim=False):
    """``sqrt(sum(x * x))`` over the last axis (``jnp.linalg.norm``'s form)."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def _take_axis_solution(sols, imax):
    """``sols[..., imax, :]`` per batch entry (``take_along_axis``)."""
    index = imax[..., None, None].expand(*imax.shape, 1, sols.shape[-1])
    return torch.gather(sols, -2, index)[..., 0, :]


def matrix_from_quaternion(q):
    """Unit quaternion ``[..., 4]`` (s first) -> rotation matrix ``[..., 3, 3]``
    (``Frame.cxx`` setRotationQuaternion)."""
    s, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - s * z), 2 * (x * z + s * y)], dim=-1
    )
    row1 = torch.stack(
        [2 * (x * y + s * z), 1 - 2 * (x * x + z * z), 2 * (y * z - s * x)], dim=-1
    )
    row2 = torch.stack(
        [2 * (x * z - s * y), 2 * (y * z + s * x), 1 - 2 * (x * x + y * y)], dim=-1
    )
    return torch.stack([row0, row1, row2], dim=-2)


def normalize_quaternion(q):
    return q / _norm(q, keepdim=True)


def quaternion_from_matrix(r):
    """Rotation matrix ``[..., 3, 3]`` -> unit quaternion ``[..., 4]``, s first.

    Branchless ``Frame.cxx:952-988``: the regular path takes ``s =
    0.5 sqrt(trace + 1)`` and the off-diagonal differences; within
    SMALL_ANGLE of a half turn (s near 0) the vector part comes from the
    dominant diagonal entry, with its sign recovered from the antisymmetric
    part ``r[k, j] - r[j, k] = 4 s q_i`` (the JAX package's correction of the
    reference, which always returns a positive dominant component).
    """
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    s = 0.5 * torch.sqrt(torch.clamp_min(trace + 1.0, 0.0))
    half_theta = torch.acos(torch.clamp(s, -1.0, 1.0))
    singular = torch.abs(half_theta - HALF_PI) < SMALL_ANGLE

    denom = torch.where(singular, torch.ones_like(s), 4.0 * s)  # no /0 on the dead lane
    vx = (r[..., 2, 1] - r[..., 1, 2]) / denom
    vy = (r[..., 0, 2] - r[..., 2, 0]) / denom
    vz = (r[..., 1, 0] - r[..., 0, 1]) / denom
    regular = torch.stack([s, vx, vy, vz], dim=-1)

    tiny = torch.finfo(r.dtype).tiny

    def axis_solution(i):
        j, k = (i + 1) % 3, (i + 2) % 3
        wsq = r[..., i, i] - r[..., j, j] - r[..., k, k] + 1.0
        w = torch.sqrt(torch.clamp_min(wsq, tiny))
        qi = w / 2.0
        qj = (r[..., i, j] + r[..., j, i]) / (2.0 * w)
        qk = (r[..., i, k] + r[..., k, i]) / (2.0 * w)
        sign = torch.where(r[..., k, j] - r[..., j, k] < 0.0, -1.0, 1.0).to(r.dtype)
        vec = [None, None, None]
        vec[i], vec[j], vec[k] = sign * qi, sign * qj, sign * qk
        return torch.stack([s] + vec, dim=-1)

    diag = torch.stack([r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]], dim=-1)
    # The reference picks i by sequential "if >" tests (first max wins), as
    # argmax does.
    imax = torch.argmax(diag, dim=-1)
    sols = torch.stack([axis_solution(0), axis_solution(1), axis_solution(2)], dim=-2)
    stabilized = _take_axis_solution(sols, imax)
    return torch.where(singular[..., None], stabilized, regular)


def matrix_from_euler_zyx(ax, ay, az):
    """Euler ZYX angles -> ``R = Rz(az) Ry(ay) Rx(ax)`` (``Frame.cxx:626-648``)."""
    cx, cy, cz = torch.cos(ax), torch.cos(ay), torch.cos(az)
    sx, sy, sz = torch.sin(ax), torch.sin(ay), torch.sin(az)
    row0 = torch.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx], dim=-1)
    row1 = torch.stack([sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx], dim=-1)
    row2 = torch.stack([-sy, cy * sx, cy * cx], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def euler_zyx_from_matrix(r):
    """Rotation ``[..., 3, 3]`` -> ``(angles[..., 6], is_gimbal_lock[...])``.

    ``angles = [ax1, ay1, az1, ax2, ay2, az2]``, the two Euler-ZYX solutions
    of ``Frame.cxx:881-914``.  Under gimbal lock (``ay`` within SMALL_ANGLE
    of +-pi/2) both collapse to ``az = 0``, ``ax = atan2(r01, r11)``.
    """
    r20 = r[..., 2, 0]
    mag = torch.sqrt(r[..., 0, 0] ** 2 + r[..., 1, 0] ** 2)
    ay1 = torch.atan2(-r20, mag)
    ay2 = torch.atan2(-r20, -mag)

    gimbal = ~((torch.abs(ay1 - HALF_PI) > SMALL_ANGLE)
               & (torch.abs(ay1 + HALF_PI) > SMALL_ANGLE))

    one = torch.ones_like(ay1)
    cy1 = torch.where(gimbal, one, torch.cos(ay1))
    cy2 = torch.where(gimbal, one, torch.cos(ay2))
    ax1 = torch.atan2(r[..., 2, 1] / cy1, r[..., 2, 2] / cy1)
    az1 = torch.atan2(r[..., 1, 0] / cy1, r[..., 0, 0] / cy1)
    ax2 = torch.atan2(r[..., 2, 1] / cy2, r[..., 2, 2] / cy2)
    az2 = torch.atan2(r[..., 1, 0] / cy2, r[..., 0, 0] / cy2)

    ax_lock = torch.atan2(r[..., 0, 1], r[..., 1, 1])
    zero = torch.zeros_like(ax_lock)
    ax1 = torch.where(gimbal, ax_lock, ax1)
    ax2 = torch.where(gimbal, ax_lock, ax2)
    az1 = torch.where(gimbal, zero, az1)
    az2 = torch.where(gimbal, zero, az2)
    return torch.stack([ax1, ay1, az1, ax2, ay2, az2], dim=-1), gimbal


def matrix_from_axis_angle(axis, angle):
    """Rodrigues rotation from a unit ``axis[..., 3]`` and ``angle[...]``."""
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    k = torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand(k.shape)
    outer = axis[..., :, None] * axis[..., None, :]
    return c * eye + s * k + (1.0 - c) * outer


def matrix_from_axis_angle_vector(w):
    """Axis-angle vector ``[..., 3]`` whose norm is the angle -> matrix."""
    angle = _norm(w)
    safe = torch.where(angle > 0, angle, torch.ones_like(angle))
    axis = w / safe[..., None]
    ex = torch.zeros_like(axis)
    ex[..., 0] = 1.0
    axis = torch.where(angle[..., None] > 0, axis, ex)
    return matrix_from_axis_angle(axis, angle)


def axis_angle_from_matrix(r):
    """Rotation ``[..., 3, 3]`` -> ``(angle[...], axis[..., 3])``.

    ``Frame.cxx:916-950``: ``angle = atan2(s, c)``, the axis from the
    antisymmetric part in the regular zone and from the dominant diagonal
    entry within SMALL_ANGLE of pi.  As in the JAX package, the near-zero
    zone keeps the antisymmetric formula (exact as the angle goes to 0) with
    a fallback axis for the exact identity, and the near-pi axis takes its
    sign from ``r[k, j] - r[j, k] = 2 sin(angle) a_i``.
    """
    c_theta = (r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2] - 1.0) / 2.0
    d0 = r[..., 2, 1] - r[..., 1, 2]
    d1 = r[..., 0, 2] - r[..., 2, 0]
    d2 = r[..., 1, 0] - r[..., 0, 1]
    s_theta = torch.sqrt((d0 * d0 + d1 * d1 + d2 * d2) / 4.0)
    angle = torch.atan2(s_theta, c_theta)
    near_pi = angle >= math.pi - SMALL_ANGLE

    tiny = torch.finfo(r.dtype).tiny
    d_norm = 2.0 * s_theta
    scale = 1.0 / torch.clamp_min(d_norm, math.sqrt(tiny))
    regular_axis = torch.stack([scale * d0, scale * d1, scale * d2], dim=-1)
    ex = torch.zeros_like(regular_axis)
    ex[..., 0] = 1.0
    regular_axis = torch.where((d_norm > math.sqrt(tiny))[..., None], regular_axis, ex)

    w = 1.0 / (2.0 * torch.clamp_min(1.0 - c_theta, tiny))

    def axis_solution(i):
        j, k = (i + 1) % 3, (i + 2) % 3
        ai_sq = (r[..., i, i] - r[..., j, j] - r[..., k, k] + 1.0) * w
        ai = torch.sqrt(torch.clamp_min(ai_sq, tiny))
        aj = (r[..., i, j] + r[..., j, i]) * (w / ai)
        ak = (r[..., i, k] + r[..., k, i]) * (w / ai)
        sign = torch.where(r[..., k, j] - r[..., j, k] < 0.0, -1.0, 1.0).to(r.dtype)
        vec = [None, None, None]
        vec[i], vec[j], vec[k] = sign * ai, sign * aj, sign * ak
        return torch.stack(vec, dim=-1)

    diag = torch.stack([r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]], dim=-1)
    imax = torch.argmax(diag, dim=-1)
    sols = torch.stack([axis_solution(0), axis_solution(1), axis_solution(2)], dim=-2)
    stabilized_axis = _take_axis_solution(sols, imax)
    return angle, torch.where(near_pi[..., None], stabilized_axis, regular_axis)


def matrix_from_to(v_from, v_to):
    """Rotation taking normalised ``v_from`` to ``v_to`` (Moller-Hughes,
    ``Frame.cxx:802-849``); like the reference, the anti-parallel case is
    not stabilised."""
    left = v_from / _norm(v_from, keepdim=True)
    right = v_to / _norm(v_to, keepdim=True)
    v = torch.linalg.cross(left, right, dim=-1)
    c = torch.sum(left * right, dim=-1)
    h = 1.0 / (1.0 + c)
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    row0 = torch.stack([c + h * v0 * v0, h * v0 * v1 - v2, h * v0 * v2 + v1], dim=-1)
    row1 = torch.stack([h * v0 * v1 + v2, c + h * v1 * v1, h * v1 * v2 - v0], dim=-1)
    row2 = torch.stack([h * v0 * v2 - v1, h * v1 * v2 + v0, c + h * v2 * v2], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def quaternion_lerp(q0, q1, t):
    """Linear quaternion interpolation, renormalised (``Frame.cxx:466-492``)."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)[..., None]
    return normalize_quaternion((1.0 - t) * q0 + t * q1)


def quaternion_slerp(q0, q1, t):
    """Spherical linear interpolation (``Frame.cxx:520-552``); the theta = 0
    lane returns ``q0`` instead of NaN."""
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    dot = torch.sum(q0 * q1, dim=-1)
    theta = torch.acos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    safe = torch.abs(sin_theta) > torch.finfo(q0.dtype).tiny
    sin_safe = torch.where(safe, sin_theta, torch.ones_like(sin_theta))
    w0 = torch.sin((1.0 - t) * theta) / sin_safe
    w1 = torch.sin(t * theta) / sin_safe
    out = w0[..., None] * q0 + w1[..., None] * q1
    return torch.where(safe[..., None], out, q0)
