"""Port parity: ``lsqrrecipes_tpu_torch.geometry`` vs ``lsqrrecipes_tpu.geometry``.

The same float64 inputs, made with numpy from a seed, go through both
packages: random rotations, rotations within the near-pi guard, Euler angles
at gimbal lock and the identity.  Every result agrees to 1e-12 (both sides
compute the same branchless formulas in float64; the tolerance covers the
few ulps by which the two libraries' elementwise functions may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsqrrecipes_tpu.geometry import Frame as JFrame
from lsqrrecipes_tpu.geometry import Ray3D as JRay3D
from lsqrrecipes_tpu.geometry import ray as jray
from lsqrrecipes_tpu.geometry import rotations as jrot
from lsqrrecipes_tpu_torch.geometry import Frame, Ray3D, intersect_rays, rotations

TOL = 1e-12


def _t(x):
    return torch.as_tensor(np.array(x, dtype=np.float64))


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def _quats(seed, m=64):
    q = np.random.default_rng(seed).normal(size=(m, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _axis_angle_set(seed, angles):
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(len(angles), 3))
    return axis / np.linalg.norm(axis, axis=1, keepdims=True), np.asarray(angles)


def _matrices(kind):
    """Rotation matrices of one kind, f64 ``[m, 3, 3]``."""
    if kind == "random":
        return np.asarray(jrot.matrix_from_quaternion(jnp.asarray(_quats(1))))
    if kind == "near_pi":       # within SMALL_ANGLE of a half turn
        axis, angle = _axis_angle_set(2, np.pi - np.linspace(0.0, 5e-3, 40))
    elif kind == "near_zero":
        axis, angle = _axis_angle_set(3, np.linspace(0.0, 5e-3, 40))
    else:                       # "half_turns": exactly pi about each axis and more
        axis = np.concatenate([np.eye(3), -np.eye(3), _quats(4, 6)[:, :3]])
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        angle = np.full(len(axis), np.pi)
    return np.asarray(jrot.matrix_from_axis_angle(jnp.asarray(axis), jnp.asarray(angle)))


KINDS = ["random", "near_pi", "near_zero", "half_turns"]


def test_matrix_from_quaternion_and_normalize():
    q = _quats(5) * np.random.default_rng(6).uniform(0.5, 2.0, (64, 1))
    _close(rotations.normalize_quaternion(_t(q)), jrot.normalize_quaternion(jnp.asarray(q)))
    _close(rotations.matrix_from_quaternion(_t(q)), jrot.matrix_from_quaternion(jnp.asarray(q)))


@pytest.mark.parametrize("kind", KINDS)
def test_quaternion_from_matrix(kind):
    r = _matrices(kind)
    got = rotations.quaternion_from_matrix(_t(r))
    _close(got, jrot.quaternion_from_matrix(jnp.asarray(r)))
    # And the quaternion rebuilds the rotation (to the stabilised branch's
    # accuracy near a half turn).
    _close(rotations.matrix_from_quaternion(got), r, 1e-7)


@pytest.mark.parametrize("kind", KINDS)
def test_axis_angle_from_matrix(kind):
    r = _matrices(kind)
    angle, axis = rotations.axis_angle_from_matrix(_t(r))
    ja, jx = jrot.axis_angle_from_matrix(jnp.asarray(r))
    _close(angle, ja)
    _close(axis, jx)


@pytest.mark.parametrize("ay", ["random", "gimbal_plus", "gimbal_minus", "near_gimbal"])
def test_euler_zyx_both_ways(ay):
    rng = np.random.default_rng(7)
    ax, az = rng.uniform(-np.pi, np.pi, 32), rng.uniform(-np.pi, np.pi, 32)
    ays = {
        "random": rng.uniform(-1.4, 1.4, 32),
        "gimbal_plus": np.full(32, np.pi / 2),
        "gimbal_minus": np.full(32, -np.pi / 2),
        "near_gimbal": np.pi / 2 - np.linspace(-8e-3, 8e-3, 32),
    }[ay]
    r = rotations.matrix_from_euler_zyx(_t(ax), _t(ays), _t(az))
    jr = jrot.matrix_from_euler_zyx(jnp.asarray(ax), jnp.asarray(ays), jnp.asarray(az))
    _close(r, jr)
    angles, lock = rotations.euler_zyx_from_matrix(r)
    ja, jl = jrot.euler_zyx_from_matrix(jr)
    np.testing.assert_array_equal(lock.numpy(), np.asarray(jl))
    _close(angles, ja)


def test_axis_angle_builders():
    axis, angle = _axis_angle_set(8, np.random.default_rng(9).uniform(0, np.pi, 32))
    _close(rotations.matrix_from_axis_angle(_t(axis), _t(angle)),
           jrot.matrix_from_axis_angle(jnp.asarray(axis), jnp.asarray(angle)))
    w = axis * angle[:, None]
    w[0] = 0.0                                   # the zero vector's fallback axis
    _close(rotations.matrix_from_axis_angle_vector(_t(w)),
           jrot.matrix_from_axis_angle_vector(jnp.asarray(w)))


def test_matrix_from_to_and_interpolation():
    rng = np.random.default_rng(10)
    a, b = rng.normal(size=(32, 3)), rng.normal(size=(32, 3))
    _close(rotations.matrix_from_to(_t(a), _t(b)), jrot.matrix_from_to(jnp.asarray(a), jnp.asarray(b)))
    q0, q1 = _quats(11, 32), _quats(12, 32)
    q1[0] = q0[0]                                # the theta = 0 lane of slerp
    t = rng.uniform(0, 1, 32)
    _close(rotations.quaternion_lerp(_t(q0), _t(q1), _t(t)),
           jrot.quaternion_lerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(t)))
    _close(rotations.quaternion_slerp(_t(q0), _t(q1), _t(t)),
           jrot.quaternion_slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(t)))


def _frames(seed, m=16):
    rng = np.random.default_rng(seed)
    q, t = _quats(seed, m), rng.uniform(-50, 50, (m, 3))
    return Frame.from_quaternion(_t(q), _t(t)), JFrame.from_quaternion(jnp.asarray(q), jnp.asarray(t))


def test_frame_builders():
    rng = np.random.default_rng(13)
    t = rng.uniform(-5, 5, (8, 3))
    q = _quats(14, 8) * 3.0
    for got, want in [
        (Frame.from_quaternion(_t(q), _t(t), normalize=True),
         JFrame.from_quaternion(jnp.asarray(q), jnp.asarray(t), normalize=True)),
        (Frame.from_euler_zyx(_t(t[:, 0]), _t(t[:, 1] / 5), _t(t[:, 2]), _t(t)),
         JFrame.from_euler_zyx(jnp.asarray(t[:, 0]), jnp.asarray(t[:, 1] / 5),
                               jnp.asarray(t[:, 2]), jnp.asarray(t))),
        (Frame.from_axis_angle(_t(q[:, :3] / np.linalg.norm(q[:, :3], axis=1, keepdims=True)),
                               _t(t[:, 0]), _t(t)),
         JFrame.from_axis_angle(jnp.asarray(q[:, :3] / np.linalg.norm(q[:, :3], axis=1,
                                                                      keepdims=True)),
                                jnp.asarray(t[:, 0]), jnp.asarray(t))),
        (Frame.from_axis_angle_vector(_t(t), _t(t)),
         JFrame.from_axis_angle_vector(jnp.asarray(t), jnp.asarray(t))),
        (Frame.identity((2, 3)), JFrame.identity((2, 3))),
    ]:
        _close(got.r, want.r)
        _close(got.t, want.t)


def test_frame_apply_compose_inverse():
    f, jf = _frames(15)
    g, jg = _frames(16)
    p = np.random.default_rng(17).uniform(-20, 20, (16, 3))
    for name in ("apply", "apply_vector", "apply_inverse", "apply_inverse_vector"):
        _close(getattr(f, name)(_t(p)), getattr(jf, name)(jnp.asarray(p)))
    for got, want in [(f.compose(g), jf.compose(jg)), (f @ g, jf @ jg),
                      (f.inverse(), jf.inverse())]:
        _close(got.r, want.r)
        _close(got.t, want.t)


def test_frame_conversions_interpolation_and_deltas():
    f, jf = _frames(18)
    g, jg = _frames(19)
    _close(f.quaternion(), jf.quaternion())
    angles, lock = f.euler_zyx()
    ja, jl = jf.euler_zyx()
    _close(angles, ja)
    np.testing.assert_array_equal(lock.numpy(), np.asarray(jl))
    for got, want in zip(f.axis_angle(), jf.axis_angle()):
        _close(got, want)
    for method in ("lerp", "slerp"):
        got, want = getattr(f, method)(g, 0.3), getattr(jf, method)(jg, 0.3)
        _close(got.r, want.r)
        _close(got.t, want.t)
    for got, want in zip(f.angle_and_translation_diff(g), jf.angle_and_translation_diff(jg)):
        _close(got, want)
    got, want = f.euler_and_translation_diff(g), jf.euler_and_translation_diff(jg)
    _close(got[0], want[0])
    _close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def _rays(seed, m=64):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-50, 50, (m, 3))
    n = np.array([3.0, -4.0, 20.0]) - p + rng.normal(size=(m, 3))
    n[: m // 4] *= rng.uniform(0.5, 2.0, (m // 4, 1))     # not unit
    return p, n


def test_ray_distance_and_transform():
    p, n = _rays(20)
    q = np.random.default_rng(21).uniform(-30, 30, (64, 3))
    _close(Ray3D(_t(p), _t(n)).distance_to_point(_t(q)),
           JRay3D(jnp.asarray(p), jnp.asarray(n)).distance_to_point(jnp.asarray(q)))
    f, jf = _frames(22, 64)
    got = Ray3D(_t(p), _t(n)).transformed(f)
    want = JRay3D(jnp.asarray(p), jnp.asarray(n)).transformed(jf)
    _close(got.p, want.p)
    _close(got.n, want.n)


@pytest.mark.parametrize("eps", [None, float(np.sin(0.05) ** 2)])
def test_intersect_rays(eps):
    p, n = _rays(23)
    a, b = Ray3D(_t(p[:32]), _t(n[:32])), Ray3D(_t(p[32:]), _t(n[32:]))
    b.n[0] = a.n[0]                              # a parallel pair
    ja = JRay3D(jnp.asarray(p[:32]), jnp.asarray(n[:32]))
    jb = JRay3D(jnp.asarray(p[32:]), jnp.asarray(b.n.numpy()))
    kw = {} if eps is None else {"parallel_eps": eps}
    x, valid = intersect_rays(a, b, **kw)
    jx, jvalid = jray.intersect_rays(ja, jb, **kw)
    _close(x, jx)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert not bool(valid[0]) and bool(valid.any()) and not bool(valid.all())
