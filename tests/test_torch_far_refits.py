"""Consensus refits of float32 clouds far from the origin.

The plane, line3d, line2d and absolute-orientation refits accumulate their
sufficient statistics in float64 from upcast data, and the sphere's
ALGEBRAIC refit builds and solves its system in float64; the params come
back in the data's dtype.  The JAX package sums in the data's dtype.

Clouds of n = 1,024 made with numpy from a seed (``far_data``): a sphere of
radius 10 about (1, 2, -3), a plane and a 3D line through (1, 2, -3) of
extent +-10, a 2D line through (-2, 5), all with N(0, 0.05) noise; an
absolute-orientation pair under a 0.3 rad turn about z and t = (5, -2, 1)
with N(0, 0.01); rays of length 50-200 through (1, 2, 3); pivot frames with
random rotations about t_D = (10, -5, 2), t_W = (100, 50, -30), N(0, 0.05).
Each is shifted by 0, 1e3 or 1e4 on every axis and cast to float32, and
refitted either whole or on the consensus of a cloud whose last fifth are
outliers.  Every case holds the port's refit

  * to the JAX package's refit of the same float32 points as float64, cast
    to float32 (rtol 1e-6, atol 1e-6; directions, normals and quaternions up
    to sign; Horn's translation, which float64 moments of a far cloud leave
    by up to 1.5e-5 in both packages, within one float32 ulp of the offset
    besides);
  * to the port's refit of the same cloud at the origin: direction, normal
    or rotation within 0.005 degrees, the point (centre, anchor, t, t_W)
    less the offset within 2e-3;
  * to the truth: the sphere's centre within 0.02 and radius within 0.01,
    the plane normal, line3d direction and line2d normal within 0.1
    degrees, the rotation within 0.02 degrees; the ray_intersection and
    pivot guards (whose refits stay in the data's dtype) within 0.2 and 0.1.

Before the float64 refits, 21 of these cases failed: every 1e3 and 1e4
case of the five refits, and the fused sweep.  At 1e4 (full mask /
consensus) the sphere came back with r 11.314 / 9.798 (centre error
0.061 / 0.039), the plane normal 50.9 / 55.7 degrees off the truth, the
line3d direction 60.6 / 84.5, the line2d normal 14.4 / 8.1 and the
rotation 18.1 / 39.9; at 1e3 already 0.17 / 0.34, 0.24 / 0.40, 0.16 / 0.08
and 0.39 / 0.51 degrees.  The fused sphere sweep below found all 820
inliers and refitted r 11.314 for truth 10.  The guards passed then as now.

JAX is imported inside the tests only, so ``test_torch_kernels.py`` can
import the clouds on a machine without it.
"""

import numpy as np
import pytest
import torch

from lsqrrecipes_tpu_torch import estimators as est_mod
from lsqrrecipes_tpu_torch.geometry import Frame, Ray3D, rotations
from lsqrrecipes_tpu_torch.ransac import engine, ransac, ransac_batched, ransac_fused_sweep

torch.set_num_threads(2)

N = 1024
OFFSETS = (0.0, 1e3, 1e4)
MASKS = ("full", "consensus")
SPHERE_C, SPHERE_R = np.array([1.0, 2.0, -3.0]), 10.0
E1 = np.array([1.0, 0.0, 0.5]) / np.sqrt(1.25)
E2 = np.array([0.0, 1.0, -0.2]) / np.linalg.norm([0.0, 1.0, -0.2])
PLANE_N = np.cross(E1, E2) / np.linalg.norm(np.cross(E1, E2))
LINE_U = np.array([0.6, -0.64, 0.48]) / np.linalg.norm([0.6, -0.64, 0.48])
LINE2D_A, LINE2D_N = np.array([-2.0, 5.0]), np.array([-0.6, 0.8])
ABSOR_ANGLE, ABSOR_T = 0.3, np.array([5.0, -2.0, 1.0])
RAY_TARGET = np.array([1.0, 2.0, 3.0])
PIVOT_TD, PIVOT_TW = np.array([10.0, -5.0, 2.0]), np.array([100.0, 50.0, -30.0])

# The five refits computed in float64, then the two guards.
REFITS = ("sphere", "plane", "line3d", "line2d", "absolute_orientation")
GUARDS = ("ray_intersection", "pivot_calibration")
PARITY = dict(rtol=1e-6, atol=1e-6)
INVARIANT_DEG, INVARIANT_POINT = 0.005, 2e-3
TRUTH = {"sphere": (0.02, 0.01), "plane": (0.1,), "line3d": (0.1,), "line2d": (0.1,),
         "absolute_orientation": (0.02,), "ray_intersection": (0.2,),
         "pivot_calibration": (0.1, 0.1)}
# How many leading params are a direction, normal or quaternion (sign free).
SIGNED = {"sphere": 0, "plane": 3, "line3d": 3, "line2d": 2, "absolute_orientation": 4,
          "ray_intersection": 0, "pivot_calibration": 0}


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _rot_z(a):
    return np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])


def _rand_rotations(rng, m):
    q = _unit(rng.normal(size=(m, 4)))
    return rotations.matrix_from_quaternion(torch.as_tensor(q)).numpy()


def far_data(kind, seed, outliers, n=N):
    """The kind's float64 numpy leaves at the origin (a tuple), with the last
    fifth outliers when ``outliers``, and the consensus mask (the inliers)."""
    rng = np.random.default_rng(seed)
    n_out = n // 5 if outliers else 0
    mask = np.arange(n) < n - n_out
    shove = rng.uniform(5.0, 20.0, (n, 1)) * ~mask[:, None]
    if kind == "sphere":
        d = _unit(rng.normal(size=(n, 3)))
        leaves = (SPHERE_C + (SPHERE_R + shove) * d + rng.normal(0, 0.05, (n, 3)),)
    elif kind == "plane":
        uv = rng.uniform(-10.0, 10.0, (n, 2))
        pts = SPHERE_C + uv[:, :1] * E1 + uv[:, 1:] * E2 + rng.normal(0, 0.05, (n, 3))
        leaves = (pts + shove * PLANE_N * rng.choice([-1.0, 1.0], (n, 1)),)
    elif kind == "line3d":
        t = rng.uniform(-10.0, 10.0, (n, 1))
        perp = _unit(np.cross(LINE_U, rng.normal(size=(n, 3))))
        leaves = (SPHERE_C + t * LINE_U + rng.normal(0, 0.05, (n, 3)) + shove * perp,)
    elif kind == "line2d":
        t = rng.uniform(-10.0, 10.0, (n, 1))
        pts = LINE2D_A + t * np.array([0.8, 0.6]) + rng.normal(0, 0.05, (n, 2))
        leaves = (pts + shove * LINE2D_N * rng.choice([-1.0, 1.0], (n, 1)),)
    elif kind == "absolute_orientation":
        first = rng.uniform(-10.0, 10.0, (n, 3))
        second = first @ _rot_z(ABSOR_ANGLE).T + ABSOR_T + rng.normal(0, 0.01, (n, 3))
        leaves = (first, second + shove * _unit(rng.normal(size=(n, 3))))
    elif kind == "ray_intersection":
        d = _unit(rng.normal(size=(n, 3)))
        p = RAY_TARGET - rng.uniform(50.0, 200.0, (n, 1)) * d + rng.normal(0, 0.05, (n, 3))
        d[~mask] = _unit(rng.normal(size=(n_out, 3)))
        leaves = (p, d)
    else:
        r = _rand_rotations(rng, n)
        t = PIVOT_TW - r @ PIVOT_TD + rng.normal(0, 0.05, (n, 3))
        leaves = (r, t + shove * _unit(rng.normal(size=(n, 3))))
    return leaves, mask


def shift(kind, leaves, s):
    """The cloud ``s`` from the origin on every axis: the points (both sets of
    a pair), the rays' origins, the frames' translations."""
    if kind == "absolute_orientation":
        return tuple(x + s for x in leaves)
    if kind in ("ray_intersection", "pivot_calibration"):
        return (leaves[0] + s * (kind == "ray_intersection"),
                leaves[1] + s * (kind == "pivot_calibration"))
    return (leaves[0] + s,)


def to_torch(kind, leaves, dtype=torch.float32, device="cpu"):
    ts = [torch.as_tensor(x, dtype=dtype, device=device) for x in leaves]
    if kind == "ray_intersection":
        return Ray3D(*ts)
    if kind == "pivot_calibration":
        return Frame(*ts)
    return tuple(ts) if kind == "absolute_orientation" else ts[0]


def make_est(kind):
    if kind == "sphere":
        return est_mod.SphereEstimator(1.0, 3, est_mod.ALGEBRAIC)
    if kind == "plane":
        return est_mod.PlaneEstimator(1.0, 3)
    if kind == "line3d":
        return est_mod.LineEstimator(1.0, 3)
    if kind == "line2d":
        return est_mod.Line2DEstimator(1.0)
    if kind == "absolute_orientation":
        return est_mod.AbsoluteOrientationEstimator(1.0)
    if kind == "ray_intersection":
        return est_mod.RayIntersectionEstimator(1.0, 0.05)
    return est_mod.PivotCalibrationEstimator(1.0)


def _jax_refit(kind, leaves, mask):
    import jax.numpy as jnp

    from lsqrrecipes_tpu import estimators as jest_mod
    from lsqrrecipes_tpu import geometry as jgeo

    est = {
        "sphere": lambda: jest_mod.SphereEstimator(1.0, 3, jest_mod.ALGEBRAIC),
        "plane": lambda: jest_mod.PlaneEstimator(1.0, 3),
        "line3d": lambda: jest_mod.LineEstimator(1.0, 3),
        "line2d": lambda: jest_mod.Line2DEstimator(1.0),
        "absolute_orientation": lambda: jest_mod.AbsoluteOrientationEstimator(1.0),
        "ray_intersection": lambda: jest_mod.RayIntersectionEstimator(1.0, 0.05),
        "pivot_calibration": lambda: jest_mod.PivotCalibrationEstimator(1.0),
    }[kind]()
    arrays = [jnp.asarray(x, dtype=jnp.float64) for x in leaves]
    data = {"ray_intersection": lambda: jgeo.Ray3D(*arrays),
            "pivot_calibration": lambda: jgeo.Frame(*arrays),
            "absolute_orientation": lambda: tuple(arrays)}.get(kind, lambda: arrays[0])()
    params, valid = est.lsq_fit(data, None if mask is None else jnp.asarray(mask))
    return np.asarray(params), bool(valid)


def _angle_deg(a, b):
    """Angle between two directions up to sign, in degrees, from float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape[-1] == 2:
        cross = abs(a[0] * b[1] - a[1] * b[0])
    else:
        cross = np.linalg.norm(np.cross(a, b))
    return float(np.degrees(np.arctan2(cross, abs(np.dot(a, b)))))


def _rotation_deg(q1, q2):
    """Angle of the rotation between two quaternions (s first), in degrees."""
    q1, q2 = _unit(np.asarray(q1, np.float64)), _unit(np.asarray(q2, np.float64))
    s = q1[0] * q2[0] + np.dot(q1[1:], q2[1:])
    v = q1[0] * q2[1:] - q2[0] * q1[1:] - np.cross(q1[1:], q2[1:])
    return float(np.degrees(2.0 * np.arctan2(np.linalg.norm(v), abs(s))))


def _axis_deg(kind, a, b):
    if kind == "absolute_orientation":
        return _rotation_deg(a[:4], b[:4])
    return _angle_deg(a[: SIGNED[kind]], b[: SIGNED[kind]])


def unshift(kind, params, s):
    """The far refit's point params moved back to the origin: the centre,
    anchor, intersection or t_W less ``s``; Horn's t as the map of the
    shifted frame, ``t - s + R s``."""
    p = np.asarray(params, np.float64).copy()
    if kind == "absolute_orientation":
        r = rotations.matrix_from_quaternion(torch.as_tensor(_unit(p[:4]))).numpy()
        p[4:] += r @ np.full(3, s) - s
    elif kind == "sphere":
        p[:3] -= s
    elif kind == "pivot_calibration":
        p[3:] -= s
    elif kind == "ray_intersection":
        p -= s
    else:
        d = SIGNED[kind]
        p[d:] -= s
    return p


def truth_errors(kind, params):
    """The refit's errors against the truth, in ``TRUTH``'s order."""
    p = np.asarray(params, np.float64)
    if kind == "sphere":
        return float(np.linalg.norm(p[:3] - SPHERE_C)), abs(float(p[3]) - SPHERE_R)
    if kind == "plane":
        return (_angle_deg(p[:3], PLANE_N),)
    if kind == "line3d":
        return (_angle_deg(p[:3], LINE_U),)
    if kind == "line2d":
        return (_angle_deg(p[:2], LINE2D_N),)
    if kind == "absolute_orientation":
        q = np.array([np.cos(ABSOR_ANGLE / 2), 0.0, 0.0, np.sin(ABSOR_ANGLE / 2)])
        return (_rotation_deg(p[:4], q),)
    if kind == "ray_intersection":
        return (float(np.linalg.norm(p - RAY_TARGET)),)
    return (float(np.abs(p[:3] - PIVOT_TD).max()), float(np.abs(p[3:] - PIVOT_TW).max()))


def _align(kind, got, want):
    """``got`` with its sign-free block turned to ``want``'s."""
    got = np.asarray(got, np.float64).copy()
    k = SIGNED[kind]
    if k and np.dot(got[:k], want[:k]) < 0:
        got[:k] = -got[:k]
    return got


def _port_refit(kind, leaves, mask, s):
    data = to_torch(kind, shift(kind, leaves, s))
    params, valid = make_est(kind).lsq_fit(data, None if mask is None else torch.as_tensor(mask))
    return params, bool(valid)


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("kind", REFITS + GUARDS)
def test_far_refit_matches_jax_f64_origin_and_truth(kind, offset, mask_kind):
    leaves, consensus = far_data(kind, 7, outliers=mask_kind == "consensus")
    mask = consensus if mask_kind == "consensus" else None
    params, valid = _port_refit(kind, leaves, mask, offset)
    assert valid and params.dtype == torch.float32
    got = params.numpy()

    # Parity: JAX's refit of the same float32 points as float64, cast.
    f32_points = [x.astype(np.float32).astype(np.float64)
                  for x in shift(kind, leaves, offset)]
    pj, vj = _jax_refit(kind, f32_points, mask)
    want = pj.astype(np.float32)
    assert vj
    got_aligned = _align(kind, got, want)
    if kind == "absolute_orientation":
        # Horn's t = mean2 - R mean1 subtracts vectors of the offset's size:
        # both packages' float64 moments leave it by |mean1| times their
        # rotation's float64 error (1.5e-5 at 1e4), so t is held to one
        # float32 ulp of the data's coordinates besides.
        np.testing.assert_allclose(got_aligned[:4], want[:4], **PARITY)
        np.testing.assert_allclose(got_aligned[4:], want[4:], rtol=PARITY["rtol"],
                                   atol=PARITY["atol"] + float(np.spacing(np.float32(offset))))
    else:
        np.testing.assert_allclose(got_aligned, want, **PARITY)

    # Translation invariance: the same cloud refitted at the origin.
    origin, _ = _port_refit(kind, leaves, mask, 0.0)
    origin = origin.numpy().astype(np.float64)
    back = _align(kind, unshift(kind, got, offset), origin)
    if SIGNED[kind]:
        assert _axis_deg(kind, back, origin) < INVARIANT_DEG
    np.testing.assert_allclose(back[SIGNED[kind]:], origin[SIGNED[kind]:], rtol=0,
                               atol=INVARIANT_POINT)

    # Truth.
    errors = truth_errors(kind, unshift(kind, got, offset))
    assert all(e < lim for e, lim in zip(errors, TRUTH[kind])), errors


def _f64_refit_as_before(kind, data, mask):
    """The refit written out as the float64 code before the float32 upcast,
    operation for operation."""
    from lsqrrecipes_tpu_torch.estimators.absolute_orientation import _horn_n_matrix
    from lsqrrecipes_tpu_torch.linalg import (
        eigvec_largest,
        eigvec_smallest,
        masked_pinv_solve,
        pinv_solve,
    )

    est = make_est(kind)
    if kind == "sphere":
        n = data.shape[0]
        a = torch.cat([-2.0 * data, torch.ones((n, 1), dtype=data.dtype)], dim=-1)
        b = -torch.sum(data * data, dim=-1)
        x, _ = pinv_solve(a, b) if mask is None else masked_pinv_solve(a, b, mask)
        r_sq = torch.sum(x[:3] * x[:3]) - x[3]
        return torch.cat([x[:3], torch.sqrt(torch.where(r_sq > 0, r_sq,
                                                        torch.ones_like(r_sq)))[None]])
    if kind == "absolute_orientation":
        first, second = data
        w = est._mask_or_ones(mask, first.shape[0], first.dtype)
        fw = first * w[:, None]
        sum1, sum2, cross, n = (torch.sum(fw, dim=0), torch.sum(second * w[:, None], dim=0),
                                fw.T @ second, torch.sum(w))
        n_safe = torch.where(n > 0, n, torch.ones_like(n))
        m = cross - torch.outer(sum1, sum2) / n_safe
        q = eigvec_largest(_horn_n_matrix(m))
        r = rotations.matrix_from_quaternion(q)
        return torch.cat([q, sum2 / n_safe - r @ (sum1 / n_safe)])
    w = est._mask_or_ones(mask, data.shape[0], data.dtype)
    if kind == "line2d":
        x, y = data[..., 0] * w, data[..., 1] * w
        stats = torch.stack([torch.sum(x), torch.sum(y), torch.sum(x * data[..., 0]),
                             torch.sum(x * data[..., 1]), torch.sum(y * data[..., 1]),
                             torch.sum(w)])
        sx, sy, sxx, sxy, syy, n = (stats[i] for i in range(6))
        n_safe = torch.where(n > 0, n, torch.ones_like(n))
        mean_x, mean_y = sx / n_safe, sy / n_safe
        c11 = sxx - n * mean_x * mean_x
        c12 = sxy - n * mean_x * mean_y
        c22 = syy - n * mean_y * mean_y
        lam1 = (c11 + c22 + torch.sqrt((c11 - c22) ** 2 + 4.0 * c12 * c12)) / 2.0
        nx, ny = -c12, lam1 - c22
        norm = torch.sqrt(nx * nx + ny * ny)
        return torch.stack([nx / norm, ny / norm, mean_x, mean_y])
    xw = data * w[:, None]
    s, outer, n = torch.sum(xw, dim=0), xw.T @ data, torch.sum(w)
    n_safe = torch.where(n > 0, n, torch.ones_like(n))
    cov = outer - torch.outer(s, s) / n_safe
    axis = eigvec_smallest(cov) if kind == "plane" else eigvec_largest(cov)
    return torch.cat([axis, s / n_safe])


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("kind", REFITS)
def test_f64_data_refits_bit_for_bit_as_before(kind, offset):
    """Float64 data: the upcast is the identity, and the refit keeps its bits."""
    leaves, consensus = far_data(kind, 11, outliers=True)
    data = to_torch(kind, shift(kind, leaves, offset), torch.float64)
    for mask in (None, torch.as_tensor(consensus)):
        params, valid = make_est(kind).lsq_fit(data, mask)
        assert bool(valid) and params.dtype == torch.float64
        assert torch.equal(params, _f64_refit_as_before(kind, data, mask))


@pytest.mark.parametrize("kind", REFITS)
def test_params_in_the_data_dtype_on_every_route(kind):
    """``lsq_fit``, the stats composed by hand, ``lsq_fit_batched``,
    ``ransac_batched`` and ``_finalize`` (through ``ransac``, and its
    invalid branch) return float32 params for float32 data, equal to
    ``lsq_fit``'s where they refit the same mask."""
    est = make_est(kind)
    leaves, consensus = far_data(kind, 13, outliers=True, n=256)
    data = to_torch(kind, shift(kind, leaves, 1e4))
    mask = torch.as_tensor(consensus)
    direct, _ = est.lsq_fit(data, mask)
    assert direct.dtype == torch.float32
    if est.has_stats:
        composed, _ = est.lsq_solve_stats(est.lsq_stats(data, mask))
        assert torch.equal(composed, direct)
    stacked = tuple(torch.stack([x, x]) for x in data) if kind == "absolute_orientation" \
        else torch.stack([data, data])
    batched, bvalid = est.lsq_fit_batched(stacked, torch.stack([mask, mask]))
    assert batched.dtype == torch.float32 and bool(bvalid.all())
    assert torch.equal(batched[0], direct)
    fleet = ransac_batched(est, stacked, [torch.Generator().manual_seed(i) for i in range(2)],
                           num_hypotheses=512)
    assert fleet.params.dtype == torch.float32 and bool(fleet.valid.all())
    res = ransac(est, data, torch.Generator().manual_seed(3), num_hypotheses=512, device="cpu")
    assert res.params.dtype == torch.float32 and bool(res.valid)
    refit, _ = est.lsq_fit(data, res.consensus)
    assert torch.equal(res.params, refit)
    n = data[0].shape[0] if kind == "absolute_orientation" else data.shape[0]
    empty = engine._finalize(est, data, torch.tensor(0), torch.zeros(n, dtype=torch.bool),
                             res.minimal_params, n)
    assert empty.params.dtype == torch.float32 and not bool(empty.valid)


def test_fused_sphere_sweep_recovers_the_radius_far_from_the_origin():
    """The main path at 1e4: ``ransac_fused_sweep`` with the ALGEBRAIC refit
    on 8,192 hypotheses finds the consensus and keeps its fit."""
    leaves, consensus = far_data("sphere", 17, outliers=True)
    pts = to_torch("sphere", shift("sphere", leaves, 1e4))
    res = ransac_fused_sweep(make_est("sphere"), pts, torch.Generator().manual_seed(5),
                             num_hypotheses=8192, device="cpu")
    assert bool(res.valid) and res.params.dtype == torch.float32
    assert int(res.best_count) == int(consensus.sum())
    p = res.params.double().numpy()
    assert abs(p[3] - SPHERE_R) < 0.02
    assert np.linalg.norm(p[:3] - 1e4 - SPHERE_C) < 0.02
