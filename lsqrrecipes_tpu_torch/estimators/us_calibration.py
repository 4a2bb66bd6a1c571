"""Freehand-3D-ultrasound probe calibration: the crosswire-phantom,
calibrated-pointer and plane-phantom estimators (counterpart of
``lsqrrecipes_tpu/estimators/us_calibration.py``).

Parity targets:
``parametersEstimators/SinglePointTargetUSCalibrationParametersEstimator.{h,cxx}``
and ``parametersEstimators/PlanePhantomUSCalibrationParametersEstimator.{h,cxx}``.
A pixel ``q = [u, v]`` of image i maps to the tracker frame through
``T2_i o T3 o scale(m_x, m_y)``, where ``T2_i = (R2_i, t2_i)`` is the tracked
pose of the probe and ``T3 = (R3(w_z, w_y, w_x), t3)`` with the pixel scales
is the calibration:

  * **Crosswire** (every image views one unknown point ``t1``): 11 minimal
    parameters ``[t1 3, t3 3, w_z, w_y, w_x, m_x, m_y]``, residual
    ``R2_i (u m_x r1 + v m_y r2 + t3) + t2_i - t1``;
  * **Pointer** (the target ``p_i`` is known per image): 8 minimal
    parameters ``[t3 3, w_z, w_y, w_x, m_x, m_y]``, residual
    ``R2_i (u m_x r1 + v m_y r2 + t3) + t2_i - p_i``;
  * **Plane phantom** (every pixel lies on one unknown plane, k = 31): 11
    minimal parameters ``[w1_y, w1_x, t1_z, t3 3, w3_z, w3_y, w3_x, m_x,
    m_y]``, scalar residual ``R1_row3 . (R2_i (u m_x r1 + v m_y r2 + t3) +
    t2_i) + t1_z``.

All have the reference's two least-squares modes: ANALYTIC (an
over-parameterised linear system by f64 SVD -- the pseudo-inverse with the
FLT_EPSILON rank gate, or the plane phantom's homogeneous null vector --
then the closest rotation by SVD and the '+sqrt' Euler extraction) and
ITERATIVE (that start, then Levenberg-Marquardt on the minimal parameters;
the crosswire's residual and Jacobian in closed form, on CUDA tensors from
the kernel ``csrc/us_residual.cu``, the pointer's and the plane phantom's
Jacobians by ``torch.func.jacfwd`` of the residual).  Parameter vectors
append derived entries for a cheap ``agree``: ``m_x R3(:,1), m_y R3(:,2),
R3(:,3)`` (crosswire 20, pointer 17 entries) or the plane phantom's 30
(41).  Data: ``(Frame[n], q[n, 2])`` and ``(Frame[n], q[n, 2], p[n, 3])``;
``minimal_fit`` and ``agree`` broadcast over leading axes.
"""

import math

import torch

from lsqrrecipes_tpu_torch import kernels
from lsqrrecipes_tpu_torch.config import EPS, HALF_PI, SMALL_ANGLE
from lsqrrecipes_tpu_torch.device import full_f32_matmul
from lsqrrecipes_tpu_torch.estimators.base import Estimator, register
from lsqrrecipes_tpu_torch.linalg.lm import LMConfig, levenberg_marquardt
from lsqrrecipes_tpu_torch.linalg.lstsq import pinv_solve, svd_f64
from lsqrrecipes_tpu_torch.utils import profiling

ANALYTIC = "analytic"
ITERATIVE = "iterative"

# ``SinglePointTarget...cxx:195-197``: the FLT_EPSILON singular-value
# threshold of the analytic solves.
FLT_EPS = 1.192092896e-07

_LM_CONFIG = LMConfig(max_iters=200)

# Cells of one [chunk, n] block of the batched matmul vote.
_VOTE_CELLS = 1 << 24


def _crosswire_features(data):
    """``[n, 31]`` = ``[u vec(R2), v vec(R2), vec(R2), t2, 1]``."""
    frames, q = data
    r2 = frames.r.reshape(-1, 9)
    ones = torch.ones((q.shape[0], 1), dtype=q.dtype, device=q.device)
    return torch.cat([q[:, 0:1] * r2, q[:, 1:2] * r2, r2, frames.t, ones], dim=-1)


def _pointer_features(data):
    """``[n, 30]`` = ``[u vec(R2), v vec(R2), vec(R2), t2 - p]``."""
    frames, q, p = data
    r2 = frames.r.reshape(-1, 9)
    return torch.cat([q[:, 0:1] * r2, q[:, 1:2] * r2, r2, frames.t - p], dim=-1)


def _euler_zyx_matrix(wz, wy, wx):
    """``R = Rz(wz) Ry(wy) Rx(wx)`` ``[..., 3, 3]`` (``Frame.cxx:626-648``)."""
    cz, sz = torch.cos(wz), torch.sin(wz)
    cy, sy = torch.cos(wy), torch.sin(wy)
    cx, sx = torch.cos(wx), torch.sin(wx)
    rows = [
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ]
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def _extract_euler_plus(r3):
    """The reference's '+sqrt' Euler-ZYX extraction with the gimbal branch
    (``SinglePointTarget...cxx:230-247``) of ``r3[..., 3, 3]`` ->
    ``(w_z, w_y, w_x)``."""
    wy = torch.atan2(-r3[..., 2, 0], torch.sqrt(r3[..., 0, 0] ** 2 + r3[..., 1, 0] ** 2))
    gimbal = ~(((wy - HALF_PI).abs() > SMALL_ANGLE) & ((wy + HALF_PI).abs() > SMALL_ANGLE))
    cy = torch.where(gimbal, torch.ones_like(wy), torch.cos(wy))
    wz = torch.where(gimbal, torch.zeros_like(wy),
                     torch.atan2(r3[..., 1, 0] / cy, r3[..., 0, 0] / cy))
    wx = torch.where(gimbal, torch.atan2(r3[..., 0, 1], r3[..., 1, 1]),
                     torch.atan2(r3[..., 2, 1] / cy, r3[..., 2, 2] / cy))
    return wz, wy, wx


def _orthonormalize_scaled_columns(c1, c2):
    """Scales and closest rotation from the raw scaled columns ``c1, c2
    [..., 3]``: ``m_x = |c1|``, ``m_y = |c2|``, ``R3 = U V^T`` of the SVD of
    ``[c1/m_x, c2/m_y, r1 x r2]`` (``SinglePointTarget...cxx:204-229``)."""
    m_x = torch.sqrt(torch.sum(c1 * c1, dim=-1))
    m_y = torch.sqrt(torch.sum(c2 * c2, dim=-1))
    r1 = c1 / torch.where(m_x > 0, m_x, torch.ones_like(m_x))[..., None]
    r2 = c2 / torch.where(m_y > 0, m_y, torch.ones_like(m_y))[..., None]
    raw = torch.stack([r1, r2, torch.linalg.cross(r1, r2, dim=-1)], dim=-1)
    u, _, vt = svd_f64(raw)
    return m_x, m_y, (u @ vt).to(raw.dtype)


def _pinv_solve_masked3(a, b, mask, eps):
    """``pinv_solve`` where each observation contributes 3 stacked rows
    (``mask [..., n]`` may add leading axes to ``a`` and ``b``)."""
    if mask is not None:
        m = torch.repeat_interleave(mask, 3, dim=-1).to(a.dtype)
        a = a * m[..., None]
        b = b * m
    return pinv_solve(a, b, eps)


def _rotation_block(m_x, m_y, r3):
    """``[m_x R3(:,1), m_y R3(:,2), R3(:,3)]`` ``[..., 9]``."""
    return torch.cat([m_x[..., None] * r3[..., :, 0], m_y[..., None] * r3[..., :, 1],
                      r3[..., :, 2]], dim=-1)


def _image_points(q, c1, c2, t3):
    """``u c1 + v c2 + t3`` per observation (``[..., n, 3]``)."""
    return q[..., :, 0:1] * c1 + q[..., :, 1:2] * c2 + t3


def _mapped(frames, img):
    """``R2_i img_i + t2_i`` for ``img[..., n, 3]``."""
    return torch.einsum("nij,...nj->...ni", frames.r, img) + frames.t


def _rotate3(r, v):
    """``r[..., 3, 3] @ v[..., 3, m]`` as ``(r_k0 v_0 + r_k1 v_1) + r_k2 v_2``,
    each product and sum rounded on its own: the order of
    ``csrc/us_residual.cu``."""
    return (r[..., :, 0, None] * v[..., None, 0, :] + r[..., :, 1, None] * v[..., None, 1, :]) \
        + r[..., :, 2, None] * v[..., None, 2, :]


def _crosswire_residual_plain(x, data):
    """3n residuals ``R2_i (u m_x r1 + v m_y r2 + t3) + t2_i - t1`` for
    ``x[..., 11] = [t1 3, t3 3, w_z, w_y, w_x, m_x, m_y]``
    (``SinglePointTarget...cxx:415-509``), ``[..., 3n]``: the leading
    problem axes of ``x`` and of the data (``r2 [..., n, 3, 3]``)."""
    frames, q = data
    r = _euler_zyx_matrix(x[..., 6], x[..., 7], x[..., 8])
    c1 = (x[..., 9, None] * r[..., :, 0])[..., None, :]
    c2 = (x[..., 10, None] * r[..., :, 1])[..., None, :]
    img = _image_points(q, c1, c2, x[..., None, 3:6])
    res = _rotate3(frames.r, img[..., None])[..., 0] + frames.t - x[..., None, 0:3]
    return res.reshape(*res.shape[:-2], -1)


def _crosswire_jacobian_plain(x, data):
    """The closed-form Jacobian ``[..., 3n, 11]`` of
    :func:`_crosswire_residual_plain`: with ``R = Rz Ry Rx`` of columns
    ``c0, c1, c2`` and ``p_i = u m_x c0 + v m_y c1 + t3``, image i's rows are
    ``-I`` (t1), ``R2_i`` (t3), ``R2_i (u m_x dc0/dw + v m_y dc1/dw)`` (each
    angle; ``dc0/dw_x = 0``, ``dc1/dw_x = c2``), ``R2_i (u c0)`` (m_x) and
    ``R2_i (v c1)`` (m_y)."""
    frames, q = data
    wz, wy, wx = x[..., 6], x[..., 7], x[..., 8]
    cz, sz = torch.cos(wz), torch.sin(wz)
    cy, sy = torch.cos(wy), torch.sin(wy)
    cx, sx = torch.cos(wx), torch.sin(wx)
    zero = torch.zeros_like(cz)
    c0 = torch.stack([cz * cy, sz * cy, -sy], dim=-1)
    c1 = torch.stack([cz * sy * sx - sz * cx, sz * sy * sx + cz * cx, cy * sx], dim=-1)
    c2 = torch.stack([cz * sy * cx + sz * sx, sz * sy * cx - cz * sx, cy * cx], dim=-1)
    dc0_z = torch.stack([-sz * cy, cz * cy, zero], dim=-1)
    dc1_z = torch.stack([-c1[..., 1], c1[..., 0], zero], dim=-1)
    dc0_y = torch.stack([-cz * sy, -sz * sy, -cy], dim=-1)
    dc1_y = torch.stack([cz * cy * sx, sz * cy * sx, -sy * sx], dim=-1)
    umx = (q[..., 0] * x[..., 9, None])[..., None]          # [..., n, 1]
    vmy = (q[..., 1] * x[..., 10, None])[..., None]
    u, v = q[..., 0, None], q[..., 1, None]

    def per_image(a):
        return a[..., None, :]                               # [..., 1, 3]

    cols = torch.stack([
        umx * per_image(dc0_z) + vmy * per_image(dc1_z),
        umx * per_image(dc0_y) + vmy * per_image(dc1_y),
        vmy * per_image(c2),
        u * per_image(c0),
        v * per_image(c1),
    ], dim=-1)                                               # [..., n, 3, 5]
    rot = frames.r
    eye = -torch.eye(3, dtype=rot.dtype, device=rot.device).expand(rot.shape)
    jac = torch.cat([eye, rot, _rotate3(rot, cols)], dim=-1)           # [..., n, 3, 11]
    return jac.reshape(*jac.shape[:-3], -1, 11)


def _crosswire_cuda(x, data, jacobian):
    """Launch ``csrc/us_residual.cu`` on the current stream for
    :func:`_crosswire_residual` (``jacobian`` False) or
    :func:`_crosswire_jacobian`: ``x[..., 11]`` and the data in one dtype,
    float32 or float64, the data with ``x``'s leading axes.  Raises on a
    non-CUDA or mixed-dtype input, data of other leading axes, and when the
    build or the launch fails."""
    frames, q = data
    lead, n = x.shape[:-1], q.shape[-2]
    if x.shape[-1] != 11 or frames.r.shape[-3:] != (n, 3, 3) or frames.t.shape[-2:] != (n, 3):
        raise ValueError("crosswire residual takes x[..., 11], r2[..., n, 3, 3], t2[..., n, 3], "
                         "q[..., n, 2]")
    if q.shape[:-2] != lead or frames.r.shape[:-3] != lead or frames.t.shape[:-2] != lead:
        raise ValueError(f"crosswire data must have x's leading axes {tuple(lead)}")
    x, r2, t2, q = x.contiguous(), frames.r.contiguous(), frames.t.contiguous(), q.contiguous()
    kernels.check_inputs((torch.float32, torch.float64), x=x, r2=r2, t2=t2, q=q)
    if len({x.dtype, r2.dtype, t2.dtype, q.dtype}) != 1:
        raise ValueError("crosswire residual takes x and its data in one dtype")
    b = math.prod(lead)
    if b >= 2**31 or 33 * n >= 2**31:
        raise ValueError("crosswire residual supports fewer than 2^31 problems and rows")
    shape = (*lead, 3 * n, 11) if jacobian else (*lead, 3 * n)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if out.numel():
        res_ptr, jac_ptr = (None, out.data_ptr()) if jacobian else (out.data_ptr(), None)
        with torch.cuda.device(x.device):
            kernels.US_CROSSWIRE.launch(
                x.data_ptr(), r2.data_ptr(), t2.data_ptr(), q.data_ptr(), b, n,
                int(x.dtype == torch.float64), res_ptr, jac_ptr,
                torch.cuda.current_stream().cuda_stream)
    return out


def _crosswire_residual(x, data):
    """:func:`_crosswire_residual_plain` of ``x[..., 11]``: on CUDA tensors
    the kernel ``csrc/us_residual.cu``, on CPU tensors the plain version."""
    if x.is_cuda:
        return _crosswire_cuda(x, data, jacobian=False)
    return _crosswire_residual_plain(x, data)


def _crosswire_jacobian(x, data):
    """:func:`_crosswire_jacobian_plain` of ``x[..., 11]``, ``[..., 3n,
    11]``: on CUDA tensors the kernel ``csrc/us_residual.cu``, on CPU
    tensors the plain version."""
    if x.is_cuda:
        return _crosswire_cuda(x, data, jacobian=True)
    return _crosswire_jacobian_plain(x, data)


def _pointer_residual(x, data):
    """3n residuals ``R2_i (u m_x r1 + v m_y r2 + t3) + t2_i - p_i`` for
    ``x = [t3 3, w_z, w_y, w_x, m_x, m_y]`` (``SinglePointTarget...cxx:1059-1149``)."""
    frames, q, p = data
    r = _euler_zyx_matrix(x[3], x[4], x[5])
    img = _image_points(q, x[6] * r[:, 0], x[7] * r[:, 1], x[0:3])
    return (_mapped(frames, img) - p).reshape(-1)


_pointer_jacobian = torch.func.jacfwd(_pointer_residual)


def _pack_crosswire(x):
    """Minimal 11 -> the 20-parameter layout (leading axes allowed)."""
    r = _euler_zyx_matrix(x[..., 6], x[..., 7], x[..., 8])
    return torch.cat([x, _rotation_block(x[..., 9], x[..., 10], r)], dim=-1)


def _pack_pointer(x):
    """Minimal 8 -> the 17-parameter layout (leading axes allowed)."""
    r = _euler_zyx_matrix(x[..., 3], x[..., 4], x[..., 5])
    return torch.cat([x, _rotation_block(x[..., 6], x[..., 7], r)], dim=-1)


def _matmul_vote(a_rows, feats, delta_sq):
    """``#{i: sum_j (f_i . a_j)^2 < delta^2}`` per hypothesis, for ``a_rows``
    three ``[B, F]`` blocks over features ``[n, F]``, chunked over B."""
    b, n = a_rows[0].shape[0], feats.shape[0]
    chunk = max(1, _VOTE_CELLS // max(1, n))
    out = []
    with full_f32_matmul():
        for b0 in range(0, b, chunk):
            d2 = None
            for a in a_rows:
                e = a[b0 : b0 + chunk] @ feats.T
                d2 = e * e if d2 is None else d2 + e * e
            out.append(torch.sum(d2 < delta_sq, dim=-1))
    return torch.cat(out) if out else torch.zeros((0,), dtype=torch.int64, device=feats.device)


def _vote_blocks(params, cols, const_cols, const_rows):
    """The three ``[B, F]`` affine rows ``a_j`` of the matmul votes: the 3x3
    blocks of ``cols`` (each ``[B, 3]`` of params) at row j, then the unit
    vector ``e_j`` over ``const_cols`` columns and ``const_rows(j)``."""
    b, dt, dev = params.shape[0], params.dtype, params.device
    rows = []
    for j in range(3):
        blocks = []
        for c in cols:
            blk = torch.zeros((b, 3, 3), dtype=dt, device=dev)
            blk[:, j, :] = c
            blocks.append(blk.reshape(b, 9))
        unit = torch.zeros((b, const_cols), dtype=dt, device=dev)
        unit[:, j] = 1.0
        rows.append(torch.cat(blocks + [unit] + const_rows(j), dim=-1))
    return rows


class _USCalibrationEstimator(Estimator):
    """What the three probe calibrations share: the analytic fit as the
    minimal fit, the refits from it, and the batched and structured sweeps
    of :mod:`lsqrrecipes_tpu_torch.ops.us_fast`.  A subclass gives
    ``_analytic`` and declares its kind in ``us_fast`` and ``stats_lm``
    (``_kind``), the length of its minimal parameters (``_n_min``), its
    residual rows per observation (``_rows``), ``_pack`` (minimal -> the
    full layout), and its residual and Jacobian of one problem and of B
    problems on a leading axis (``_residual_batched``,
    ``_jacobian_batched``), each a ``staticmethod``."""

    _kind: str
    _n_min: int
    _rows: int

    def __init__(self, delta, ls_type=ITERATIVE, lm_config=_LM_CONFIG):
        self.delta = float(delta)
        self.delta_squared = float(delta) ** 2
        if ls_type not in (ANALYTIC, ITERATIVE):
            raise ValueError(f"unknown least-squares type {ls_type!r}")
        self.ls_type = ls_type
        self.lm_config = lm_config

    def minimal_fit(self, samples):
        return self._analytic(samples)

    def lsq_fit(self, data, mask=None):
        return self._lsq_fit(self._residual, self._jacobian, data, mask)

    def lsq_fit_batched(self, data, mask=None):
        """``lsq_fit`` of B problems stacked on a leading axis (``data``
        leaves ``[B, n, ...]``, ``mask [B, n]``): one batched LM."""
        return self._lsq_fit(self._residual_batched, self._jacobian_batched, data, mask)

    def _lsq_fit(self, residual_fn, jac_fn, data, mask):
        """The analytic fit, then (ITERATIVE) Levenberg-Marquardt from its first
        ``_n_min`` parameters on the masked residuals (``_rows`` per
        observation); with leading problem axes when ``residual_fn`` and
        ``jac_fn`` take them."""
        with profiling.leaf("refit.start"):
            params, valid = self._analytic(data, mask)
        if self.ls_type == ANALYTIC:
            return params, valid
        x0 = params[..., :self._n_min]
        lm_mask = (mask if mask is None or self._rows == 1
                   else torch.repeat_interleave(mask, self._rows, dim=-1))
        result = levenberg_marquardt(residual_fn, jac_fn, x0, data, mask=lm_mask,
                                     config=self.lm_config)
        x = torch.where(valid[..., None], result.x, x0)
        return self._pack(x), valid & result.converged

    def lsq_fit_stats_batched(self, data, masks=None, x0=None, config=None):
        """B ITERATIVE refits on SHARED data through the sufficient-statistics LM
        (:mod:`lsqrrecipes_tpu_torch.linalg.stats_lm`): one observation set, B
        inlier masks ``[B, n]`` and/or B starts ``x0 [B, _n_min]``.  Each
        problem's Gauss-Newton structure collapses onto its feature Gram, so
        the solves do no per-iteration work in n, unlike
        :meth:`lsq_fit_batched`, which re-evaluates every residual and
        Jacobian row.  The starts are the analytic fit under each mask.
        Returns ``(params [B, P_full], valid [B])``."""
        from lsqrrecipes_tpu_torch.linalg import stats_lm

        if x0 is None:
            if masks is None:
                raise ValueError("need masks and/or x0 to define the B problems")
            params0, valid0 = self._analytic(data, masks)
            x0 = params0[:, :self._n_min]
        else:
            valid0 = torch.ones(x0.shape[0], dtype=torch.bool, device=x0.device)
        res = stats_lm.us_feature_lm_batched(self._kind, data, x0, masks,
                                             config=self.lm_config if config is None else config)
        x = torch.where(valid0[:, None], res.x, x0)
        return self._pack(x), valid0 & res.converged

    def fit_and_vote(self, samples, data):
        """Batched hypothesize and vote on the engine's samples
        (:func:`lsqrrecipes_tpu_torch.ops.us_fast.fit_and_vote`)."""
        from lsqrrecipes_tpu_torch.ops import us_fast

        return us_fast.fit_and_vote(self._kind, self, samples, data)

    def structured_sweep(self, data, generator, groups, perm=None):
        """The planar-lane structured sweep (the hypotheses of
        ``structured_samples`` with the same permutation;
        :func:`lsqrrecipes_tpu_torch.ops.us_fast.structured_sweep`)."""
        from lsqrrecipes_tpu_torch.ops import us_fast

        return us_fast.structured_sweep(self._kind, self, data, generator, groups, perm)


@register("us_crosswire")
class CrosswireUSCalibrationEstimator(_USCalibrationEstimator):
    """``SingleUnknownPointTargetUSCalibrationParametersEstimator``.

    Data: ``(Frame[n], q[n, 2])``.  Output layout (20):
    ``[t1 3, t3 3, w_z, w_y, w_x, m_x, m_y, m_x R3(:,1), m_y R3(:,2), R3(:,3)]``.
    """

    k = 4
    nparams = 20
    nparams_lsq = 20
    fused_family = "crosswire"
    _kind, _n_min, _rows = "crosswire", 11, 3
    _pack = staticmethod(_pack_crosswire)
    # The closed form takes leading problem axes: the batched LM needs no vmap.
    _residual = _residual_batched = staticmethod(_crosswire_residual)
    _jacobian = _jacobian_batched = staticmethod(_crosswire_jacobian)

    def _analytic(self, data, mask=None):
        """3n x 12 system ``[u R2, v R2, R2, -I] x = -t2``, batched over
        leading axes (``SinglePointTarget...cxx:120-270``)."""
        frames, q = data
        r, t = frames.r, frames.t
        u, v = q[..., 0, None, None], q[..., 1, None, None]
        eye = -torch.eye(3, dtype=q.dtype, device=q.device).expand(r.shape)
        a = torch.cat([u * r, v * r, r, eye], dim=-1).reshape(*q.shape[:-2], -1, 12)
        x, rank = _pinv_solve_masked3(a, (-t).reshape(*q.shape[:-2], -1), mask, FLT_EPS)
        m_x, m_y, r3 = _orthonormalize_scaled_columns(x[..., 0:3], x[..., 3:6])
        angles = torch.stack(_extract_euler_plus(r3), dim=-1)
        params = torch.cat([x[..., 9:12], x[..., 6:9], angles, m_x[..., None], m_y[..., None],
                            _rotation_block(m_x, m_y, r3)], dim=-1)
        return params, rank >= 12

    def agree(self, params, data):
        """``|T2 (R3 S q + t3) - t1|^2 < delta^2`` (``SinglePointTarget...cxx:74-107``)."""
        frames, q = data
        img = _image_points(q, params[..., None, 11:14], params[..., None, 14:17],
                            params[..., None, 3:6])
        err = _mapped(frames, img) - params[..., None, 0:3]
        return torch.sum(err * err, dim=-1) < self.delta_squared

    def vote_counts(self, params, data):
        """Each residual component is affine in the per-observation features
        ``[u vec(R2), v vec(R2), vec(R2), t2, 1]``: three ``[n, 31] @ [31, B]``
        products in full f32 (or f64), chunked over hypotheses."""
        rows = _vote_blocks(params, [params[:, 11:14], params[:, 14:17], params[:, 3:6]], 3,
                            lambda j: [-params[:, j : j + 1]])
        return _matmul_vote(rows, _crosswire_features(data), self.delta_squared)

    def distance_statistics(self, params, data):
        frames, q = data
        img = _image_points(q, params[11:14], params[14:17], params[3:6])
        d = torch.sqrt(torch.sum((_mapped(frames, img) - params[0:3]) ** 2, dim=-1))
        return d, torch.min(d), torch.max(d), torch.mean(d)


@register("us_pointer")
class PointerUSCalibrationEstimator(_USCalibrationEstimator):
    """``CalibratedPointerTargetUSCalibrationParametersEstimator``.

    Data: ``(Frame[n], q[n, 2], p[n, 3])``.  Output layout (17):
    ``[t3 3, w_z, w_y, w_x, m_x, m_y, m_x R3(:,1), m_y R3(:,2), R3(:,3)]``.
    """

    k = 3
    nparams = 17
    nparams_lsq = 17
    fused_family = "pointer"
    _kind, _n_min, _rows = "pointer", 8, 3
    _pack = staticmethod(_pack_pointer)
    _residual = staticmethod(_pointer_residual)
    _jacobian = staticmethod(_pointer_jacobian)
    _residual_batched = staticmethod(torch.func.vmap(_pointer_residual))
    _jacobian_batched = staticmethod(torch.func.vmap(_pointer_jacobian))

    def _analytic(self, data, mask=None):
        """3n x 9 system ``[u R2, v R2, R2] x = p - t2``, batched over
        leading axes (``SinglePointTarget...cxx:763-914``)."""
        frames, q, p = data
        r = frames.r
        u, v = q[..., 0, None, None], q[..., 1, None, None]
        a = torch.cat([u * r, v * r, r], dim=-1).reshape(*q.shape[:-2], -1, 9)
        b = (p - frames.t).reshape(*q.shape[:-2], -1)
        x, rank = _pinv_solve_masked3(a, b, mask, FLT_EPS)
        m_x, m_y, r3 = _orthonormalize_scaled_columns(x[..., 0:3], x[..., 3:6])
        angles = torch.stack(_extract_euler_plus(r3), dim=-1)
        params = torch.cat([x[..., 6:9], angles, m_x[..., None], m_y[..., None],
                            _rotation_block(m_x, m_y, r3)], dim=-1)
        return params, rank >= 9

    def agree(self, params, data):
        """``|T2 T3 q - p|^2 < delta^2`` (``SinglePointTarget...cxx:728-761``)."""
        frames, q, p = data
        img = _image_points(q, params[..., None, 8:11], params[..., None, 11:14],
                            params[..., None, 0:3])
        err = _mapped(frames, img) - p
        return torch.sum(err * err, dim=-1) < self.delta_squared

    def vote_counts(self, params, data):
        """Three ``[n, 30] @ [30, B]`` products (the target folds into the
        ``t2 - p`` feature columns)."""
        rows = _vote_blocks(params, [params[:, 8:11], params[:, 11:14], params[:, 0:3]], 3,
                            lambda j: [])
        return _matmul_vote(rows, _pointer_features(data), self.delta_squared)

    def distance_statistics(self, params, data):
        frames, q, p = data
        img = _image_points(q, params[8:11], params[11:14], params[0:3])
        d = torch.sqrt(torch.sum((_mapped(frames, img) - p) ** 2, dim=-1))
        return d, torch.min(d), torch.max(d), torch.mean(d)


# --------------------------------------------------------------------------
# Plane phantom
# --------------------------------------------------------------------------


def _plane_normal(w1_y, w1_x):
    """R1's third row ``[-sin w1_y, cos w1_y sin w1_x, cos w1_y cos w1_x]``."""
    cy1, sy1 = torch.cos(w1_y), torch.sin(w1_y)
    return torch.stack([-sy1, cy1 * torch.sin(w1_x), cy1 * torch.cos(w1_x)], dim=-1)


def _plane_phantom_residual(x, data):
    """n residuals ``R1_row3 . (R2_i (u m_x r1 + v m_y r2 + t3) + t2_i) +
    t1_z`` for ``x = [w1_y, w1_x, t1_z, t3 3, w3_z, w3_y, w3_x, m_x, m_y]``
    (``PlanePhantom...cxx:357-447``)."""
    frames, q = data
    r = _euler_zyx_matrix(x[6], x[7], x[8])
    img = _image_points(q, x[9] * r[:, 0], x[10] * r[:, 1], x[3:6])
    return _mapped(frames, img) @ _plane_normal(x[0], x[1]) + x[2]


_plane_phantom_jacobian = torch.func.jacfwd(_plane_phantom_residual)


def _plane_phantom_derived(r1_row3, t3, r3, m_x, m_y):
    """The 30 derived entries (``PlanePhantom...cxx:319-355``), batched over
    leading axes: for j over R1's columns, ``m_x R3(k, 0) R1_3j`` (9), then
    ``m_y R3(k, 1) R1_3j`` (9), ``t3_k R1_3j`` (9), then ``R1_row3`` (3)."""
    lead = r1_row3.shape[:-1]
    m1 = m_x[..., None, None] * (r1_row3[..., :, None] * r3[..., None, :, 0])
    m2 = m_y[..., None, None] * (r1_row3[..., :, None] * r3[..., None, :, 1])
    m3 = r1_row3[..., :, None] * t3[..., None, :]
    return torch.cat([m1.reshape(*lead, 9), m2.reshape(*lead, 9), m3.reshape(*lead, 9),
                      r1_row3], dim=-1)


def _pack_phantom(x):
    """Minimal 11 -> the 41-parameter layout (leading axes allowed)."""
    r3 = _euler_zyx_matrix(x[..., 6], x[..., 7], x[..., 8])
    return torch.cat([x, _plane_phantom_derived(_plane_normal(x[..., 0], x[..., 1]), x[..., 3:6],
                                                r3, x[..., 9], x[..., 10])], dim=-1)


def _phantom_sign(x):
    """The minimal 11 (leading axes allowed) with the plane's sign rule
    (:meth:`PlanePhantomUSCalibrationEstimator._analytic`) applied: where
    ``R1_row3[2] = cos w1_y cos w1_x < 0``, the mirrored plane ``w1_y ->
    -w1_y``, ``w1_x -> w1_x -+ pi`` (kept in ``(-pi, pi]``), ``t1_z -> -t1_z``,
    which gives every residual the opposite sign and the same cost."""
    flip = torch.cos(x[..., 0]) * torch.cos(x[..., 1]) < 0
    wx = torch.where(x[..., 1] > 0, x[..., 1] - math.pi, x[..., 1] + math.pi)
    mirrored = torch.stack([-x[..., 0], wx, -x[..., 2]], dim=-1)
    return torch.cat([torch.where(flip[..., None], mirrored, x[..., 0:3]), x[..., 3:]], dim=-1)


def _pack_phantom_signed(x):
    """:func:`_pack_phantom` of the minimal 11 under the sign rule: the
    refits' LMs run from a start that keeps it (or a caller's ``x0``), and
    their result is held to it again."""
    return _pack_phantom(_phantom_sign(x))


@register("us_plane_phantom")
class PlanePhantomUSCalibrationEstimator(_USCalibrationEstimator):
    """``PlanePhantomUSCalibrationParametersEstimator`` (k = 31).

    Data: ``(Frame[n], q[n, 2])``.  Output layout (41):
    ``[w1_y, w1_x, t1_z, t3 3, w3_z, w3_y, w3_x, m_x, m_y, 30 derived]``.
    """

    k = 31
    nparams = 41
    nparams_lsq = 41
    _kind, _n_min, _rows = "plane_phantom", 11, 1
    _pack = staticmethod(_pack_phantom_signed)
    _residual = staticmethod(_plane_phantom_residual)
    _jacobian = staticmethod(_plane_phantom_jacobian)
    _residual_batched = staticmethod(torch.func.vmap(_plane_phantom_residual))
    _jacobian_batched = staticmethod(torch.func.vmap(_plane_phantom_jacobian))

    def _analytic(self, data, mask=None):
        """Homogeneous ``n x 31`` system ``[u vec(R2), v vec(R2), vec(R2), t2,
        1]``, batched over leading axes: its null vector (the last right
        singular vector of the f64 SVD) scaled to ``|R1_row3| = 1``, then t3,
        R3 and the scales from the averages of the three R1-column groups
        (``PlanePhantom...cxx:137-355``).  Valid where the null space is one
        dimensional (``s[29] > FLT_EPS max(s[0], 1)``: the reference's
        literal rank-31 test would reject clean minimal samples, which have
        an exact null vector), ``|R1_row3| >= EPS`` and at least k
        observations take part.

        The null vector has no sign of its own (the reference keeps whichever
        the SVD gives), so one rule fixes it: ``R1_row3[2] >= 0``, the plane
        normal's tracker-z component.  It changes only ``w1_y``, ``w1_x``,
        ``t1_z`` and the derived entries, never t3, R3, the scales, the
        validity or ``agree``.  A plane seen from a tracked probe rarely lies
        edge-on to the tracker's z axis (the simulated phantoms keep the
        component at ``cos w1_y cos w1_x >= cos(1)^2 ~ 0.29``), so the rule
        does not flip between nearby fits; ``lsq_fit``, ``lsq_fit_batched``
        and ``lsq_fit_stats_batched`` hold the LM's result to it too (the
        B6 fast path's minimal params keep the subspace's sign)."""
        frames, q = data
        r = frames.r
        u, v = q[..., 0, None, None], q[..., 1, None, None]
        lead = q.shape[:-1]
        a = torch.cat([(u * r).reshape(*lead, 9), (v * r).reshape(*lead, 9), r.reshape(*lead, 9),
                       frames.t, torch.ones(*lead, 1, dtype=q.dtype, device=q.device)], dim=-1)
        if mask is not None:
            a = a * mask.to(a.dtype)[..., None]
        _, s, vt = svd_f64(a, full_matrices=True)
        x = vt[..., -1, :].to(a.dtype)
        x = torch.where(x[..., 29:30] < 0, -x, x)          # the sign rule: R1_row3[2] >= 0
        if s.shape[-1] > 29:
            rank_ok = s[..., 29] > FLT_EPS * torch.clamp_min(s[..., 0], 1.0)
        else:                       # fewer than 30 rows: never a unique null space
            rank_ok = torch.zeros(s.shape[:-1], dtype=torch.bool, device=s.device)

        denom = torch.sqrt(torch.sum(x[..., 27:30] ** 2, dim=-1))
        nondegenerate = denom >= EPS                       # the EPS gate, cxx:216-218
        x = x / torch.where(nondegenerate, denom, torch.ones_like(denom))[..., None]
        r1_row3, t1_z = x[..., 27:30], x[..., 30]
        wy1 = torch.atan2(-r1_row3[..., 0], torch.sqrt(r1_row3[..., 1] ** 2 + r1_row3[..., 2] ** 2))
        gimbal = ~(((wy1 - HALF_PI).abs() > SMALL_ANGLE) & ((wy1 + HALF_PI).abs() > SMALL_ANGLE))
        cy1 = torch.where(gimbal, torch.ones_like(wy1), torch.cos(wy1))
        wx1 = torch.where(gimbal, torch.zeros_like(wy1),
                          torch.atan2(r1_row3[..., 1] / cy1, r1_row3[..., 2] / cy1))

        # Average the three R1-column groups (cxx:246-287), each division
        # guarded.
        inv = 1.0 / torch.where(r1_row3.abs() > 1e-300, r1_row3, torch.ones_like(r1_row3))
        c1, c2, t3 = (torch.mean(x[..., b : b + 9].reshape(*x.shape[:-1], 3, 3) * inv[..., :, None],
                                 dim=-2) for b in (0, 9, 18))
        m_x, m_y, r3 = _orthonormalize_scaled_columns(c1, c2)
        angles = torch.stack(_extract_euler_plus(r3), dim=-1)
        params = torch.cat([wy1[..., None], wx1[..., None], t1_z[..., None], t3, angles,
                            m_x[..., None], m_y[..., None],
                            _plane_phantom_derived(r1_row3, t3, r3, m_x, m_y)], dim=-1)
        n = q.shape[-2]
        enough = (torch.sum(mask, dim=-1) >= self.k) if mask is not None else \
            torch.tensor(n >= self.k, device=q.device)
        return params, rank_ok & nondegenerate & enough

    def agree(self, params, data):
        """``err^2 < delta^2`` with the plane distance ``err = vec(R2) . (u m1
        + v m2 + m3) + t2 . R1_row3 + t1_z`` over the derived parameters
        (``PlanePhantom...cxx:73-117``)."""
        frames, q = data
        err = self._plane_distance(params[..., None, :], frames, q)
        return err * err < self.delta_squared

    @staticmethod
    def _plane_distance(params, frames, q):
        r2 = frames.r.reshape(-1, 9)
        img = q[..., :, 0:1] * params[..., 11:20] + q[..., :, 1:2] * params[..., 20:29] \
            + params[..., 29:38]
        return (torch.sum(r2 * img, dim=-1) + torch.sum(frames.t * params[..., 38:41], dim=-1)
                + params[..., 2])

    def vote_counts(self, params, data):
        """The plane residual is one affine form over the crosswire features:
        one ``[n, 31] @ [31, B]`` product in full f32 (or f64) with ``a = [m1,
        m2, m3, R1_row3, t1_z]``, chunked over hypotheses."""
        a = torch.cat([params[:, 11:41], params[:, 2:3]], dim=-1)
        return _matmul_vote([a], _crosswire_features(data), self.delta_squared)

    def distance_statistics(self, params, data):
        frames, q = data
        d = self._plane_distance(params, frames, q).abs()
        return d, torch.min(d), torch.max(d), torch.mean(d)
