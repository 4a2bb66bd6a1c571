"""Pivot calibration estimator, params ``[t_DRF(3), t_W(3)]`` (counterpart
of ``lsqrrecipes_tpu/estimators/pivot_calibration.py``).

Parity target: ``PivotCalibrationParametersEstimator.{h,cxx}`` (Yaniv, SPIE
2015): a tracked tool pivots about a fixed point and each pose contributes
``[R_i  -I] [t_DRF; t_W] = -t_i``.  Data is a batched
:class:`~lsqrrecipes_tpu_torch.geometry.Frame`.
"""

import torch

from lsqrrecipes_tpu_torch.estimators.base import Estimator, register
from lsqrrecipes_tpu_torch.geometry import Frame
from lsqrrecipes_tpu_torch.linalg import masked_pinv_solve, pinv_solve


def _stack_system(frames: Frame):
    """``A[..., 3n, 6] = [R_i, -I]`` and ``b[..., 3n] = -t_i`` over the
    frames' second-to-last axis (``PivotCalibrationParametersEstimator.cxx:63-96``)."""
    r, t = frames.r, frames.t
    n = t.shape[-2]
    eye = -torch.eye(3, dtype=t.dtype, device=t.device).expand(r.shape)
    a = torch.cat([r, eye], dim=-1).reshape(*t.shape[:-2], 3 * n, 6)
    return a, (-t).reshape(*t.shape[:-2], 3 * n)


@register("pivot_calibration")
class PivotCalibrationEstimator(Estimator):
    k = 3
    nparams = 6
    fused_family = "pivot"

    def __init__(self, delta: float):
        self.delta = float(delta)

    def minimal_fit(self, samples: Frame):
        """3 frames -> float64 9x6 SVD pseudo-inverse with a rank-6 check
        (``PivotCalibrationParametersEstimator.cxx:9-51``)."""
        x, rank = pinv_solve(*_stack_system(samples))
        return x, rank >= 6

    def lsq_fit(self, data: Frame, mask=None):
        a, b = _stack_system(data)
        if mask is None:
            x, rank = pinv_solve(a, b)
            enough = torch.tensor(data.t.shape[0] >= self.k, device=data.t.device)
        else:
            x, rank = masked_pinv_solve(a, b, torch.repeat_interleave(mask, 3))
            enough = torch.sum(mask) >= self.k
        return x, (rank >= 6) & enough

    def lsq_stats(self, data: Frame, mask=None):
        """Normal-equation partials: with ``A = [R_i, -I]``, ``A^T A = [[sum w
        I, -sum w R^T], [-sum w R, sum w I]]`` and ``A^T b = [-sum w R^T t,
        sum w t]``, so the stats are ``sum w R``, ``sum w R^T t``, ``sum w
        t`` and ``sum w``."""
        w = self._mask_or_ones(mask, data.t.shape[0], data.t.dtype, data.t.device)
        rw = data.r * w[:, None, None]
        return (
            torch.sum(rw, dim=0),
            torch.einsum("nij,ni->j", rw, data.t),
            torch.sum(data.t * w[:, None], dim=0),
            torch.sum(w),
        )

    def lsq_solve_stats(self, stats):
        sum_r, sum_rt_t, sum_t, n = stats
        eye = n * torch.eye(3, dtype=sum_r.dtype, device=sum_r.device)
        ata = torch.cat([torch.cat([eye, -sum_r.T], dim=1), torch.cat([-sum_r, eye], dim=1)])
        x, rank = pinv_solve(ata, torch.cat([-sum_rt_t, sum_t]))
        return x, (rank >= 6) & (n >= self.k)

    def agree(self, params, data: Frame):
        """``|R t_DRF + t - t_W| < delta``
        (``PivotCalibrationParametersEstimator.cxx:108-123``)."""
        mapped = torch.einsum("nij,...j->...ni", data.r, params[..., :3]) + data.t
        err = mapped - params[..., None, 3:]
        return torch.sqrt(torch.sum(err * err, dim=-1)) < self.delta
