"""kD line estimator, params ``[n(dim), a(dim)]`` with n the unit *direction*
(counterpart of ``lsqrrecipes_tpu/estimators/line.py``).

Parity target: ``LineParametersEstimator.{h,hxx}``.  Note the convention
contrast with the 2D estimator, whose n is the normal.
"""

import torch

from lsqrrecipes_tpu_torch.estimators.base import Estimator, dtype_tag, register, upcast
from lsqrrecipes_tpu_torch.linalg import eigvec_largest


def scatter_stats(est, data, mask):
    """Masked first and second moments in float64 and the data's dtype tag
    ``(sum[dim], outer[dim, dim], count, tag)``."""
    x = upcast(data)
    w = est._mask_or_ones(mask, x.shape[0], x.dtype, x.device)
    xw = x * w[:, None]
    return torch.sum(xw, dim=0), xw.T @ x, torch.sum(w), dtype_tag(data)


def centered_scatter(stats):
    """``(mean, covariance-scatter, count)`` in float64 from
    :func:`scatter_stats`."""
    s, outer, n, _ = stats
    n_safe = torch.where(n > 0, n, torch.ones_like(n))
    return s / n_safe, outer - torch.outer(s, s) / n_safe, n


@register("line")
class LineEstimator(Estimator):
    k = 2

    def __init__(self, delta: float, dim: int = 3):
        self.delta = float(delta)
        self.delta_squared = float(delta) * float(delta)
        self.dim = int(dim)
        self.nparams = 2 * self.dim
        self.fused_family = "line3d" if self.dim == 3 else None

    def minimal_fit(self, samples):
        """Direction = normalised ``p0 - p1``; degenerate when the points are
        closer than delta (``LineParametersEstimator.hxx:23-48``)."""
        p0, p1 = samples[..., 0, :], samples[..., 1, :]
        d = p0 - p1
        dist_sq = torch.sum(d * d, dim=-1)
        valid = dist_sq >= self.delta_squared
        norm = torch.sqrt(torch.where(valid, dist_sq, torch.ones_like(dist_sq)))
        return torch.cat([d / norm[..., None], p0], dim=-1), valid

    def lsq_fit(self, data, mask=None):
        return self.lsq_solve_stats(self.lsq_stats(data, mask))

    def lsq_stats(self, data, mask=None):
        return scatter_stats(self, data, mask)

    def lsq_solve_stats(self, stats):
        """Eigenvector of the *largest* eigenvalue of the scatter matrix
        (``LineParametersEstimator.hxx:68-111``)."""
        mean, cov, n = centered_scatter(stats)
        return torch.cat([eigvec_largest(cov), mean]).to(stats[-1].dtype), n >= self.k

    def agree(self, params, data):
        """Orthogonal point-to-line distance^2 < delta^2
        (``LineParametersEstimator.hxx:135-150``)."""
        d = self.dim
        n = params[..., None, :d]
        a = params[..., None, d:]
        v = data - a
        v_dot_n = torch.sum(v * n, dim=-1, keepdim=True)
        perp = v - v_dot_n * n
        return torch.sum(perp * perp, dim=-1) < self.delta_squared
