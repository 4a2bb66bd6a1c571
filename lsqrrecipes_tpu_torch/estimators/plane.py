"""kD hyperplane estimator, params ``[n(dim), a(dim)]`` with n the unit
normal (counterpart of ``lsqrrecipes_tpu/estimators/plane.py``).

Parity target: ``PlaneParametersEstimator.{h,hxx}``.
"""

import torch

from lsqrrecipes_tpu_torch.config import EPS
from lsqrrecipes_tpu_torch.estimators.base import Estimator, register
from lsqrrecipes_tpu_torch.estimators.line import centered_scatter, scatter_stats
from lsqrrecipes_tpu_torch.linalg import eigvec_smallest, nullvector


def _norm(x):
    """``sqrt(sum(x * x))`` over the last axis (``jnp.linalg.norm``'s form)."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


@register("plane")
class PlaneEstimator(Estimator):
    def __init__(self, delta: float, dim: int = 3):
        self.delta = float(delta)
        self.delta_squared = float(delta) * float(delta)
        self.dim = int(dim)
        self.k = self.dim
        self.nparams = 2 * self.dim
        self.fused_family = "plane3d" if self.dim == 3 else None

    def minimal_fit(self, samples):
        """dim points ``[..., dim, dim]`` -> unit normal.

        3D takes the cross product with an EPS collinearity gate
        (``PlaneParametersEstimator.hxx:48-69``); other dims the float64 SVD
        null vector of the ``k x (k+1)`` system ``[p, -1]`` with a rank check
        (``:70-104``).
        """
        p0 = samples[..., 0, :]
        if self.dim == 3:
            v1 = samples[..., 1, :] - p0
            v2 = samples[..., 2, :] - p0
            n = torch.linalg.cross(v1, v2, dim=-1)
            norm = _norm(n)
            valid = norm >= EPS
            n = n / torch.where(valid, norm, torch.ones_like(norm))[..., None]
        else:
            ones = -torch.ones(samples.shape[:-1] + (1,), dtype=samples.dtype,
                               device=samples.device)
            x, rank = nullvector(torch.cat([samples, ones], dim=-1))
            valid = rank >= self.k
            n_raw = x[..., : self.dim]
            norm = _norm(n_raw)
            n = n_raw / torch.where(norm > 0, norm, torch.ones_like(norm))[..., None]
        return torch.cat([n, p0], dim=-1), valid

    def lsq_fit(self, data, mask=None):
        return self.lsq_solve_stats(self.lsq_stats(data, mask))

    def lsq_stats(self, data, mask=None):
        return scatter_stats(self, data, mask)

    def lsq_solve_stats(self, stats):
        """Eigenvector of the *smallest* eigenvalue of the scatter matrix
        (``PlaneParametersEstimator.hxx:129-172``)."""
        mean, cov, n = centered_scatter(stats)
        return torch.cat([eigvec_smallest(cov), mean]).to(stats[-1].dtype), n >= self.k

    def agree(self, params, data):
        """Signed point-plane distance^2 < delta^2
        (``PlaneParametersEstimator.hxx:195-203``)."""
        d = self.dim
        n = params[..., None, :d]
        a = params[..., None, d:]
        signed = torch.sum(n * (data - a), dim=-1)
        return signed * signed < self.delta_squared
