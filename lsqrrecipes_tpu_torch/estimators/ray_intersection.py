"""Ray-intersection estimator: the common point of a bundle of 3D rays
(counterpart of ``lsqrrecipes_tpu/estimators/ray_intersection.py``).

Parity target: ``RayIntersectionParametersEstimator.{h,cxx}``.  Data is a
:class:`~lsqrrecipes_tpu_torch.geometry.Ray3D` with the observation axis
first; params are ``[x, y, z]``.
"""

import math

import torch

from lsqrrecipes_tpu_torch.estimators.base import Estimator, register
from lsqrrecipes_tpu_torch.geometry import Ray3D, intersect_rays
from lsqrrecipes_tpu_torch.linalg import pinv_solve


@register("ray_intersection")
class RayIntersectionEstimator(Estimator):
    k = 2
    nparams = 3
    fused_family = "ray3d"

    def __init__(self, delta: float, min_angular_deviation: float = None, *,
                 cross_eps: float = None):
        """``|n1 x n2|^2 < sin^2(min_angular_deviation)`` rejects near-parallel
        pairs (``RayIntersectionParametersEstimator.cxx:9-16``; unit
        directions assumed).  Give either ``min_angular_deviation`` or the
        gate itself as ``cross_eps`` (kept bit for bit)."""
        if (min_angular_deviation is None) == (cross_eps is None):
            raise ValueError("give exactly one of min_angular_deviation and cross_eps")
        self.delta = float(delta)
        self.delta_squared = float(delta) * float(delta)
        if cross_eps is None:
            cross_eps = math.sin(float(min_angular_deviation)) ** 2
        self.cross_eps = float(cross_eps)
        # The fused sweep's parameter pack.
        self.fused_delta = (self.delta, self.cross_eps)

    def minimal_fit(self, samples: Ray3D):
        """Two-ray midpoint with parallel and negative-parameter rejection
        (``RayIntersectionParametersEstimator.cxx:23-70``)."""
        ray_a = Ray3D(samples.p[..., 0, :], samples.n[..., 0, :])
        ray_b = Ray3D(samples.p[..., 1, :], samples.n[..., 1, :])
        return intersect_rays(ray_a, ray_b, parallel_eps=self.cross_eps)

    def lsq_fit(self, data: Ray3D, mask=None):
        return self.lsq_solve_stats(self.lsq_stats(data, mask))

    def lsq_stats(self, data: Ray3D, mask=None):
        """Partials of the 3x3 normal system ``[m I - sum n n^T] x = sum (p -
        (n.p) n)`` (``RayIntersectionParametersEstimator.cxx:100-144``)."""
        w = self._mask_or_ones(mask, data.p.shape[0], data.p.dtype, data.p.device)
        nnt = (data.n * w[:, None]).T @ data.n               # sum w n n^T
        s = torch.sum(data.n * data.p, dim=-1)               # n . p per ray
        b = torch.sum((data.p - s[:, None] * data.n) * w[:, None], dim=0)
        return (nnt, b, torch.sum(w))

    def lsq_solve_stats(self, stats):
        nnt, b, m = stats
        x, rank = pinv_solve(m * torch.eye(3, dtype=b.dtype, device=b.device) - nnt, b)
        return x, (rank >= 3) & (m >= self.k)

    def agree(self, params, data: Ray3D):
        """The perpendicular foot on the ray with ``t >= 0`` and distance^2 <
        delta^2 (``RayIntersectionParametersEstimator.cxx:164-179``)."""
        d = params[..., None, :] - data.p
        t = torch.sum(data.n * d, dim=-1)
        perp = d - t[..., None] * data.n
        return (t >= 0) & (torch.sum(perp * perp, dim=-1) < self.delta_squared)
