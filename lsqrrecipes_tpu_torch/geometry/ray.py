"""Rays in 3D: ``r(t) = p + t n`` with ``t >= 0`` (counterpart of
``lsqrrecipes_tpu/geometry/ray.py``, the reference's ``common/Ray3D``).

A ``Ray3D`` is a ``NamedTuple`` of origin ``p[..., 3]`` and direction
``n[..., 3]`` (not necessarily unit, ``Ray3D.h:10-16``), batched over
leading axes.
"""

from typing import NamedTuple

import torch

from lsqrrecipes_tpu_torch.config import EPS


def _dot(u, v):
    return torch.sum(u * v, dim=-1)


class Ray3D(NamedTuple):
    p: torch.Tensor  # [..., 3] origin
    n: torch.Tensor  # [..., 3] direction

    def transformed(self, frame):
        """Rigidly transform the ray (origin as a point, direction as a vector)."""
        return Ray3D(frame.apply(self.p), frame.apply_vector(self.n))

    def distance_to_point(self, q):
        """Distance from point(s) ``q`` to the line carrying the ray
        (``Ray3D.cxx:58-76``: the foot is not clamped to t >= 0)."""
        n = self.n / torch.sqrt(_dot(self.n, self.n))[..., None]
        d = torch.as_tensor(q, device=self.p.device) - self.p
        t = _dot(d, n)
        perp = d - t[..., None] * n
        return torch.sqrt(_dot(perp, perp))


def intersect_rays(ray_a: Ray3D, ray_b: Ray3D, parallel_eps: float = EPS):
    """Midpoint of the common perpendicular of two rays (Graphics Gems,
    ``Ray3D.cxx:6-56``, ``RayIntersectionParametersEstimator.cxx:9-69``).

    Returns ``(point[..., 3], valid[...])``; valid is False for
    near-parallel rays (``|n1 x n2|^2 < parallel_eps``) or when either ray
    parameter is negative (the lines meet behind an origin).
    """
    p21 = ray_b.p - ray_a.p
    cross = torch.linalg.cross(ray_a.n, ray_b.n, dim=-1)
    denom = _dot(cross, cross)
    nonparallel = denom >= parallel_eps
    safe_denom = torch.where(nonparallel, denom, torch.ones_like(denom))
    t1 = _dot(cross, torch.linalg.cross(p21, ray_b.n, dim=-1)) / safe_denom
    t2 = _dot(cross, torch.linalg.cross(p21, ray_a.n, dim=-1)) / safe_denom
    valid = nonparallel & (t1 >= 0) & (t2 >= 0)
    midpoint = 0.5 * (ray_a.p + t1[..., None] * ray_a.n + ray_b.p + t2[..., None] * ray_b.n)
    return midpoint, valid
