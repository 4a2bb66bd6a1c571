"""Absolute orientation (Horn, unit quaternion), params
``[qs, qx, qy, qz, tx, ty, tz]`` (counterpart of
``lsqrrecipes_tpu/estimators/absolute_orientation.py``).

Parity target: ``AbsoluteOrientationParametersEstimator.{h,cxx}``.  Data is a
pair of point tensors ``(first[n, 3], second[n, 3])``; the transform maps the
first set onto the second.
"""

import torch

from lsqrrecipes_tpu_torch.config import EPS
from lsqrrecipes_tpu_torch.estimators.base import Estimator, dtype_tag, register, upcast
from lsqrrecipes_tpu_torch.geometry import rotations
from lsqrrecipes_tpu_torch.linalg import eigvec_largest


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def _horn_n_matrix(m):
    """Symmetric 4x4 N from the 3x3 cross-covariance M
    (``AbsoluteOrientationParametersEstimator.cxx:171-188``)."""
    trace = m[0, 0] + m[1, 1] + m[2, 2]
    a = torch.stack([m[1, 2] - m[2, 1], m[2, 0] - m[0, 2], m[0, 1] - m[1, 0]])
    lower = m + m.T - trace * torch.eye(3, dtype=m.dtype, device=m.device)
    top = torch.cat([trace[None], a])
    return torch.cat([top[None, :], torch.cat([a[:, None], lower], dim=1)], dim=0)


@register("absolute_orientation")
class AbsoluteOrientationEstimator(Estimator):
    k = 3
    nparams = 7
    fused_family = "absolute_orientation"

    def __init__(self, delta: float):
        self.delta = float(delta)
        self.delta_squared = float(delta) * float(delta)

    def minimal_fit(self, samples):
        """Orthonormal frames from 3 point pairs
        (``AbsoluteOrientationParametersEstimator.cxx:14-101``): per set, x
        from p0 - mean, y by Gram-Schmidt from p1 - mean, z = x cross y;
        ``R = R2 R1^T``, ``t = mean2 - R mean1``; collinear triples
        (``|z| < EPS``) are degenerate."""
        first, second = samples

        def build_frame(p):
            mean = torch.mean(p, dim=-2)
            x = p[..., 0, :] - mean
            x_norm = _norm(x)
            x = x / torch.where(x_norm > 0, x_norm, torch.ones_like(x_norm))
            y = p[..., 1, :] - mean
            y = y - torch.sum(y * x, dim=-1, keepdim=True) * x
            y_norm = _norm(y)
            y = y / torch.where(y_norm > 0, y_norm, torch.ones_like(y_norm))
            z = torch.linalg.cross(x, y, dim=-1)
            ok = _norm(z)[..., 0] >= EPS
            return torch.stack([x, y, z], dim=-1), mean, ok   # columns x, y, z

        r1, mean1, ok1 = build_frame(first)
        r2, mean2, ok2 = build_frame(second)
        r = r2 @ torch.swapaxes(r1, -1, -2)
        t = mean2 - torch.einsum("...ij,...j->...i", r, mean1)
        q = rotations.quaternion_from_matrix(r)
        return torch.cat([q, t], dim=-1), ok1 & ok2

    def lsq_fit(self, data, mask=None):
        return self.lsq_solve_stats(self.lsq_stats(data, mask))

    def lsq_stats(self, data, mask=None):
        """Weighted float64 sums for Horn's method (also
        ``weightedLeastSquaresEstimate``, ``...cxx:208-297``, when ``mask``
        carries real weights) and the data's dtype tag."""
        first, second = upcast(data[0]), upcast(data[1])
        w = self._mask_or_ones(mask, first.shape[0], first.dtype, first.device)
        fw = first * w[:, None]
        return (
            torch.sum(fw, dim=0),
            torch.sum(second * w[:, None], dim=0),
            fw.T @ second,      # sum w f s^T, the cross-covariance accumulator
            torch.sum(w),
            dtype_tag(data[0]),
        )

    def lsq_solve_stats(self, stats):
        """Horn: the eigenvector of N's largest eigenvalue
        (``...cxx:120-206``).  Its sign is not fixed: ``q`` and ``-q`` are
        the same rotation."""
        sum1, sum2, cross, n, tag = stats
        n_safe = torch.where(n > 0, n, torch.ones_like(n))
        mean1, mean2 = sum1 / n_safe, sum2 / n_safe
        m = cross - torch.outer(sum1, sum2) / n_safe
        q = eigvec_largest(_horn_n_matrix(m))
        r = rotations.matrix_from_quaternion(q)
        return torch.cat([q, mean2 - r @ mean1]).to(tag.dtype), n >= self.k

    def agree(self, params, data):
        """``|T(first) - second|^2 < delta^2`` (``...cxx:316-327``)."""
        first, second = data
        r = rotations.matrix_from_quaternion(rotations.normalize_quaternion(params[..., :4]))
        mapped = torch.einsum("...ij,nj->...ni", r, first) + params[..., None, 4:]
        err = mapped - second
        return torch.sum(err * err, dim=-1) < self.delta_squared
