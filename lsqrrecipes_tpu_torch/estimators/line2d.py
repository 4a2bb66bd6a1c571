"""2D line estimator, params ``[nx, ny, ax, ay]`` with n the unit *normal*
(counterpart of ``lsqrrecipes_tpu/estimators/line2d.py``).

Parity target: ``Line2DParametersEstimator.{h,cxx}``: a two-point exact fit
and the closed-form smallest eigenvector of the 2x2 scatter matrix for the
least-squares fit (``Line2DParametersEstimator.cxx:50-100``).
"""

import torch

from lsqrrecipes_tpu_torch.device import full_f32_matmul
from lsqrrecipes_tpu_torch.estimators.base import Estimator, dtype_tag, register, upcast

# Cells of one vote chunk: bounds its [chunk, n] temporaries.
_VOTE_CELLS = 1 << 24


@register("line2d")
class Line2DEstimator(Estimator):
    k = 2
    nparams = 4

    fused_family = "line2d"

    def __init__(self, delta: float):
        self.delta = float(delta)
        self.delta_squared = float(delta) * float(delta)

    def minimal_fit(self, samples):
        """Two points ``[..., 2, 2]`` -> normal perpendicular to p1 - p0;
        degenerate when the points are closer than delta
        (``Line2DParametersEstimator.cxx:11-32``)."""
        p0, p1 = samples[..., 0, :], samples[..., 1, :]
        nx = p1[..., 1] - p0[..., 1]
        ny = p0[..., 0] - p1[..., 0]
        norm_sq = nx * nx + ny * ny
        valid = norm_sq >= self.delta_squared
        norm = torch.sqrt(torch.where(valid, norm_sq, torch.ones_like(norm_sq)))
        params = torch.stack([nx / norm, ny / norm, p0[..., 0], p0[..., 1]], dim=-1)
        return params, valid

    def lsq_fit(self, data, mask=None):
        return self.lsq_solve_stats(self.lsq_stats(data, mask))

    def lsq_stats(self, data, mask=None):
        """Masked float64 sums ``[sum_x, sum_y, sum_xx, sum_xy, sum_yy, count]``
        and the data's dtype tag."""
        d = upcast(data)
        w = self._mask_or_ones(mask, d.shape[0], d.dtype, d.device)
        x, y = d[..., 0] * w, d[..., 1] * w
        return torch.stack([
            torch.sum(x),
            torch.sum(y),
            torch.sum(x * d[..., 0]),
            torch.sum(x * d[..., 1]),
            torch.sum(y * d[..., 1]),
            torch.sum(w),
        ]), dtype_tag(data)

    def lsq_solve_stats(self, stats):
        """Closed-form smallest eigenvector of the 2x2 scatter matrix, with
        the ``cov11 < 1e-12`` vertical-line and all-points-coincide branches
        (``Line2DParametersEstimator.cxx:50-100``)."""
        sums, tag = stats
        sx, sy, sxx, sxy, syy, n = (sums[i] for i in range(6))
        enough = n >= self.k
        n_safe = torch.where(n > 0, n, torch.ones_like(n))
        mean_x, mean_y = sx / n_safe, sy / n_safe
        c11 = sxx - n * mean_x * mean_x
        c12 = sxy - n * mean_x * mean_y
        c22 = syy - n * mean_y * mean_y

        # Largest eigenvalue of [[c11, c12], [c12, c22]].
        lam1 = (c11 + c22 + torch.sqrt((c11 - c22) ** 2 + 4.0 * c12 * c12)) / 2.0
        nx, ny = -c12, lam1 - c22
        norm = torch.sqrt(nx * nx + ny * ny)
        norm_safe = torch.where(norm > 0, norm, torch.ones_like(norm))

        vertical = c11 < 1e-12  # line x = const (or a degenerate point cloud)
        nx = torch.where(vertical, torch.ones_like(nx), nx / norm_safe)
        ny = torch.where(vertical, torch.zeros_like(ny), ny / norm_safe)
        degenerate_point = vertical & (c22 < 1e-12)
        return torch.stack([nx, ny, mean_x, mean_y]).to(tag.dtype), enough & ~degenerate_point

    def agree(self, params, data):
        """Signed point-line distance squared < delta^2
        (``Line2DParametersEstimator.cxx:119-123``)."""
        p = params[..., None, :]
        d = p[..., 0] * (data[..., 0] - p[..., 2]) + p[..., 1] * (data[..., 1] - p[..., 3])
        return d * d < self.delta_squared

    def vote_counts(self, params, data):
        """Inlier counts ``int64[B]`` from one product per chunk:
        ``s = N X^T - n.a``.  The JAX package leaves this product to XLA
        (no Pallas kernel); here it is ``torch.matmul`` in full float32."""
        n_vec = params[..., :2].to(data.dtype)
        offset = torch.sum(n_vec * params[..., 2:].to(data.dtype), dim=-1)
        chunk = max(1, _VOTE_CELLS // max(1, data.shape[0]))
        out = [torch.zeros((0,), dtype=torch.int64, device=params.device)]
        with full_f32_matmul():
            for b0 in range(0, params.shape[0], chunk):
                s = torch.matmul(n_vec[b0 : b0 + chunk], data.T) - offset[b0 : b0 + chunk, None]
                out.append(torch.sum(s * s < self.delta_squared, dim=-1))
        return torch.cat(out)
