"""Hypersphere estimator, params ``[c(dim), r]`` (counterpart of
``lsqrrecipes_tpu/estimators/sphere.py``).

Two least-squares modes, as in the reference
(``SphereParametersEstimator.hxx:14-22``):

  * ``ALGEBRAIC`` solves ``[-2p, 1] [c; c^2 - r^2] = -p^2`` by SVD
    pseudo-inverse (``SphereParametersEstimator.hxx:267-307``);
  * ``GEOMETRIC`` (the default) starts there and runs Levenberg-Marquardt
    on the point-to-sphere distance ``f_i = ||p_i - c|| - r`` with the
    analytic Jacobian (``SphereParametersEstimator.hxx:310-338,392-431``).
"""

import torch

from lsqrrecipes_tpu_torch.config import SPHERE_EPS
from lsqrrecipes_tpu_torch.estimators.base import Estimator, register, upcast
from lsqrrecipes_tpu_torch.linalg import (
    LMConfig,
    levenberg_marquardt,
    masked_pinv_solve,
    pinv_solve,
    small,
)
from lsqrrecipes_tpu_torch.utils import profiling

ALGEBRAIC = "algebraic"
GEOMETRIC = "geometric"

# Cells of one plain vote chunk: bounds its [chunk, n] temporaries.
_VOTE_CELLS = 1 << 24


def _norm(x):
    """``sqrt(sum(x * x))`` over the last axis (``jnp.linalg.norm``'s form)."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _sphere_residual(x, points):
    """``f_i = ||p_i - c|| - r`` for ``x[..., dim + 1]`` and ``points[..., m,
    dim]`` (``SphereParametersEstimator.hxx:394-409``)."""
    c, r = x[..., None, :-1], x[..., -1:]
    return _norm(points - c) - r


def _sphere_jacobian(x, points):
    """``d f_i / d c_j = (c_j - p_ij) / ||p_i - c||``, ``d f_i / d r = -1``,
    the distance floored at the dtype's ``tiny``
    (``SphereParametersEstimator.hxx:413-431``)."""
    diff = x[..., None, :-1] - points
    dist = torch.clamp_min(_norm(diff)[..., None], torch.finfo(x.dtype).tiny)
    return torch.cat([diff / dist, -torch.ones_like(dist)], dim=-1)


@register("sphere")
class SphereEstimator(Estimator):
    def __init__(self, delta: float, dim: int = 3, ls_type: str = GEOMETRIC,
                 lm_config: LMConfig = LMConfig(max_iters=500)):
        if ls_type not in (ALGEBRAIC, GEOMETRIC):
            raise ValueError(f"unknown least-squares type {ls_type!r}")
        self.delta = float(delta)
        self.fused_family = "sphere3d" if int(dim) == 3 else None
        self.dim = int(dim)
        self.k = self.dim + 1
        self.nparams = self.dim + 1
        self.ls_type = ls_type
        self.lm_config = lm_config

    # ------------------------------------------------------------- exact fit
    def minimal_fit(self, samples):
        """dim+1 points ``[..., k, dim]`` -> circumsphere via the equal-radius
        system ``A c = b/2``, ``A_ij = p0_j - p(i+1)_j``,
        ``b_i = sum_j A_ij (p0_j + p(i+1)_j)``: Cramer with the
        ``|det| >= SPHERE_EPS`` gate in 2D/3D, SVD rank above."""
        p0 = samples[..., 0, :]
        rest = samples[..., 1:, :]
        a = p0[..., None, :] - rest
        b = torch.sum(a * (p0[..., None, :] + rest), dim=-1)
        if self.dim in (2, 3):
            solver = small.solve2 if self.dim == 2 else small.solve3
            center, det = solver(a, b)
            center = 0.5 * center
            valid = det.abs() >= SPHERE_EPS
        else:
            center, rank = pinv_solve(a, 0.5 * b)
            valid = rank >= self.dim
        r = _norm(p0 - center)
        return torch.cat([center, r[..., None]], dim=-1), valid

    # --------------------------------------------------------- least squares
    def lsq_fit(self, data, mask=None):
        """The algebraic fit, then (GEOMETRIC) Levenberg-Marquardt from it on
        the rows of ``mask``.  A fit that does not converge is invalid, like
        the reference's empty-vector return
        (``SphereParametersEstimator.hxx:331-337``)."""
        with profiling.leaf("refit.start"):
            params, valid = self._algebraic_fit(data, mask)
        if self.ls_type == ALGEBRAIC:
            return params, valid
        result = levenberg_marquardt(_sphere_residual, _sphere_jacobian, params, data,
                                     mask=mask, config=self.lm_config)
        return torch.where(valid, result.x, params), valid & result.converged

    def _algebraic_fit(self, data, mask=None):
        """``[-2p, 1] x = -p.p`` via SVD pseudo-inverse; rejects r^2 <= 0.  The
        system, the solve and ``r^2`` are float64 (``-p.p`` of a float32
        cloud far from the origin loses the fit); the params come back in
        the data's dtype."""
        n = data.shape[0]
        x64 = upcast(data)
        ones = torch.ones((n, 1), dtype=x64.dtype, device=x64.device)
        a = torch.cat([-2.0 * x64, ones], dim=-1)
        b = -torch.sum(x64 * x64, dim=-1)
        if mask is None:
            x, rank = pinv_solve(a, b)
            enough = torch.tensor(n >= self.k, device=data.device)
        else:
            x, rank = masked_pinv_solve(a, b, mask)
            enough = torch.sum(mask) >= self.k
        center = x[: self.dim]
        r_sq = torch.sum(center * center) - x[self.dim]
        valid = (rank >= self.k) & enough & (r_sq > 0)
        r = torch.sqrt(torch.where(r_sq > 0, r_sq, torch.ones_like(r_sq)))
        return torch.cat([center, r[None]]).to(data.dtype), valid

    # ------------------------------------------------------------ hypotheses
    def fit_and_vote(self, samples, data):
        """samples ``[B, k, d]`` -> ``(counts[B], params[B, d+1])``, count -1
        for degenerate samples."""
        params, valid = self.minimal_fit(samples)
        counts = self.vote_counts(params, data)
        return torch.where(valid, counts, torch.full_like(counts, -1)), params

    def agree(self, params, data):
        """``| ||p - c|| - r | < delta`` (``SphereParametersEstimator.hxx:255-264``)."""
        c = params[..., None, : self.dim]
        r = params[..., None, self.dim]
        return (_norm(data - c) - r).abs() < self.delta

    def vote_counts(self, params, data):
        """Inlier counts ``int32[B]`` for a hypothesis batch with the
        sqrt-free band ``(max(r-delta,0))^2 < |p|^2 - 2 c.p + |c|^2 <
        (r+delta)^2``.

        f32 data in 3D goes to
        :func:`lsqrrecipes_tpu_torch.ops.vote.sphere_vote_counts`, which
        expands the band about the data's first point, whatever B is (the
        JAX package's Pallas kernel needs ``B % 512 == 0``; the CUDA kernel
        does not), so the counts do not depend on the batch size at band
        edges: it launches the kernel on CUDA tensors and runs its plain
        version on CPU tensors.  f64 data and other dims take the formula
        below.
        """
        if self.dim == 3 and data.dtype == torch.float32:
            from lsqrrecipes_tpu_torch.ops import vote as _vote

            points_t, valid, _ = _vote.pack_points(data)
            return _vote.sphere_vote_counts(params, points_t, valid, self.delta)
        pp = torch.sum(data * data, dim=-1)[None, :]
        chunk = max(1, _VOTE_CELLS // max(1, data.shape[0]))
        out = []
        for b0 in range(0, params.shape[0], chunk):
            prm = params[b0 : b0 + chunk].to(data.dtype)
            c = prm[:, : self.dim]
            r = prm[:, self.dim]
            d2 = pp - 2.0 * (c @ data.T) + torch.sum(c * c, dim=-1)[:, None]
            rp = r + self.delta
            rm = r - self.delta
            hi2 = rp * rp
            lo2 = torch.where(rm >= 0.0, rm * rm, -torch.inf)
            inside = (d2 < hi2[:, None]) & (d2 > lo2[:, None])
            out.append(inside.sum(dim=-1, dtype=torch.int32))
        if not out:
            return torch.zeros((0,), dtype=torch.int32, device=params.device)
        return torch.cat(out)

    def distance_statistics(self, params, data):
        """Per-point ``|distance - r|`` plus (min, max, mean)
        (``SphereParametersEstimator.hxx:341-377``)."""
        dist = (_norm(data - params[..., : self.dim]) - params[..., self.dim]).abs()
        return dist, torch.min(dist), torch.max(dist), torch.mean(dist)
