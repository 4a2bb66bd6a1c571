"""Plain reference of 3D sphere RANSAC: params ``[cx, cy, cz, r]``.

* minimal fit: the circumsphere of four points, from ``A c = b / 2`` with
  ``A_i = p0 - p_(i+1)`` and ``b_i = A_i . (p0 + p_(i+1))``, by Cramer's
  rule; a sample is degenerate where ``|det A| < 1e-9`` (the reference
  library's ``SphereParametersEstimator`` gate);
* agreement: ``| |p - c| - r | < delta``;
* refits on the consensus: ALGEBRAIC, least squares of ``[-2p, 1] [c;
  |c|^2 - r^2] = -|p|^2``; GEOMETRIC, Levenberg-Marquardt on ``|p - c| - r``
  from the algebraic fit.

Data: points ``[n, 3]``; every function computes in the data's dtype.
"""

import torch

from gpubench.reference import linalg

K = 4
DET_EPS = 1e-9


def cast(data, dtype):
    return data.to(dtype)


def features(data):
    return data


def minimal_fit(samples):
    """``[C, 4, 3]`` -> ``(params [C, 4], valid [C])``."""
    p0, rest = samples[:, 0], samples[:, 1:]
    a = p0[:, None, :] - rest
    b = 0.5 * torch.sum(a * (p0[:, None, :] + rest), dim=-1)
    cof = [torch.linalg.cross(a[:, 1], a[:, 2], dim=-1),
           torch.linalg.cross(a[:, 2], a[:, 0], dim=-1),
           torch.linalg.cross(a[:, 0], a[:, 1], dim=-1)]
    det = torch.sum(a[:, 0] * cof[0], dim=-1)
    ok = det.abs() >= DET_EPS
    safe = torch.where(ok, det, torch.ones_like(det))
    center = (b[:, 0:1] * cof[0] + b[:, 1:2] * cof[1] + b[:, 2:3] * cof[2]) / safe[:, None]
    r = torch.sqrt(torch.sum((p0 - center) ** 2, dim=-1))
    params = torch.cat([center, r[:, None]], dim=-1)
    return params, ok & torch.isfinite(params).all(dim=-1)


def vote_counts(params, data, delta):
    """Inlier counts ``[C]`` of hypotheses ``[C, 4]``."""
    c, r = params[:, :3], params[:, 3]
    d2 = (torch.sum(data * data, dim=-1)[None, :] - 2.0 * (c @ data.T)
          + torch.sum(c * c, dim=-1)[:, None])
    d = torch.sqrt(torch.clamp_min(d2, 0.0))
    return torch.sum((d - r[:, None]).abs() < delta, dim=-1)


def agree(params, data, delta):
    d = torch.sqrt(torch.sum((data - params[:3]) ** 2, dim=-1))
    return (d - params[3]).abs() < delta


def _algebraic(pts):
    ones = torch.ones((pts.shape[0], 1), dtype=pts.dtype, device=pts.device)
    x = linalg.lstsq(torch.cat([-2.0 * pts, ones], dim=-1), -torch.sum(pts * pts, dim=-1))
    c = x[:3]
    r_sq = torch.sum(c * c) - x[3]
    r = torch.sqrt(torch.where(r_sq > 0, r_sq, torch.ones_like(r_sq)))
    return torch.cat([c, r[None]]), bool(r_sq > 0)


def refit(data, mask, ls_type):
    """``(params [4], valid)`` of the consensus ``mask``."""
    pts = data[mask]
    if pts.shape[0] < K:
        return torch.zeros(4, dtype=data.dtype, device=data.device), False
    params, valid = _algebraic(pts)
    if ls_type == "algebraic":
        return params, valid

    def residual(x):
        return torch.sqrt(torch.sum((pts - x[:3]) ** 2, dim=-1)) - x[3]

    def jacobian(x):
        diff = x[:3] - pts
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1, keepdim=True))
        return torch.cat([diff / dist, -torch.ones_like(dist)], dim=-1)

    params = linalg.levenberg_marquardt(residual, jacobian, params)
    return params, valid and bool(torch.isfinite(params).all())
