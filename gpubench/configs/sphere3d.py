"""The sphere configuration's data model and program objects.

A dataset is ``n`` float32 points: ``floor(n * inlier_share)`` on the
sphere of ``center`` and ``radius`` (uniform directions) with isotropic
normal noise ``noise``, the rest uniform in the cube ``outlier_box``.  The
whole pool is drawn in float64 on the device in four calls, then rounded to
float32.
"""

import math

import torch


def make_pool(cfg, count, generator, device):
    """``count`` datasets ``[n, 3]`` float32 on ``device``."""
    d = cfg["data"]
    n = d["n"]
    n_in = math.floor(n * d["inlier_share"])
    f64 = dict(dtype=torch.float64, device=device, generator=generator)
    u = torch.randn((count, n_in, 3), **f64)
    u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    center = torch.tensor(d["center"], dtype=torch.float64, device=device)
    inliers = center + d["radius"] * u + d["noise"] * torch.randn((count, n_in, 3), **f64)
    lo, hi = d["outlier_box"]
    outliers = lo + (hi - lo) * torch.rand((count, n - n_in, 3), **f64)
    pts = torch.cat([inliers, outliers], dim=1).to(torch.float32)
    return list(pts.unbind(0))


def truth(cfg):
    d = cfg["data"]
    return [*d["center"], d["radius"]]


def program_data(data):
    return data


def estimator(cfg, ls_type):
    from lsqrrecipes_tpu_torch.estimators.sphere import SphereEstimator

    return SphereEstimator(cfg["delta"], dim=3, ls_type=ls_type)
