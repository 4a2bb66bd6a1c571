"""The plane-phantom configuration's data model and program objects.

A dataset is ``n`` tracked images of one plane (normal ``R1_row3`` of the
plane angles ``w1_y, w1_x``, offset ``t1_z``): pixels ``q`` uniform in the
``image`` rectangle, probe poses ``R2 = Rz Ry Rx`` of angles uniform in
``pose_angles``, and ``t2 = f - (R1_row3 . (R2 img + f) + t1_z) R1_row3``
with ``f`` uniform in ``free_t2`` per axis and ``img = u m_x R3(:,1) + v
m_y R3(:,2) + t3`` under the planted calibration, so every image lies on
the plane (the JAX package's ``make_plane_phantom_data``).  The last
``floor(n * outlier_share)`` poses are shoved ``shove[0] + (shove[1] -
shove[0]) U`` along the normal with a random sign, then every pixel gets
normal noise ``noise``.  Float64 throughout, drawn on the device for the
whole pool at once.
"""

import math

import torch

from gpubench.reference.linalg import euler_zyx


def normal(w1_y, w1_x):
    """R1's third row ``[-sin w1_y, cos w1_y sin w1_x, cos w1_y cos w1_x]``."""
    return torch.stack([-torch.sin(w1_y), torch.cos(w1_y) * torch.sin(w1_x),
                        torch.cos(w1_y) * torch.cos(w1_x)])


def make_pool(cfg, count, generator, device):
    """``count`` datasets ``(r2 [n, 3, 3], t2 [n, 3], q [n, 2])`` float64."""
    d = cfg["data"]
    n = d["n"]
    f64 = dict(dtype=torch.float64, device=device, generator=generator)
    tensor = dict(dtype=torch.float64, device=device)

    def uniform(shape, lo_hi):
        lo, hi = lo_hi
        return lo + (hi - lo) * torch.rand(shape, **f64)

    q = torch.rand((count, n, 2), **f64) * torch.tensor(d["image"], **tensor)
    w2 = uniform((count, n, 3), d["pose_angles"])
    r2 = euler_zyx(w2[..., 2], w2[..., 1], w2[..., 0])
    r3 = euler_zyx(*torch.tensor(d["r3_angles"], **tensor))
    t3 = torch.tensor(d["t3"], **tensor)
    nrm = normal(*torch.tensor(d["plane_angles"], **tensor))
    img = q[..., 0:1] * (d["m_x"] * r3[:, 0]) + q[..., 1:2] * (d["m_y"] * r3[:, 1]) + t3
    mapped = torch.einsum("cnij,cnj->cni", r2, img)
    free = uniform((count, n, 3), d["free_t2"])
    t2 = free - ((mapped + free) @ nrm + d["t1_z"])[..., None] * nrm
    q = q + d["noise"] * torch.randn((count, n, 2), **f64)
    n_out = math.floor(n * d["outlier_share"])
    lo, hi = d["shove"]
    shift = (lo + (hi - lo) * torch.rand((count, n_out, 1), **f64)) \
        * torch.sign(torch.randn((count, n_out, 1), **f64))
    t2[:, n - n_out:] += shift * nrm
    return list(zip(r2.unbind(0), t2.unbind(0), q.unbind(0)))


def truth(cfg):
    """The planted calibration as the first 11 params ``[w1_y, w1_x, t1_z,
    t3, wz, wy, wx, m_x, m_y]`` (its normal's z component is positive, as
    the program's sign rule wants)."""
    d = cfg["data"]
    return [*d["plane_angles"], d["t1_z"], *d["t3"], *d["r3_angles"], d["m_x"], d["m_y"]]


def program_data(data):
    from lsqrrecipes_tpu_torch.geometry import Frame

    r2, t2, q = data
    return Frame(r2, t2), q


def estimator(cfg, ls_type):
    from lsqrrecipes_tpu_torch.estimators.us_calibration import (
        PlanePhantomUSCalibrationEstimator,
    )

    return PlanePhantomUSCalibrationEstimator(cfg["delta"], ls_type=ls_type)


def winner_shift(params, delta):
    """The winning hypothesis moved off its best: ``t1_z`` moved by 2 delta,
    which moves every image's plane distance by 2 delta."""
    params = params.clone()
    params[2] += 2.0 * delta
    return params
