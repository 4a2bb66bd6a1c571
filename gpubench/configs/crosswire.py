"""The crosswire configuration's data model and program objects.

A dataset is ``n`` tracked images of one crosswire point ``t1``: pixels
``q`` uniform in the ``image`` rectangle, probe poses ``R2 = Rz Ry Rx`` of
angles uniform in ``[0, pi)`` and ``t2 = t1 - R2 (u m_x R3(:,1) + v m_y
R3(:,2) + t3)`` under the planted calibration; the last
``floor(n * outlier_share)`` poses are shoved by ``30 + 50 U`` along each
axis with a random sign, then every pixel gets normal noise ``noise``.
Float64 throughout, drawn on the device for the whole pool at once.
"""

import math

import torch

from gpubench.reference.linalg import euler_zyx


def make_pool(cfg, count, generator, device):
    """``count`` datasets ``(r2 [n, 3, 3], t2 [n, 3], q [n, 2])`` float64."""
    d = cfg["data"]
    n = d["n"]
    f64 = dict(dtype=torch.float64, device=device, generator=generator)
    tensor = dict(dtype=torch.float64, device=device)
    q = torch.rand((count, n, 2), **f64) * torch.tensor(d["image"], **tensor)
    w2 = math.pi * torch.rand((count, n, 3), **f64)
    r2 = euler_zyx(w2[..., 2], w2[..., 1], w2[..., 0])
    r3 = euler_zyx(*torch.tensor(d["r3_angles"], **tensor))
    t3 = torch.tensor(d["t3"], **tensor)
    img = q[..., 0:1] * (d["m_x"] * r3[:, 0]) + q[..., 1:2] * (d["m_y"] * r3[:, 1]) + t3
    t2 = torch.tensor(d["t1"], **tensor) - torch.einsum("cnij,cnj->cni", r2, img)
    n_out = math.floor(n * d["outlier_share"])
    shift = (30.0 + 50.0 * torch.rand((count, n_out, 3), **f64)) \
        * torch.sign(torch.randn((count, n_out, 3), **f64))
    t2[:, n - n_out:] += shift
    q = q + d["noise"] * torch.randn((count, n, 2), **f64)
    return list(zip(r2.unbind(0), t2.unbind(0), q.unbind(0)))


def truth(cfg):
    """The planted calibration as the first 11 params
    ``[t1, t3, wz, wy, wx, m_x, m_y]``."""
    d = cfg["data"]
    return [*d["t1"], *d["t3"], *d["r3_angles"], d["m_x"], d["m_y"]]


def program_data(data):
    from lsqrrecipes_tpu_torch.geometry import Frame

    r2, t2, q = data
    return Frame(r2, t2), q


def estimator(cfg, ls_type):
    from lsqrrecipes_tpu_torch.estimators.us_calibration import CrosswireUSCalibrationEstimator

    return CrosswireUSCalibrationEstimator(cfg["delta"], ls_type=ls_type)


def winner_shift(params, delta):
    """The winning hypothesis moved off its best: ``t1_x`` moved by 2 delta."""
    params = params.clone()
    params[0] += 2.0 * delta
    return params
