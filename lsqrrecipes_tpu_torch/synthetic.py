"""Synthetic data generators mirroring the reference's test data models
(counterpart of ``lsqrrecipes_tpu/synthetic.py``).

The reference synthesizes ground-truth-known data inside each test binary
(``testing/SinglePointTargetUSCalibrationParametersEstimatorTest.cxx:556-667``,
``testing/PlanePhantomUSCalibrationParametersEstimatorTest.cxx:130-160``).
Each generator here is a draw stage on a ``torch.Generator`` (the JAX
package's ``key``) followed by a deterministic build stage
(``_crosswire_from_draws`` and the like) that takes the JAX function's draws
in its order, so the build can be held against the JAX package on the JAX
package's own draws.  Everything is float64 on the resolved device: a
generator's own device when ``device`` is None, else CUDA.
"""

import math

import torch

from lsqrrecipes_tpu_torch.device import draw_devices
from lsqrrecipes_tpu_torch.estimators.us_calibration import _euler_zyx_matrix
from lsqrrecipes_tpu_torch.geometry import Frame

M_X, M_Y = 0.143, 0.139


class _Draws:
    """Float64 draws from ``generator`` on its device, moved to ``device``."""

    def __init__(self, generator, device):
        self.gen = generator
        self.gdev, self.dev = draw_devices(generator, device)

    def uniform(self, shape, low, high):
        u = torch.rand(shape, generator=self.gen, device=self.gdev, dtype=torch.float64)
        return (low + (high - low) * u).to(self.dev)

    def normal(self, shape):
        return torch.randn(shape, generator=self.gen, device=self.gdev,
                           dtype=torch.float64).to(self.dev)


def _euler_rows(w):
    """``R = Rz(w_2) Ry(w_1) Rx(w_0)`` of angles ``w[..., 3]``."""
    return _euler_zyx_matrix(w[..., 2], w[..., 1], w[..., 0])


def _pixels(q01):
    return q01 * torch.tensor([640.0, 480.0], dtype=q01.dtype, device=q01.device)


def _image(q, r3, t3):
    return q[:, 0:1] * (M_X * r3[:, 0]) + q[:, 1:2] * (M_Y * r3[:, 1]) + t3


def _crosswire_from_draws(w3, t3, t1, q01, w2, noise, sigma):
    """Random T3 with the scales baked into its first two columns, a random
    target t1, per element a pose rotation with the translation solved so
    the pixel maps to t1 (``...Test.cxx:556-667``)."""
    r3 = _euler_rows(w3)
    q = _pixels(q01)
    r2 = _euler_rows(w2)
    t2 = t1 - torch.einsum("nij,nj->ni", r2, _image(q, r3, t3))
    frames = Frame(r2, t2)
    true_params = dict(t1=t1, t3=t3, r3=r3, w3=w3)
    return (frames, q + sigma * noise), (frames, q), true_params


def _pointer_from_draws(w3, t3, q01, w2, t2, noise, sigma):
    r3 = _euler_rows(w3)
    q = _pixels(q01)
    r2 = _euler_rows(w2)
    p = torch.einsum("nij,nj->ni", r2, _image(q, r3, t3)) + t2
    frames = Frame(r2, t2)
    return (frames, q + sigma * noise, p), (frames, q, p), dict(t3=t3, r3=r3, w3=w3)


def _plane_phantom_from_draws(w3, t3, w1, t1_z, q01, w2, a, noise, sigma):
    """Pixels viewing an unknown plane: the plane (w1_y, w1_x, t1_z), T3,
    per element a pose rotation and a free translation ``a`` projected onto
    the plane constraint ``r1_row3 . (mapped + t2) + t1_z = 0``."""
    r3 = _euler_rows(w3)
    cy1, sy1 = torch.cos(w1[0]), torch.sin(w1[0])
    cx1, sx1 = torch.cos(w1[1]), torch.sin(w1[1])
    r1_row3 = torch.stack([-sy1, cy1 * sx1, cy1 * cx1])
    q = _pixels(q01)
    r2 = _euler_rows(w2)
    mapped = torch.einsum("nij,nj->ni", r2, _image(q, r3, t3))
    violation = (mapped + a) @ r1_row3 + t1_z
    t2 = a - violation[:, None] * r1_row3
    frames = Frame(r2, t2)
    true = dict(w1=w1, t1_z=t1_z, t3=t3, r3=r3, r1_row3=r1_row3)
    return (frames, q + sigma * noise), (frames, q), true


def make_crosswire_data(generator=None, n=50, sigma=1.0, device=None):
    """``((frames, q_noisy), (frames, q), truth)`` of the crosswire model."""
    d = _Draws(generator, device)
    return _crosswire_from_draws(
        d.uniform((3,), 0.0, math.pi), d.uniform((3,), -100, 100),
        d.uniform((3,), -100, 100), d.uniform((n, 2), 0.0, 1.0),
        d.uniform((n, 3), 0.0, math.pi), d.normal((n, 2)), sigma)


def make_pointer_data(generator=None, n=50, sigma=1.0, device=None):
    """``((frames, q_noisy, p), (frames, q, p), truth)`` of the calibrated
    pointer model."""
    d = _Draws(generator, device)
    return _pointer_from_draws(
        d.uniform((3,), 0.0, math.pi), d.uniform((3,), -100, 100),
        d.uniform((n, 2), 0.0, 1.0), d.uniform((n, 3), 0.0, math.pi),
        d.uniform((n, 3), -100, 100), d.normal((n, 2)), sigma)


def make_plane_phantom_data(generator=None, n=50, sigma=1.0, device=None):
    """``((frames, q_noisy), (frames, q), truth)`` of the plane phantom."""
    d = _Draws(generator, device)
    return _plane_phantom_from_draws(
        d.uniform((3,), 0.0, math.pi), d.uniform((3,), -100, 100),
        d.uniform((2,), -1.0, 1.0), d.uniform((), -100, 100),
        d.uniform((n, 2), 0.0, 1.0), d.uniform((n, 3), 0.0, math.pi),
        d.uniform((n, 3), -100, 100), d.normal((n, 2)), sigma)
