"""Closed-form solvers for tiny systems (counterpart of
``lsqrrecipes_tpu/linalg/small.py``: ``solve2`` and ``solve3`` only).

Pure elementwise tensor arithmetic batched over leading axes, with the same
cofactor arithmetic and operation order as the JAX package.
"""

import torch


def solve2(a, b):
    """Cramer solve of ``a[..., 2, 2] x = b[..., 2]`` -> ``(x, det)``."""
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    safe = torch.where(det == 0, torch.ones_like(det), det)
    x0 = (a[..., 1, 1] * b[..., 0] - a[..., 0, 1] * b[..., 1]) / safe
    x1 = (a[..., 0, 0] * b[..., 1] - a[..., 1, 0] * b[..., 0]) / safe
    return torch.stack([x0, x1], dim=-1), det


def solve3(a, b):
    """Adjugate (Cramer) solve of ``a[..., 3, 3] x = b[..., 3]`` -> ``(x, det)``.

    Same arithmetic as the reference's hand-coded 3D sphere solver
    (``SphereParametersEstimator.hxx:115-163``).
    """
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c10 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c20 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c10 + a[..., 0, 2] * c20

    c01 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c21 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]

    c02 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c12 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]

    safe = torch.where(det == 0, torch.ones_like(det), det)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) / safe
    x1 = (c10 * b0 + c11 * b1 + c12 * b2) / safe
    x2 = (c20 * b0 + c21 * b1 + c22 * b2) / safe
    return torch.stack([x0, x1, x2], dim=-1), det
