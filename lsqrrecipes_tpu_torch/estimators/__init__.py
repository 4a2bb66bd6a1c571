"""Estimator suite (ported so far: sphere, plane, kD line, 2D line)."""

from lsqrrecipes_tpu_torch.estimators.base import Estimator, get, names, register
from lsqrrecipes_tpu_torch.estimators.line2d import Line2DEstimator
from lsqrrecipes_tpu_torch.estimators.line import LineEstimator
from lsqrrecipes_tpu_torch.estimators.plane import PlaneEstimator
from lsqrrecipes_tpu_torch.estimators.sphere import (
    ALGEBRAIC,
    GEOMETRIC,
    SphereEstimator,
)

__all__ = [
    "Estimator",
    "register",
    "get",
    "names",
    "Line2DEstimator",
    "LineEstimator",
    "PlaneEstimator",
    "SphereEstimator",
    "ALGEBRAIC",
    "GEOMETRIC",
]
