"""Estimator suite (ported so far: the sphere)."""

from lsqrrecipes_tpu_torch.estimators.base import Estimator, get, names, register
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
    "SphereEstimator",
    "ALGEBRAIC",
    "GEOMETRIC",
]
