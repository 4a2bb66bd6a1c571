"""Estimator suite: sphere, plane, kD line, 2D line, dense linear system,
pivot calibration, absolute orientation, ray intersection, and the
crosswire, calibrated-pointer and plane-phantom ultrasound calibrations."""

from lsqrrecipes_tpu_torch.estimators.absolute_orientation import (
    AbsoluteOrientationEstimator,
)
from lsqrrecipes_tpu_torch.estimators.base import Estimator, get, names, register
from lsqrrecipes_tpu_torch.estimators.dense_linear import (
    DenseLinearSystemEstimator,
    augmented_rows,
)
from lsqrrecipes_tpu_torch.estimators.line2d import Line2DEstimator
from lsqrrecipes_tpu_torch.estimators.line import LineEstimator
from lsqrrecipes_tpu_torch.estimators.pivot_calibration import PivotCalibrationEstimator
from lsqrrecipes_tpu_torch.estimators.plane import PlaneEstimator
from lsqrrecipes_tpu_torch.estimators.ray_intersection import RayIntersectionEstimator
from lsqrrecipes_tpu_torch.estimators.sphere import (
    ALGEBRAIC,
    GEOMETRIC,
    SphereEstimator,
)
from lsqrrecipes_tpu_torch.estimators.us_calibration import (
    ANALYTIC,
    ITERATIVE,
    CrosswireUSCalibrationEstimator,
    PlanePhantomUSCalibrationEstimator,
    PointerUSCalibrationEstimator,
)

__all__ = [
    "Estimator",
    "register",
    "get",
    "names",
    "AbsoluteOrientationEstimator",
    "CrosswireUSCalibrationEstimator",
    "DenseLinearSystemEstimator",
    "Line2DEstimator",
    "LineEstimator",
    "PivotCalibrationEstimator",
    "PlaneEstimator",
    "PlanePhantomUSCalibrationEstimator",
    "PointerUSCalibrationEstimator",
    "RayIntersectionEstimator",
    "SphereEstimator",
    "ALGEBRAIC",
    "GEOMETRIC",
    "ANALYTIC",
    "ITERATIVE",
    "augmented_rows",
]
