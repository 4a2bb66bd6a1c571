"""Carrying state between the JAX package and the port.

This system has no weights; its state is the estimator's configuration,
the data, and the hypothesis randomness.  These helpers take only numpy
arrays and plain attributes, so either side can produce them:

  * :func:`estimator_from_attrs` — any object with ``registry_name`` and
    ``delta`` (plus ``dim``, ``ls_type``, ``n`` or ``cross_eps`` where the
    estimator has them), such as a JAX package estimator -> the port's
    estimator of that name;
  * :func:`sphere_estimator_from_attrs` — the same for a sphere estimator,
    from ``delta``, ``dim`` and ``ls_type`` alone;
  * :func:`to_torch` — a numpy array (data, ``idx[B, k]`` hypothesis
    indices, slot-plane or sampling permutations) -> a tensor, dtype kept;
  * :func:`data_to_torch` — an estimator's data of arrays: a point array,
    a ``Frame`` (fields ``r``, ``t``), a ``Ray3D`` (fields ``p``, ``n``) or a
    ``(first, second)`` pair -> the port's tree of tensors;
  * :func:`result_to_numpy` — a :class:`RansacResult` of tensors -> the same
    fields as numpy arrays.
"""

import numpy as np

from lsqrrecipes_tpu_torch.device import as_tensor
from lsqrrecipes_tpu_torch.estimators import (
    AbsoluteOrientationEstimator,
    DenseLinearSystemEstimator,
    Line2DEstimator,
    LineEstimator,
    PivotCalibrationEstimator,
    PlaneEstimator,
    RayIntersectionEstimator,
    SphereEstimator,
)
from lsqrrecipes_tpu_torch.geometry import Frame, Ray3D
from lsqrrecipes_tpu_torch.ransac.engine import RansacResult

_FROM_ATTRS = {
    "sphere": lambda a: SphereEstimator(float(a.delta), int(a.dim), str(a.ls_type)),
    "plane": lambda a: PlaneEstimator(float(a.delta), int(a.dim)),
    "line": lambda a: LineEstimator(float(a.delta), int(a.dim)),
    "line2d": lambda a: Line2DEstimator(float(a.delta)),
    "dense_linear": lambda a: DenseLinearSystemEstimator(float(a.delta), int(a.n)),
    "pivot_calibration": lambda a: PivotCalibrationEstimator(float(a.delta)),
    "absolute_orientation": lambda a: AbsoluteOrientationEstimator(float(a.delta)),
    # The JAX estimator keeps only the gate sin^2(min_angular_deviation):
    # carry it as it is, not through an asin round trip.
    "ray_intersection": lambda a: RayIntersectionEstimator(
        float(a.delta), cross_eps=float(a.cross_eps)),
}


def estimator_from_attrs(attrs):
    """The port's estimator for ``attrs.registry_name`` with the same
    ``delta`` (and ``dim``, ``ls_type``, ``n`` or ``cross_eps``); ``KeyError``
    for an estimator the port does not have yet."""
    return _FROM_ATTRS[attrs.registry_name](attrs)


def sphere_estimator_from_attrs(attrs) -> SphereEstimator:
    return _FROM_ATTRS["sphere"](attrs)


def to_torch(array_np, device=None):
    """``np.asarray(array_np)`` as a tensor on ``device`` (default CUDA)."""
    return as_tensor(np.asarray(array_np), device)


def data_to_torch(data, device=None, dtype=None):
    """Estimator data of arrays -> the port's tensors on ``device`` (default
    CUDA), dtype kept unless given: a ``Frame`` for anything with fields
    ``(r, t)``, a ``Ray3D`` for fields ``(p, n)``, a tuple for a pair."""
    fields = getattr(type(data), "_fields", None)
    if fields is None and not isinstance(data, (tuple, list)):
        return as_tensor(np.asarray(data), device, dtype)
    leaves = as_tensor(tuple(np.asarray(x) for x in data), device, dtype)
    if fields == ("r", "t"):
        return Frame(*leaves)
    if fields == ("p", "n"):
        return Ray3D(*leaves)
    return leaves


def result_to_numpy(result: RansacResult) -> RansacResult:
    return RansacResult(*(t.detach().cpu().numpy() for t in result))
