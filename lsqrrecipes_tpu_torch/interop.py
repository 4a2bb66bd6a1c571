"""Carrying state between the JAX package and the port.

This system has no weights; its state is the estimator's configuration,
the data, and the hypothesis randomness.  These helpers take only numpy
arrays and plain attributes, so either side can produce them:

  * :func:`estimator_from_attrs` — any object with ``registry_name`` and
    ``delta`` (plus ``dim``, ``ls_type``, ``n``, ``cross_eps`` or
    ``lm_config`` where the estimator has them), such as a JAX package
    estimator -> the port's estimator of that name (all eleven);
  * :func:`sphere_estimator_from_attrs` — the same for a sphere estimator,
    from ``delta``, ``dim``, ``ls_type`` and ``lm_config``;
  * :func:`to_torch` — a numpy array (data, ``idx[B, k]`` hypothesis
    indices, slot-plane or sampling permutations) -> a tensor, dtype kept;
  * :func:`data_to_torch` — an estimator's data of arrays: a point array,
    a ``Frame`` (fields ``r``, ``t``), a ``Ray3D`` (fields ``p``, ``n``), a
    ``(first, second)`` pair or an ultrasound ``(Frame, q)`` /
    ``(Frame, q, p)`` tuple -> the port's tree of tensors;
  * :func:`result_to_numpy` — a :class:`RansacResult` of tensors -> the same
    fields as numpy arrays.
"""

import numpy as np

from lsqrrecipes_tpu_torch.device import as_tensor, resolve_device
from lsqrrecipes_tpu_torch.estimators import (
    AbsoluteOrientationEstimator,
    CrosswireUSCalibrationEstimator,
    DenseLinearSystemEstimator,
    Line2DEstimator,
    LineEstimator,
    PivotCalibrationEstimator,
    PlaneEstimator,
    PlanePhantomUSCalibrationEstimator,
    PointerUSCalibrationEstimator,
    RayIntersectionEstimator,
    SphereEstimator,
)
from lsqrrecipes_tpu_torch.geometry import Frame, Ray3D
from lsqrrecipes_tpu_torch.linalg import LMConfig
from lsqrrecipes_tpu_torch.ransac.engine import RansacResult

_FROM_ATTRS = {
    "sphere": lambda a: SphereEstimator(
        float(a.delta), int(a.dim), str(a.ls_type), LMConfig(*a.lm_config)),
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
    "us_crosswire": lambda a: CrosswireUSCalibrationEstimator(
        float(a.delta), str(a.ls_type), LMConfig(*a.lm_config)),
    "us_pointer": lambda a: PointerUSCalibrationEstimator(
        float(a.delta), str(a.ls_type), LMConfig(*a.lm_config)),
    "us_plane_phantom": lambda a: PlanePhantomUSCalibrationEstimator(
        float(a.delta), str(a.ls_type), LMConfig(*a.lm_config)),
}


def estimator_from_attrs(attrs):
    """The port's estimator for ``attrs.registry_name`` with the same
    ``delta`` (and ``dim``, ``ls_type``, ``lm_config``, ``n`` or
    ``cross_eps``); ``KeyError`` for an unknown name."""
    return _FROM_ATTRS[attrs.registry_name](attrs)


def sphere_estimator_from_attrs(attrs) -> SphereEstimator:
    return _FROM_ATTRS["sphere"](attrs)


def to_torch(array_np, device=None):
    """``np.asarray(array_np)`` as a tensor on ``device`` (default CUDA)."""
    return as_tensor(np.asarray(array_np), device)


def data_to_torch(data, device=None, dtype=None):
    """Estimator data of arrays -> the port's tensors on ``device`` (default
    CUDA), dtype kept unless given: a ``Frame`` for anything with fields
    ``(r, t)``, a ``Ray3D`` for fields ``(p, n)``, a tuple of converted
    entries for a tuple (a pair of arrays, or a ``Frame`` and arrays)."""
    fields = getattr(type(data), "_fields", None)
    if fields is None and not isinstance(data, (tuple, list)):
        return as_tensor(np.asarray(data), device, dtype)
    if fields is None:
        dev = resolve_device(device, _first_leaf(data))
        return tuple(data_to_torch(x, dev, dtype) for x in data)
    leaves = as_tensor(tuple(np.asarray(x) for x in data), device, dtype)
    if fields == ("r", "t"):
        return Frame(*leaves)
    if fields == ("p", "n"):
        return Ray3D(*leaves)
    return leaves


def _first_leaf(data):
    while isinstance(data, (tuple, list)):
        data = data[0]
    return data


def result_to_numpy(result: RansacResult) -> RansacResult:
    return RansacResult(*(t.detach().cpu().numpy() for t in result))
