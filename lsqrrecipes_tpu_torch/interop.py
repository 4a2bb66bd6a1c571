"""Carrying state between the JAX package and the port.

This system has no weights; its state is the estimator's configuration,
the data, and the hypothesis randomness.  These helpers take only numpy
arrays and plain attributes, so either side can produce them:

  * :func:`estimator_from_attrs` — any object with ``registry_name`` and
    ``delta`` (plus ``dim`` and ``ls_type`` where the estimator has them),
    such as a JAX package estimator -> the port's estimator of that name;
  * :func:`sphere_estimator_from_attrs` — the same for a sphere estimator,
    from ``delta``, ``dim`` and ``ls_type`` alone;
  * :func:`to_torch` — a numpy array (data, ``idx[B, k]`` hypothesis
    indices, slot-plane or sampling permutations) -> a tensor, dtype kept;
  * :func:`result_to_numpy` — a :class:`RansacResult` of tensors -> the same
    fields as numpy arrays.
"""

import numpy as np

from lsqrrecipes_tpu_torch.device import as_tensor
from lsqrrecipes_tpu_torch.estimators import (
    Line2DEstimator,
    LineEstimator,
    PlaneEstimator,
    SphereEstimator,
)
from lsqrrecipes_tpu_torch.ransac.engine import RansacResult

_FROM_ATTRS = {
    "sphere": lambda a: SphereEstimator(float(a.delta), int(a.dim), str(a.ls_type)),
    "plane": lambda a: PlaneEstimator(float(a.delta), int(a.dim)),
    "line": lambda a: LineEstimator(float(a.delta), int(a.dim)),
    "line2d": lambda a: Line2DEstimator(float(a.delta)),
}


def estimator_from_attrs(attrs):
    """The port's estimator for ``attrs.registry_name`` with the same
    ``delta`` (and ``dim``/``ls_type``); ``KeyError`` for an estimator the
    port does not have yet."""
    return _FROM_ATTRS[attrs.registry_name](attrs)


def sphere_estimator_from_attrs(attrs) -> SphereEstimator:
    return _FROM_ATTRS["sphere"](attrs)


def to_torch(array_np, device=None):
    """``np.asarray(array_np)`` as a tensor on ``device`` (default CUDA)."""
    return as_tensor(np.asarray(array_np), device)


def result_to_numpy(result: RansacResult) -> RansacResult:
    return RansacResult(*(t.detach().cpu().numpy() for t in result))
