"""Carrying state between the JAX package and the port.

This system has no weights; its state is the estimator's configuration,
the data, and the hypothesis randomness.  These helpers take only numpy
arrays and plain attributes, so either side can produce them:

  * :func:`sphere_estimator_from_attrs` — any object with ``delta``, ``dim``
    and ``ls_type`` (such as the JAX package's ``SphereEstimator``) -> the
    port's estimator;
  * :func:`to_torch` — a numpy array (data, ``idx[B, k]`` hypothesis
    indices, slot-plane or sampling permutations) -> a tensor, dtype kept;
  * :func:`result_to_numpy` — a :class:`RansacResult` of tensors -> the same
    fields as numpy arrays.
"""

import numpy as np

from lsqrrecipes_tpu_torch.device import as_tensor
from lsqrrecipes_tpu_torch.estimators.sphere import SphereEstimator
from lsqrrecipes_tpu_torch.ransac.engine import RansacResult


def sphere_estimator_from_attrs(attrs) -> SphereEstimator:
    return SphereEstimator(float(attrs.delta), int(attrs.dim), str(attrs.ls_type))


def to_torch(array_np, device=None):
    """``np.asarray(array_np)`` as a tensor on ``device`` (default CUDA)."""
    return as_tensor(np.asarray(array_np), device)


def result_to_numpy(result: RansacResult) -> RansacResult:
    return RansacResult(*(t.detach().cpu().numpy() for t in result))
