"""The estimator protocol (counterpart of
``lsqrrecipes_tpu/estimators/base.py``).

  * ``minimal_fit(samples[..., k, d]) -> (params[..., P], valid[...])`` —
    exact fit, batched over leading axes; degenerate samples give
    ``valid=False`` with finite garbage parameters;
  * ``lsq_fit(data, mask=None) -> (params[P], valid)`` — least squares over
    all data or the masked consensus;
  * ``agree(params, data) -> bool[..., n]`` — the inlier predicate;
  * ``k`` / ``nparams`` — static problem sizes.
"""

from typing import Optional, Tuple

import torch


class Estimator:
    """Base class; concrete estimators override the core methods."""

    k: int          # minimum data items for an exact fit (numForEstimate)
    nparams: int    # length of the parameter vector

    def minimal_fit(self, samples) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def lsq_fit(self, data, mask: Optional[torch.Tensor] = None):
        raise NotImplementedError

    def agree(self, params, data) -> torch.Tensor:
        raise NotImplementedError


_REGISTRY = {}


def register(name):
    """Class decorator: register an estimator under ``name``."""

    def wrap(cls):
        _REGISTRY[name] = cls
        cls.registry_name = name
        return cls

    return wrap


def get(name) -> type:
    return _REGISTRY[name]


def names():
    return sorted(_REGISTRY)
