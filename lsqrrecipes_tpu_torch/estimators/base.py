"""The estimator protocol (counterpart of
``lsqrrecipes_tpu/estimators/base.py``).

  * ``minimal_fit(samples[..., k, d]) -> (params[..., P], valid[...])`` —
    exact fit, batched over leading axes; degenerate samples give
    ``valid=False`` with finite garbage parameters;
  * ``lsq_fit(data, mask=None) -> (params[P], valid)`` — least squares over
    all data or the masked consensus;
  * ``lsq_fit_batched(data, mask=None) -> (params[B, P], valid[B])`` — B
    independent ``lsq_fit`` problems stacked on a leading axis;
  * ``agree(params, data) -> bool[..., n]`` — the inlier predicate;
  * ``k`` / ``nparams`` — static problem sizes.

Optionally an estimator exposes sufficient statistics:
``lsq_stats(data, mask) -> stats`` and ``lsq_solve_stats(stats) -> (params,
valid)``, whose composition is its ``lsq_fit``.

The plane, line, 2D line and absolute-orientation statistics and the
sphere's algebraic system are formed in float64 from :func:`upcast` data:
float32 moments of a cloud far from the origin cancel in ``outer - s s^T /
n``.  Their statistics end in a :func:`dtype_tag`, from which the solve
takes the data's dtype for the params it returns.  The JAX package sums in
the data's dtype.
"""

from typing import Any, Optional, Tuple

import torch

from lsqrrecipes_tpu_torch.tree import tree_leaves, tree_map


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

    def lsq_fit_batched(self, data, mask: Optional[torch.Tensor] = None):
        """B independent ``lsq_fit`` refits: ``data`` is the estimator's data
        with a leading problem axis on every leaf (``[B, n, ...]``), ``mask``
        an optional ``[B, n]``.  Returns ``(params [B, P], valid [B])``.

        The JAX package vmaps ``lsq_fit``; here the default is a loop over
        the problems (the iterative refits ask the device when they are
        done, which ``torch.func.vmap`` cannot trace).  Estimators whose
        refit takes leading axes override it."""
        results = [
            self.lsq_fit(tree_map(lambda leaf: leaf[i], data), None if mask is None else mask[i])
            for i in range(tree_leaves(data)[0].shape[0])
        ]
        return (torch.stack([p for p, _ in results]),
                torch.stack([torch.as_tensor(v) for _, v in results]))

    def lsq_stats(self, data, mask: Optional[torch.Tensor] = None) -> Any:
        raise NotImplementedError(
            f"{type(self).__name__} does not provide sufficient statistics"
        )

    def lsq_solve_stats(self, stats) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError(
            f"{type(self).__name__} does not provide sufficient statistics"
        )

    @property
    def has_stats(self) -> bool:
        return type(self).lsq_stats is not Estimator.lsq_stats

    @staticmethod
    def _mask_or_ones(mask, n, dtype, device=None):
        if mask is None:
            return torch.ones((n,), dtype=dtype, device=device)
        return mask.to(dtype)


def upcast(leaf):
    """``leaf`` in float64, the dtype the consensus refits accumulate in (the
    identity on float64 data)."""
    return leaf.to(torch.float64)


def dtype_tag(leaf):
    """A zero of ``leaf``'s dtype that float64 sufficient statistics carry,
    so that the solve returns the params in the data's dtype; a Sum
    all-reduce keeps it."""
    return leaf.new_zeros(())


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
