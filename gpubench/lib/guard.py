"""Checks that the measured process never loaded JAX or the JAX package.

Names are compared whole by their top-level part (before the first dot):
``lsqrrecipes_tpu_torch`` is the port, ``lsqrrecipes_tpu`` the JAX package.
"""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "lsqrrecipes_tpu")


def top_level(name):
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None):
    """Sorted forbidden top-level names present in ``modules`` (default
    ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & set(FORBIDDEN))
