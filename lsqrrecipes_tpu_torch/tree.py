"""Nested estimator data (the port's stand-in for ``jax.tree_util``).

An estimator's data is a tensor ``[n, ...]``, a ``NamedTuple`` of such
tensors (``Frame``, ``Ray3D``) or a plain tuple of them (the ``(first,
second)`` point pairs of absolute orientation), every leaf with the
observation axis first.  Tuples and named tuples are nodes; everything else,
lists and numpy arrays included, is a leaf.
"""


def _is_node(x) -> bool:
    return isinstance(x, tuple)


def tree_leaves(tree) -> list:
    """The leaves of ``tree``, depth first in field order."""
    if _is_node(tree):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``; a ``NamedTuple``
    keeps its type."""
    if not _is_node(tree):
        return fn(tree)
    mapped = [tree_map(fn, sub) for sub in tree]
    if hasattr(type(tree), "_fields"):
        return type(tree)(*mapped)
    return type(tree)(mapped)


def n_obs(tree) -> int:
    """The number of observations: the first leaf's leading size."""
    return tree_leaves(tree)[0].shape[0]
