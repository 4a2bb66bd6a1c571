"""Vectorised minimal-subset sampling (counterpart of
``lsqrrecipes_tpu/ransac/sampling.py``).

All hypotheses are drawn at once from a ``torch.Generator`` (the JAX
package's ``key``).  The two frameworks' generators give different numbers,
so parity tests hand both packages the same index arrays or permutations;
the structured shift table is numpy-seeded and identical in both.
"""

import math

import numpy as np
import torch

from lsqrrecipes_tpu_torch.device import as_tensor, generator_device
from lsqrrecipes_tpu_torch.tree import n_obs, tree_leaves, tree_map


def sample_k_subsets(generator, n, k, num_subsets, device="cpu"):
    """Uniform random k-subsets of ``range(n)`` -> int64 ``[num_subsets, k]``
    (distinct within a row): the top-k indices of an iid uniform row.
    O(num_subsets * n) memory."""
    gdev = generator_device(generator, device)
    r = torch.rand((num_subsets, n), generator=generator, device=gdev)
    return torch.topk(r, k, dim=1).indices.to(device)


def sample_k_with_replacement(generator, n, k, num_subsets, device="cpu"):
    """O(num_subsets * k) sampler: independent uniform indices per row
    -> int64 ``[num_subsets, k]``.  A duplicate index makes the minimal
    sample degenerate, which the engine masks out."""
    gdev = generator_device(generator, device)
    return torch.randint(
        0, n, (num_subsets, k), generator=generator, device=gdev
    ).to(device)


def structured_shift_table(n, k, groups):
    """THE canonical static shift table for structured sampling.

    ``int64[groups, k]``: row g is ``[0, s_g1, ..., s_g,k-1]`` with sorted
    distinct nonzero circular shifts, derived deterministically from
    ``(n, k, groups)`` — the same numpy draws as the JAX package, so both
    evaluate the identical hypothesis set for the same permutation.
    """
    rng = np.random.default_rng(1234567 + groups * 1000003 + k)
    table = np.zeros((groups, k), dtype=np.int64)
    for g in range(groups):
        pool = rng.choice(np.arange(1, n), size=k - 1, replace=False)
        table[g, 1:] = np.sort(pool)
    return table


def structured_samples(generator, data, k, groups, perm=None):
    """Gather-light minimal samples: one permutation + circular shifts.

    hypothesis (g, i) = ``{perm[i], perm[(i+s_g1)%n], ..., perm[(i+s_g,k-1)%n]}``
    with the shifts of :func:`structured_shift_table`.  ``perm`` (a
    permutation of ``range(n)``) is drawn from ``generator`` when not given.
    ``data`` may be a tree (:mod:`lsqrrecipes_tpu_torch.tree`); every leaf
    is sampled alike.  Returns samples with leading axes ``[groups * n, k]``.
    """
    n = n_obs(data)
    dev = tree_leaves(data)[0].device
    if perm is None:
        perm = torch.randperm(n, generator=generator, device=generator_device(generator, dev))
    perm = as_tensor(perm, dev, torch.int64)
    table = torch.as_tensor(structured_shift_table(n, k, groups), device=dev)
    rows = torch.arange(n, device=dev)
    idx = perm[(rows[None, :, None] + table[:, None, :]) % n]    # [G, n, k]
    return tree_map(lambda leaf: leaf[idx.reshape(groups * n, k)], data)


def num_tries(desired_probability, inlier_fraction, k, all_tries):
    """Adaptive iteration budget ``log(1-p) / log(1 - w^k)``, clamped to the
    number of distinct subsets (``RANSAC.hxx:100-111``)."""
    w = float(inlier_fraction)
    if w <= 0.0 or w >= 1.0:
        return all_tries
    denom = math.log(1.0 - w ** k)
    if denom == 0.0:
        return all_tries
    tries = int(math.log(1.0 - desired_probability) / denom + 0.5)
    return max(1, min(tries, all_tries))


def choose(n, k):
    """C(n, k) clamped to uint32 max on overflow (``RANSAC.hxx:253-280``)."""
    try:
        value = math.comb(int(n), int(k))
    except ValueError:
        return 0
    return min(value, 0xFFFFFFFF)
