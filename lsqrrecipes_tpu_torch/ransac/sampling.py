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

from lsqrrecipes_tpu_torch.device import as_tensor, draw_devices, generator_device
from lsqrrecipes_tpu_torch.tree import n_obs, tree_leaves, tree_map


def sample_k_subsets(generator, n, k, num_subsets, device=None):
    """Uniform random k-subsets of ``range(n)`` -> int64 ``[num_subsets, k]``
    (distinct within a row): the top-k indices of an iid uniform row.
    O(num_subsets * n) memory.  ``device=None``: the generator's device,
    else CUDA."""
    gdev, dev = draw_devices(generator, device)
    r = torch.rand((num_subsets, n), generator=generator, device=gdev)
    return torch.topk(r, k, dim=1).indices.to(dev)


def sample_k_with_replacement(generator, n, k, num_subsets, device=None):
    """O(num_subsets * k) sampler: independent uniform indices per row
    -> int64 ``[num_subsets, k]``.  A duplicate index makes the minimal
    sample degenerate, which the engine masks out."""
    gdev, dev = draw_devices(generator, device)
    return torch.randint(
        0, n, (num_subsets, k), generator=generator, device=gdev
    ).to(dev)


def sample_k_subsets_chunked(generator, n, k, num_subsets, chunk=4096, device=None):
    """Memory-bounded :func:`sample_k_subsets`: chunks of at most ``chunk``
    rows, each drawn from a generator of its own seeded by one draw from
    ``generator`` (``jax.random.split``'s one key per chunk)."""
    gdev, dev = draw_devices(generator, device)
    num_chunks = -(-num_subsets // chunk)
    seeds = torch.randint(0, 2**62, (num_chunks,), generator=generator, device=gdev).tolist()
    outs = [torch.zeros((0, k), dtype=torch.int64, device=dev)]
    for i, seed in enumerate(seeds):
        sub = torch.Generator(device=gdev).manual_seed(seed)
        outs.append(sample_k_subsets(sub, n, k, min(chunk, num_subsets - i * chunk), dev))
    return torch.cat(outs)


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
