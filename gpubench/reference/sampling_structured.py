"""The hypothesis set of one structured sweep, worked out again from its seed.

A structured sweep (the sweep of an estimator that no fused kernel serves)
of ``k``-point hypotheses over ``n`` observations has ``groups = ceil(
hypotheses / n)`` groups of ``n`` hypotheses.  It draws one permutation
``perm`` of ``range(n)`` from the caller's generator, its first and only
draw.  Group ``g`` has a row of shifts ``[0, s_1 .. s_{k-1}]``: ``k - 1``
distinct values of ``1 .. n - 1``, drawn group after group by numpy's
``default_rng(1234567 + groups * 1000003 + k)`` and sorted.  Hypothesis
``(g, i)`` takes for slot ``j`` the observation ``perm[(i + s_j) % n]``;
hypotheses run group-major, ``i`` minor.

This is a frozen description of the sweep's sampling design, kept here so
the reference can rebuild the same hypotheses from the same seed.  A
configuration names it with ``"sampling": "structured"``.
"""

import numpy as np
import torch


def shift_table(n, k, groups):
    """``int64 [groups, k]``: each group's row of shifts."""
    rng = np.random.default_rng(1234567 + groups * 1000003 + k)
    table = np.zeros((groups, k), dtype=np.int64)
    for g in range(groups):
        table[g, 1:] = np.sort(rng.choice(np.arange(1, n), size=k - 1, replace=False))
    return table


def hypothesis_indices(seed, n, k, hypotheses, device, cells):
    """Observation indices ``[rows, k]`` of the hypotheses of a sweep seeded
    ``seed``, over ``n`` observations, in hypothesis order: chunks of at most
    ``cells`` hypothesis-point cells (one hypothesis where ``n`` alone is
    more)."""
    groups = max(1, -(-hypotheses // n))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    perm = torch.randperm(n, generator=gen, device=device)
    table = torch.as_tensor(shift_table(n, k, groups), device=device)
    total = groups * n
    step = max(1, cells // n)
    for h0 in range(0, total, step):
        h = torch.arange(h0, min(total, h0 + step), device=device)
        yield perm[(h[:, None] % n + table[h // n]) % n]
