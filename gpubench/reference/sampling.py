"""The hypothesis set of one fused sweep, worked out again from its seed.

A fused sweep of ``k``-point hypotheses over ``n`` observations draws
``4 k`` permutations of ``range(n_fit)`` from the caller's generator, in
order.  Slot ``j`` reads a plane of ``5 n_fit`` columns, permutations
``4j .. 4j+3`` laid end to end and the first again; hypothesis ``h = g
n_fit + lane`` takes for slot ``j`` the column ``128 s(g, j) + lane``, with
the shift ``s`` hashed from the group ``g``.  ``n_fit`` is the smallest
``128 * 2^i >= n`` whose hash fits in 31 bits, and observation rows past
``n`` repeat the first ones (row ``r`` is observation ``r mod n``).  The
number of groups is ``ceil(hypotheses / n)``.

This is a frozen description of the sweep's sampling design, kept here so
the reference can rebuild the same hypotheses from the same seed.
"""

import torch

HASH_A = 1103515245


def hash_constants(n_fit, k):
    """``(m, b, mask)`` of the shift hash at width ``n_fit``."""
    m = 4 * n_fit // 128
    b = m.bit_length() - 1
    return m, b, (1 << (k * b)) - 1


def fit_width(n, k):
    n_fit = 128
    while n_fit < n:
        n_fit *= 2
    m, b, _ = hash_constants(n_fit, k)
    if (1 << b) != m or k * b > 31:
        raise ValueError(f"no sweep width for n = {n}, k = {k}")
    return n_fit


def num_groups(hypotheses, n):
    return max(1, -(-hypotheses // n))


def draw_perms(seed, n_fit, k, device):
    """The ``4 k`` permutations a sweep draws from a generator seeded with
    ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.stack([torch.randperm(n_fit, generator=gen, device=device)
                        for _ in range(4 * k)])


def sample_indices(perms, n, k, g0, g1):
    """Observation indices ``[(g1 - g0) n_fit, k]`` of the hypotheses of
    groups ``g0 .. g1 - 1``, in hypothesis order."""
    n_fit = perms.shape[1]
    m, b, mask = hash_constants(n_fit, k)
    g = torch.arange(g0, g1, device=perms.device, dtype=torch.int64)
    lanes = torch.arange(n_fit, device=perms.device, dtype=torch.int64)
    slots = []
    for j in range(k):
        shift = (((g * HASH_A) & mask) >> (b * j)) & (m - 1)
        col = shift[:, None] * 128 + lanes[None, :]
        rows = perms[4 * j + (col // n_fit) % 4, col % n_fit]
        slots.append((rows % n).reshape(-1))
    return torch.stack(slots, dim=-1)
