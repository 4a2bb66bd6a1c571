"""Sweeps sharded over the ``hypotheses`` axis of a mesh (counterpart of
``lsqrrecipes_tpu/parallel/fused.py``).

  * :func:`sharded_fused_sweep` — every process runs the whole fused sweep
    (:func:`lsqrrecipes_tpu_torch.ops.fused_sweep.fused_sweep`, one kernel
    launch) on the replicated data with its own randomness, so the processes
    evaluate disjoint, independently permuted hypothesis sets; the winner is
    the all-gathered best count's argmax (the lowest rank wins ties) and its
    parameters reach every process by a masked Sum all-reduce.  One scalar
    all-gather and one ``[P]`` all-reduce per sweep.
  * :func:`sharded_us_sweep` — the ultrasound structured sweep's planar
    sampling planes split in blocks over ``hypotheses``; each process fits
    and votes its block (the plane phantom's subspace kernel once per
    chunk) and the counts and parameters are all-gathered, so every process
    holds the single-device ``structured_sweep``'s result on the same
    hypotheses.
"""

import torch

from lsqrrecipes_tpu_torch.device import as_tensor
from lsqrrecipes_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size, default_mesh
from lsqrrecipes_tpu_torch.parallel.sharded import all_gather_cat, select_broadcast
from lsqrrecipes_tpu_torch.tree import tree_leaves


def _rank_generator(generator, rank, device):
    """A generator of this process's own: seeded from one draw of
    ``generator`` (the same draw on every process seeded alike) and the
    rank, the counterpart of JAX's ``fold_in(key, rank)``."""
    gdev = generator.device if generator is not None else torch.device("cpu")
    seed = int(torch.randint(0, 1 << 62, (), generator=generator, device=gdev))
    return torch.Generator(device=device).manual_seed(hash((seed, rank)) & ((1 << 63) - 1))


def sharded_fused_sweep(
    family: str,
    data,
    generator=None,
    total_groups: int = 1,
    delta=1.0,
    mesh=None,
    hypotheses_axis: str = "hypotheses",
    vote_subsample: int = 0,
    *,
    perms=None,
    device=None,
):
    """The whole fused sweep over a mesh -> ``(best_count int32[],
    best_params)``, replicated on every process.

    ``total_groups`` is the global budget: each of the H processes runs
    ``ceil(total_groups / H)`` groups.  Each process draws its slot-plane
    permutations, and with ``vote_subsample`` its vote order, from a
    generator of its own (:func:`_rank_generator`), or takes its slot-plane
    permutations from ``perms[rank]`` (``[H, 4 k_slots, n_fit]``).  On CPU
    tensors each process runs the kernel's plain version, as ``fused_sweep``
    does."""
    from lsqrrecipes_tpu_torch.ops import fused_sweep as fs

    data = as_tensor(data, device)
    dev = tree_leaves(data)[0].device
    mesh = mesh if mesh is not None else default_mesh((hypotheses_axis,), device_type=dev.type)
    h, rank = axis_size(mesh, hypotheses_axis), axis_rank(mesh, hypotheses_axis)
    group = axis_group(mesh, hypotheses_axis)
    count, params = fs.fused_sweep(
        family, data, _rank_generator(generator, rank, dev), -(-total_groups // h), delta,
        vote_subsample=vote_subsample, perms=None if perms is None else perms[rank],
    )
    counts = all_gather_cat(count.reshape(1), group, h)
    winner = torch.argmax(counts)                        # lowest rank wins ties
    return counts[winner], select_broadcast(params, winner == rank, group)


def sharded_us_sweep(kind, est, data, generator=None, groups: int = 1, mesh=None,
                     hypotheses_axis: str = "hypotheses", *, perm=None, device=None):
    """The ultrasound structured sweep split over ``hypotheses`` ->
    ``(counts [B], params [B, P])`` on every process, ``B = groups * n``: the
    hypotheses of ``est.structured_sweep(data, generator, groups, perm)``,
    ``counts`` -1 where the fit is degenerate.  Every process must use the
    same permutation (``perm``, or ``generator`` seeded alike), and
    ``groups`` must divide by the axis size (whole groups per process)."""
    from lsqrrecipes_tpu_torch.ops import us_fast

    data = as_tensor(data, device)
    dev = tree_leaves(data)[0].device
    mesh = mesh if mesh is not None else default_mesh((hypotheses_axis,), device_type=dev.type)
    h, rank = axis_size(mesh, hypotheses_axis), axis_rank(mesh, hypotheses_axis)
    if groups % h:
        raise ValueError(f"groups ({groups}) must be divisible by the "
                         f"'{hypotheses_axis}' axis size ({h})")
    planes, feats = us_fast.build_sampling_planes(kind, data, generator, groups, perm)
    b_shard = planes.shape[-1] // h
    counts, params = us_fast.fit_and_vote_planes(
        kind, float(est.delta_squared), planes[..., rank * b_shard : (rank + 1) * b_shard], feats)
    group = axis_group(mesh, hypotheses_axis)
    return all_gather_cat(counts, group, h), all_gather_cat(params, group, h)
