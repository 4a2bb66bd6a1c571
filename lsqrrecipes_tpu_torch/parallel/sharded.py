"""RANSAC sharded over hypotheses and observations on ``torch.distributed``
(counterpart of ``lsqrrecipes_tpu/parallel/sharded.py``).

Every process of a ``(hypotheses, data)`` mesh (:mod:`.mesh`) runs the same
program on its blocks, the JAX package's ``shard_map`` step:

  * **hypotheses** — the ``[B, k]`` index batch is split in blocks over the
    ``hypotheses`` axis; the data is replicated for the k-subset gathers, so
    each process fits its block of minimal samples;
  * **data** — observations are split in blocks over ``data``; each process
    votes its hypotheses on its block (the engine's vote: the estimator's
    ``vote_counts``, else ``agree`` sums) and the counts are Sum-reduced
    over ``data`` (-1 where a fit is degenerate);
  * **selection** — each process takes the argmax of its counts, the local
    maxima are all-gathered over ``hypotheses`` and the argmax taken again:
    the lowest index, then the lowest rank, wins ties, the serial engine's
    first-best-wins; the winner's mask reaches every process by a masked
    Sum all-reduce;
  * **refit** — where the estimator has sufficient statistics they are
    Sum-reduced over ``data``; otherwise ``lsq_fit`` runs on the mask
    gathered over ``data``.

The only collectives are Sum all-reduces and all-gathers, as in the JAX
package.  Results are replicated on every process.  Every process must be
given the same data and the same hypothesis indices (or a generator seeded
alike on every process); the observation count must divide into the
``data`` blocks and the hypothesis count into the ``hypotheses`` blocks.
"""

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from lsqrrecipes_tpu_torch.device import as_tensor
from lsqrrecipes_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size, default_mesh
from lsqrrecipes_tpu_torch.ransac.sampling import sample_k_subsets
from lsqrrecipes_tpu_torch.tree import n_obs, tree_leaves, tree_map


class ShardedRansacResult(NamedTuple):
    params: torch.Tensor           # refit parameters
    valid: torch.Tensor            # [] bool
    best_count: torch.Tensor       # [] int
    inlier_fraction: torch.Tensor  # [] best_count / n
    consensus: torch.Tensor        # [n] bool


def all_reduce_sum(t, group):
    """The Sum all-reduce of ``t`` over ``group``, on a copy."""
    out = t.clone().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather_cat(t, group, size):
    """``t`` of every process of ``group`` concatenated along axis 0, in rank
    order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def select_broadcast(value, selected, group):
    """``value`` of the process where ``selected`` is True, on every process:
    exactly one contributes to a Sum all-reduce."""
    return all_reduce_sum(torch.where(selected, value, torch.zeros_like(value)), group)


def _block(tree, rank, size):
    """Block ``rank`` of ``size`` equal blocks of every leaf's leading axis."""
    n = n_obs(tree)
    if n % size:
        raise ValueError(f"{n} observations do not split into {size} equal blocks; pad the data")
    m = n // size
    return tree_map(lambda leaf: leaf[rank * m : (rank + 1) * m], tree)


def _device_type(data):
    return tree_leaves(data)[0].device.type


def build_sharded_ransac_step(
    est,
    mesh,
    hypotheses_axis: str = "hypotheses",
    data_axis: Optional[str] = "data",
):
    """The sharded step ``(data, idx) -> ShardedRansacResult`` on ``mesh``.

    ``data``: every observation, on every process (tensors on the mesh's
    device type); ``idx``: the whole ``[B, k]`` index batch, B a multiple of
    the ``hypotheses`` axis size."""
    h_size = axis_size(mesh, hypotheses_axis)
    h_rank = axis_rank(mesh, hypotheses_axis)
    h_group = axis_group(mesh, hypotheses_axis)
    d_size = axis_size(mesh, data_axis) if data_axis else 1
    d_rank = axis_rank(mesh, data_axis) if d_size > 1 else 0
    d_group = axis_group(mesh, data_axis) if d_size > 1 else None

    def run(data, idx):
        from lsqrrecipes_tpu_torch.ransac import engine

        n = n_obs(data)
        b = idx.shape[0]
        if b % h_size:
            raise ValueError(f"{b} hypotheses do not split into {h_size} equal blocks")
        b_blk = b // h_size
        idx_blk = idx[h_rank * b_blk : (h_rank + 1) * b_blk]
        data_blk = _block(data, d_rank, d_size)

        params, valid = est.minimal_fit(engine._gather(data, idx_blk))
        counts = engine.vote_counts(est, params, data_blk).to(torch.int64)
        if d_group is not None:
            counts = all_reduce_sum(counts, d_group)
        counts = torch.where(valid, counts, torch.full_like(counts, -1))

        li = torch.argmax(counts)
        all_max = all_gather_cat(counts[li].reshape(1), h_group, h_size)
        winner = torch.argmax(all_max)               # lowest rank wins ties
        global_max = all_max[winner]
        mask_blk = select_broadcast(est.agree(params[li], data_blk).to(torch.int32),
                                    winner == h_rank, h_group) > 0
        mask = mask_blk if d_group is None else all_gather_cat(mask_blk, d_group, d_size)

        if est.has_stats:
            stats = est.lsq_stats(data_blk, mask_blk)
            if d_group is not None:
                stats = tree_map(lambda s: all_reduce_sum(s, d_group), stats)
            final, ok = est.lsq_solve_stats(stats)
        else:
            final, ok = est.lsq_fit(data, mask)
        return ShardedRansacResult(
            params=final,
            valid=torch.as_tensor(ok, device=global_max.device) & (global_max > 0),
            best_count=global_max,
            inlier_fraction=torch.clamp_min(global_max, 0).to(torch.float64) / n,
            consensus=mask,
        )

    return run


def sharded_ransac(
    est,
    data,
    generator=None,
    num_hypotheses: int = 4096,
    mesh=None,
    hypotheses_axis: str = "hypotheses",
    data_axis: Optional[str] = "data",
    *,
    device=None,
) -> ShardedRansacResult:
    """One sharded RANSAC step over ``mesh`` (default: every process on
    ``hypotheses``): ``num_hypotheses`` rounded up to a multiple of the
    ``hypotheses`` axis, drawn as distinct k-subsets from ``generator``,
    which every process must seed alike."""
    data = as_tensor(data, device)
    mesh = mesh if mesh is not None else default_mesh(device_type=_device_type(data))
    h = axis_size(mesh, hypotheses_axis)
    b = -(-num_hypotheses // h) * h
    idx = sample_k_subsets(generator, n_obs(data), est.k, b, tree_leaves(data)[0].device)
    return build_sharded_ransac_step(est, mesh, hypotheses_axis, data_axis)(data, idx)


def sharded_lsq_fit(est, data, mask=None, mesh=None, data_axis: str = "data", *, device=None):
    """Least squares over observations split on ``data_axis``: each process
    reduces its block to the estimator's sufficient statistics, which are
    Sum-reduced and solved on every process."""
    data = as_tensor(data, device)
    mesh = mesh if mesh is not None else default_mesh((data_axis,),
                                                      device_type=_device_type(data))
    size, rank, group = axis_size(mesh, data_axis), axis_rank(mesh, data_axis), \
        axis_group(mesh, data_axis)
    n = n_obs(data)
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=tree_leaves(data)[0].device)
    stats = est.lsq_stats(_block(data, rank, size), _block(mask, rank, size))
    return est.lsq_solve_stats(tree_map(lambda s: all_reduce_sum(s, group), stats))


def sharded_us_feature_lm(kind, data, x0, mask=None, config=None, mesh=None,
                          data_axis: str = "data", *, device=None):
    """The sufficient-statistics LM refit of an ultrasound objective
    (:mod:`lsqrrecipes_tpu_torch.linalg.stats_lm`) over observations split on
    ``data_axis``.

    The feature Gram is additive over observations, so the refit is two Sum
    all-reduces, independent of the observation and iteration counts: the
    ``[F]`` weighted feature sum (the global centering mean), then the
    ``[F, F]`` Gram of the centered features; every process then runs the
    same solve (:func:`stats_lm.centered_stats` with a Sum all-reduce).
    Centering the features before the Gram is built keeps the unsharded
    refit's precision (the one-reduction raw-Gram
    congruence, ``stats_lm.centered_from_gram``, perturbs it by
    ``eps * (raw scale)``).  Returns a replicated ``LMResult``."""
    data = as_tensor(data, device)
    run = build_sharded_us_feature_lm(kind, x0, config=config, mesh=mesh, data_axis=data_axis,
                                      data_tree=data)
    return run(data, mask)


def build_sharded_us_feature_lm(kind, x0, config=None, mesh=None, data_axis: str = "data",
                                data_tree=None):
    """The step behind :func:`sharded_us_feature_lm`: ``(data, mask) ->
    LMResult``.  ``data_tree`` is required: data of the structure the step
    will be given (the data itself will do); the step refuses data of
    another structure."""
    from lsqrrecipes_tpu_torch.linalg import stats_lm
    from lsqrrecipes_tpu_torch.linalg.lm import LMConfig

    if data_tree is None:
        raise ValueError(
            "build_sharded_us_feature_lm needs data_tree (data of the structure the step "
            "will be given) to split the observations"
        )
    config = LMConfig() if config is None else config
    mesh = mesh if mesh is not None else default_mesh((data_axis,),
                                                      device_type=_device_type(data_tree))
    size, rank, group = axis_size(mesh, data_axis), axis_rank(mesh, data_axis), \
        axis_group(mesh, data_axis)
    n_leaves = len(tree_leaves(data_tree))

    def run(data, mask=None):
        if len(tree_leaves(data)) != n_leaves:
            raise ValueError("data does not have the structure of data_tree")
        w_fn_c, gram = stats_lm.centered_stats(
            kind, _block(data, rank, size), None if mask is None else _block(mask, rank, size),
            lambda t: all_reduce_sum(t, group))
        return stats_lm.feature_lm(w_fn_c, gram, as_tensor(x0, gram.device, gram.dtype), config)

    return run
