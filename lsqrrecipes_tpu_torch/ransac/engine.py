"""Batched RANSAC (counterpart of ``lsqrrecipes_tpu/ransac/engine.py``).

A fixed batch of hypotheses is drawn up front; minimal fits are batched;
degenerate samples get count -1 so they never win; the best hypothesis is an
argmax whose ties go to the lowest index; the consensus refit is the
estimator's masked least squares (``RANSAC.hxx:128-139``).

Drivers: :func:`ransac` (fixed budget, gathered samples),
:func:`ransac_structured` (permutation + shifts), :func:`ransac_fused_sweep`
(the whole sweep as one kernel, falling back to ``ransac_structured`` where
the fused sweep does not apply), :func:`ransac_adaptive` (rounds with the
reference's adaptive budget), :func:`ransac_exhaustive` (every C(n, k)
subset) and :func:`ransac_batched` (a fleet of datasets, one generator
each).  Each takes a ``torch.Generator`` where the JAX package takes a
``key``, runs on the data's device (numpy data goes to ``device``, default
CUDA) and raises when CUDA is asked for and missing.

Data may be a tree (:mod:`lsqrrecipes_tpu_torch.tree`): a tensor, a
``Frame`` or ``Ray3D``, or a ``(first, second)`` pair; ``n``, the dtype and
the device come from its first leaf, and samples are gathered leaf by leaf.
Estimators may provide ``vote_counts(params[B, P], data) -> counts[B]``;
without it, counts are sums of ``agree`` rows, chunked over hypotheses.
"""

import itertools
from typing import NamedTuple

import numpy as np
import torch

from lsqrrecipes_tpu_torch.device import as_tensor
from lsqrrecipes_tpu_torch.ransac.sampling import (
    choose,
    num_tries,
    sample_k_subsets,
    sample_k_with_replacement,
    structured_samples,
)
from lsqrrecipes_tpu_torch.tree import n_obs, tree_leaves, tree_map
from lsqrrecipes_tpu_torch.utils import profiling

# Above this many [B, n] cells, exact distinct-subset sampling (which draws
# a [B, n] uniform matrix) is replaced by with-replacement sampling whose
# rare duplicate rows self-mask as degenerate hypotheses.
_EXACT_SAMPLING_CELLS = 1 << 24

# Elements of one [chunk, n, d] agree temporary in the vote fallback.
_AGREE_CELLS = 1 << 24


def _sample(generator, n, k, num_hypotheses, sampler="auto", device=None):
    if sampler == "auto":
        sampler = (
            "with_replacement" if num_hypotheses * n > _EXACT_SAMPLING_CELLS else "exact"
        )
    if sampler == "exact":
        return sample_k_subsets(generator, n, k, num_hypotheses, device)
    return sample_k_with_replacement(generator, n, k, num_hypotheses, device)


class RansacResult(NamedTuple):
    params: torch.Tensor           # [P] refit parameters (garbage if not valid)
    valid: torch.Tensor            # [] bool
    inlier_fraction: torch.Tensor  # [] best consensus size / n
    consensus: torch.Tensor        # [n] bool mask of the winning consensus set
    best_count: torch.Tensor       # [] int
    minimal_params: torch.Tensor   # [P_min] winning minimal-fit parameters


def _leaf(data):
    """The first leaf: it fixes the data's dtype and device."""
    return tree_leaves(data)[0]


def _gather(data, idx):
    """``data`` at observation indices ``idx`` (any shape), leaf by leaf."""
    idx = as_tensor(idx, _leaf(data).device, torch.int64)
    return tree_map(lambda leaf: leaf[idx], data)


def _select(est, data, counts, params):
    """Argmax (ties to the lowest index) -> ``(count, mask[n], params)``."""
    best = torch.argmax(counts)
    best_params = params[best]
    return counts[best], est.agree(best_params, data), best_params


def _agree_counts(est, params, data):
    """``sum(est.agree(p, data))`` for every row of ``params``, in chunks
    that keep the ``[chunk, n, d]`` temporaries (of every leaf) bounded."""
    cells = sum(leaf.numel() for leaf in tree_leaves(data))
    chunk = max(1, _AGREE_CELLS // max(1, cells))
    out = [torch.zeros((0,), dtype=torch.int64, device=_leaf(data).device)]
    for b0 in range(0, params.shape[0], chunk):
        out.append(torch.sum(est.agree(params[b0 : b0 + chunk], data), dim=-1))
    return torch.cat(out)


def vote_counts(est, params, data):
    """Counts of a hypothesis batch: the estimator's ``vote_counts`` if it
    has one, else ``agree`` sums."""
    if hasattr(est, "vote_counts"):
        return est.vote_counts(params, data)
    return _agree_counts(est, params, data)


def _vote(est, params, valid, data):
    """:func:`vote_counts`, -1 where the minimal fit is degenerate."""
    counts = vote_counts(est, params, data)
    return torch.where(valid, counts, torch.full_like(counts, -1))


def hypothesize_and_vote(est, data, idx):
    """Evaluate one batch of minimal-sample hypotheses.

    idx: ``[B, k]`` indices -> ``(best_count, best_mask[n], best_params)``.
    Only the winner's ``[n]`` agree mask is kept, never a ``[B, n]`` one.
    """
    params, valid = est.minimal_fit(_gather(data, idx))
    return _select(est, data, _vote(est, params, valid, data), params)


def consensus_refit(est, data, mask):
    with profiling.span("refit"):
        return est.lsq_fit(data, mask)


def hypothesize_and_vote_structured(est, data, generator, groups, perm=None):
    """Variant of :func:`hypothesize_and_vote` on ``groups * n`` structured
    samples (:func:`~lsqrrecipes_tpu_torch.ransac.sampling.structured_samples`).
    Estimator hooks, in priority order:

      * ``structured_sweep(data, generator, groups, perm) -> (counts,
        params)`` draws the same hypothesis set itself, never materialising
        the samples (the ultrasound estimators);
      * ``fit_and_vote(samples, data) -> (counts, params)`` fits and votes
        materialised samples;
      * otherwise ``minimal_fit`` and :func:`hypothesize_and_vote`'s vote.

    ``perm`` fixes the sampling permutation."""
    if hasattr(est, "structured_sweep"):
        counts, params = est.structured_sweep(data, generator, groups, perm)
        return _select(est, data, counts, params)
    samples = structured_samples(generator, data, est.k, groups, perm)
    if hasattr(est, "fit_and_vote"):
        counts, params = est.fit_and_vote(samples, data)
    else:
        params, valid = est.minimal_fit(samples)
        counts = _vote(est, params, valid, data)
    return _select(est, data, counts, params)


def ransac_structured(est, data, generator=None, num_hypotheses: int = 4096,
                      *, device=None) -> RansacResult:
    """RANSAC with structured (permutation + shift) sampling."""
    data = as_tensor(data, device)
    n = n_obs(data)
    if n < est.k:
        return _invalid_result(est, data)
    groups = max(1, -(-num_hypotheses // n))
    best_count, best_mask, best_params = hypothesize_and_vote_structured(
        est, data, generator, groups
    )
    return _finalize(est, data, best_count, best_mask, best_params, n)


def ransac_fused_sweep(
    est,
    data,
    generator=None,
    num_hypotheses: int = 4096,
    groups_per_step: int = 1,
    vote_subsample: int = 0,
    *,
    device=None,
) -> RansacResult:
    """The whole sweep as one kernel (:mod:`lsqrrecipes_tpu_torch.ops.fused_sweep`)
    where the estimator declares a ported ``fused_family`` and the data fits
    its shift hash; otherwise :func:`ransac_structured`.  The winner is
    recounted with ``est.agree``: the kernel's count only selects it."""
    from lsqrrecipes_tpu_torch.ops import fused_sweep as fs

    with profiling.span("engine.fit", new_fit=True):
        data = as_tensor(data, device)
        family = getattr(est, "fused_family", None)
        n = n_obs(data)
        if n < est.k:
            return _invalid_result(est, data)
        if not (family and fs.supports_data(family, data)):
            return ransac_structured(est, data, generator, num_hypotheses)
        total_groups = max(1, -(-num_hypotheses // n))
        _count, params = fs.fused_sweep(
            family, data, generator, total_groups, _fused_delta(est),
            groups_per_step=groups_per_step, vote_subsample=vote_subsample,
        )
        best_params = params.to(_leaf(data).dtype)
        # The kernel's f32 band count can disagree with est.agree by a few
        # border points (and with vote_subsample counts only the subsample):
        # report the exact consensus size.
        with profiling.leaf("engine.agree"):
            best_mask = est.agree(best_params, data)
            count = torch.sum(best_mask)
        return _finalize(est, data, count, best_mask, best_params, n)


def _fused_delta(est):
    return getattr(est, "fused_delta", None) or est.delta


def _nparams_lsq(est):
    return getattr(est, "nparams_lsq", est.nparams)


def _finalize(est, data, best_count, best_mask, best_params, n):
    with profiling.wait("count"):
        count = int(best_count)
    ok = count > 0
    if ok:
        params, valid = consensus_refit(est, data, best_mask)
    else:
        leaf = _leaf(data)
        params = torch.zeros((_nparams_lsq(est),), dtype=leaf.dtype, device=leaf.device)
        valid = torch.tensor(False, device=leaf.device)
    return RansacResult(
        params=params,
        valid=valid & ok,
        inlier_fraction=torch.tensor(max(count, 0) / n, dtype=torch.float64),
        consensus=best_mask,
        best_count=torch.tensor(count),
        minimal_params=best_params,
    )


def ransac(est, data, generator=None, num_hypotheses: int = 4096,
           sampler: str = "auto", *, device=None) -> RansacResult:
    """Fixed-budget batched RANSAC: ``num_hypotheses`` minimal subsets drawn
    at once, one hypothesize + vote + select step, then the refit."""
    data = as_tensor(data, device)
    n = n_obs(data)
    if n < est.k:
        return _invalid_result(est, data)
    idx = _sample(generator, n, est.k, num_hypotheses, sampler, _leaf(data).device)
    best_count, best_mask, best_params = hypothesize_and_vote(est, data, idx)
    return _finalize(est, data, best_count, best_mask, best_params, n)


def ransac_batched(est, data, generators=None, num_hypotheses: int = 4096, *, perms=None,
                   device=None) -> RansacResult:
    """Fleet RANSAC: D independent datasets of equal size, stacked on a
    leading axis of every leaf (``[D, n, ...]``), one generator each
    (``generators``: a sequence of D, or None).  Each dataset runs
    :func:`hypothesize_and_vote_structured` and the estimator's masked
    refit on the winner's consensus (no recount, as in the JAX package);
    ``inlier_fraction`` is ``max(count, 0) / n``.  Returns a
    :class:`RansacResult` whose fields carry the leading ``[D]`` axis.  A
    loop over the datasets stands in for the JAX package's ``vmap``; on a
    sphere at float32 each dataset's vote launches the sphere vote kernel
    once.  ``perms`` (``[D, n]``) fixes
    each dataset's sampling permutation."""
    data = as_tensor(data, device)
    num = tree_leaves(data)[0].shape[0]
    n = n_obs(tree_map(lambda leaf: leaf[0], data))
    if n < est.k:
        raise ValueError(f"need at least k={est.k} observations per dataset")
    if generators is None:
        generators = [None] * num
    if len(generators) != num:
        raise ValueError(f"need {num} generators, got {len(generators)}")
    groups = max(1, -(-num_hypotheses // n))
    fields = []
    for d in range(num):
        data_d = tree_map(lambda leaf: leaf[d], data)
        count, mask, params = hypothesize_and_vote_structured(
            est, data_d, generators[d], groups, None if perms is None else perms[d])
        refit, rvalid = est.lsq_fit(data_d, mask)
        fields.append(RansacResult(
            params=refit,
            valid=rvalid & (count > 0),
            inlier_fraction=torch.clamp_min(count, 0).to(torch.float64) / n,
            consensus=mask,
            best_count=count,
            minimal_params=params,
        ))
    return RansacResult(*(torch.stack(list(f)) for f in zip(*fields)))


def _round_fast(est, data, generator, groups):
    """One adaptive round through the fast paths: the fused sweep where the
    estimator declares a supported ``fused_family``, otherwise the
    structured hypothesize + vote.  Same ``(count, mask[n], params)``
    contract as :func:`hypothesize_and_vote`; the fused count is recounted
    from the winner's ``agree`` mask."""
    from lsqrrecipes_tpu_torch.ops import fused_sweep as fs

    family = getattr(est, "fused_family", None)
    if family and fs.supports_data(family, data):
        _, params = fs.fused_sweep(family, data, generator, groups, _fused_delta(est))
        params = params.to(_leaf(data).dtype)
        mask = est.agree(params, data)
        return torch.sum(mask), mask, params
    return hypothesize_and_vote_structured(est, data, generator, groups)


def ransac_adaptive(
    est,
    data,
    generator=None,
    desired_probability: float = 0.999,
    batch_size: int = 1024,
    max_hypotheses: int = 1 << 20,
    path: str = "auto",
    *,
    device=None,
) -> RansacResult:
    """Adaptive-budget RANSAC: device-sized rounds, the budget
    ``log(1-p) / log(1-w^k)`` recomputed on the host after each round from
    the best inlier fraction so far (``RANSAC.hxx:100-111``); rounds stop
    once the evaluated hypotheses cover it or all C(n, k) subsets.

    ``path="auto"`` runs each round through the fast paths (the fused sweep
    where the estimator has one, else the structured sweep), whose
    hypotheses share one permutation per round; ``"gather"`` forces
    independently drawn ``[B, k]`` samples, the reference's semantics.
    """
    data = as_tensor(data, device)
    n = n_obs(data)
    if n < est.k or not 0.0 < desired_probability < 1.0:
        return _invalid_result(est, data)

    use_fast = path != "gather" and (
        hasattr(est, "structured_sweep") or hasattr(est, "fit_and_vote")
        or getattr(est, "fused_family", None)
    )
    all_tries = min(choose(n, est.k), max_hypotheses)
    budget = all_tries
    evaluated = 0
    best_count, best_mask, best_params = -1, None, None
    while evaluated < budget:
        if use_fast:
            groups = max(1, min(-(-batch_size // n), -(-(budget - evaluated) // n)))
            count, mask, params = _round_fast(est, data, generator, groups)
            evaluated += groups * n
        else:
            b = min(batch_size, budget - evaluated)
            idx = _sample(generator, n, est.k, b, "auto", _leaf(data).device)
            count, mask, params = hypothesize_and_vote(est, data, idx)
            evaluated += b
        if int(count) > best_count:
            best_count, best_mask, best_params = int(count), mask, params
            if best_count == n:
                break
            budget = min(num_tries(desired_probability, best_count / n, est.k, all_tries),
                         all_tries)
    if best_params is None:
        return _invalid_result(est, data)
    return _finalize(est, data, best_count, best_mask, best_params, n)


def ransac_exhaustive(est, data, batch_size: int = 8192, *, device=None) -> RansacResult:
    """Evaluate every C(n, k) subset, enumerated on the host in
    lexicographic order (the reference's recursion, ``RANSAC.hxx:149-248``)
    and voted in batches of ``batch_size``.  For small n."""
    data = as_tensor(data, device)
    n = n_obs(data)
    if n < est.k:
        return _invalid_result(est, data)
    best_count, best_mask, best_params = -1, None, None
    combos = itertools.combinations(range(n), est.k)
    while chunk := list(itertools.islice(combos, batch_size)):
        idx = torch.as_tensor(np.array(chunk, dtype=np.int64), device=_leaf(data).device)
        count, mask, params = hypothesize_and_vote(est, data, idx)
        if int(count) > best_count:
            best_count, best_mask, best_params = int(count), mask, params
    if best_params is None:
        return _invalid_result(est, data)
    return _finalize(est, data, best_count, best_mask, best_params, n)


def _invalid_result(est, data):
    """The result of a run that found nothing, in the data's dtype and on
    its device."""
    leaf = _leaf(data)
    like = {"dtype": leaf.dtype, "device": leaf.device}
    return RansacResult(
        params=torch.zeros((_nparams_lsq(est),), **like),
        valid=torch.tensor(False, device=leaf.device),
        inlier_fraction=torch.tensor(0.0, dtype=torch.float64),
        consensus=torch.zeros((max(n_obs(data), 1),), dtype=torch.bool, device=leaf.device),
        best_count=torch.tensor(-1),
        minimal_params=torch.zeros((est.nparams,), **like),
    )
