"""Batched RANSAC (counterpart of ``lsqrrecipes_tpu/ransac/engine.py``).

A fixed batch of hypotheses is drawn up front; minimal fits are batched;
degenerate samples get count -1 so they never win; the best hypothesis is an
argmax whose ties go to the lowest index; the consensus refit is the
estimator's masked least squares (``RANSAC.hxx:128-139``).

Drivers ported so far (the main path): :func:`ransac` (fixed budget,
gathered samples), :func:`ransac_structured` (permutation + shifts) and
:func:`ransac_fused_sweep` (the whole sweep as one kernel, falling back to
``ransac_structured`` where the fused sweep does not apply).  Each takes a
``torch.Generator`` where the JAX package takes a ``key``, runs on the
data's device (numpy data goes to ``device``, default CUDA) and raises when
CUDA is asked for and missing.
"""

from typing import NamedTuple

import torch

from lsqrrecipes_tpu_torch.device import as_tensor
from lsqrrecipes_tpu_torch.ransac.sampling import (
    sample_k_subsets,
    sample_k_with_replacement,
    structured_samples,
)

# Above this many [B, n] cells, exact distinct-subset sampling (which draws
# a [B, n] uniform matrix) is replaced by with-replacement sampling whose
# rare duplicate rows self-mask as degenerate hypotheses.
_EXACT_SAMPLING_CELLS = 1 << 24


def _sample(generator, n, k, num_hypotheses, sampler="auto", device="cpu"):
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


def _select(est, data, counts, params):
    """Argmax (ties to the lowest index) -> ``(count, mask[n], params)``."""
    best = torch.argmax(counts)
    best_params = params[best]
    return counts[best], est.agree(best_params, data), best_params


def hypothesize_and_vote(est, data, idx):
    """Evaluate one batch of minimal-sample hypotheses.

    idx: ``[B, k]`` indices -> ``(best_count, best_mask[n], best_params)``.
    Votes through the estimator's ``vote_counts``, so the ``[B, n]`` agree
    matrix is never built.
    """
    params, valid = est.minimal_fit(data[as_tensor(idx, data.device, torch.int64)])
    counts = est.vote_counts(params, data)
    counts = torch.where(valid, counts, torch.full_like(counts, -1))
    return _select(est, data, counts, params)


def consensus_refit(est, data, mask):
    return est.lsq_fit(data, mask)


def hypothesize_and_vote_structured(est, data, generator, groups, perm=None):
    """Variant of :func:`hypothesize_and_vote` on ``groups * n`` structured
    samples (:func:`~lsqrrecipes_tpu_torch.ransac.sampling.structured_samples`),
    fitted and voted by the estimator's ``fit_and_vote(samples, data) ->
    (counts, params)`` hook.  ``perm`` fixes the sampling permutation."""
    samples = structured_samples(generator, data, est.k, groups, perm)
    counts, params = est.fit_and_vote(samples, data)
    return _select(est, data, counts, params)


def ransac_structured(est, data, generator=None, num_hypotheses: int = 4096,
                      *, device=None) -> RansacResult:
    """RANSAC with structured (permutation + shift) sampling."""
    data = as_tensor(data, device)
    n = data.shape[0]
    if n < est.k:
        return _invalid_result(est, n, data.device)
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

    data = as_tensor(data, device)
    family = getattr(est, "fused_family", None)
    n = data.shape[0]
    if n < est.k:
        return _invalid_result(est, n, data.device)
    if not (family and fs.supports_data(family, data)):
        return ransac_structured(est, data, generator, num_hypotheses)
    total_groups = max(1, -(-num_hypotheses // n))
    _count, params = fs.fused_sweep(
        family, data, generator, total_groups, est.delta,
        groups_per_step=groups_per_step, vote_subsample=vote_subsample,
    )
    best_params = params.to(data.dtype)
    best_mask = est.agree(best_params, data)
    # The kernel's f32 band count can disagree with est.agree by a few
    # border points (and with vote_subsample counts only the subsample):
    # report the exact consensus size.
    count = torch.sum(best_mask)
    return _finalize(est, data, count, best_mask, best_params, n)


def _finalize(est, data, best_count, best_mask, best_params, n):
    count = int(best_count)
    ok = count > 0
    if ok:
        params, valid = consensus_refit(est, data, best_mask)
    else:
        params = torch.zeros((est.nparams,), dtype=data.dtype, device=data.device)
        valid = torch.tensor(False, device=data.device)
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
    n = data.shape[0]
    if n < est.k:
        return _invalid_result(est, n, data.device)
    idx = _sample(generator, n, est.k, num_hypotheses, sampler, data.device)
    best_count, best_mask, best_params = hypothesize_and_vote(est, data, idx)
    return _finalize(est, data, best_count, best_mask, best_params, n)


def _invalid_result(est, n, device):
    return RansacResult(
        params=torch.zeros((est.nparams,), device=device),
        valid=torch.tensor(False, device=device),
        inlier_fraction=torch.tensor(0.0, dtype=torch.float64),
        consensus=torch.zeros((max(n, 1),), dtype=torch.bool, device=device),
        best_count=torch.tensor(-1),
        minimal_params=torch.zeros((est.nparams,), device=device),
    )
