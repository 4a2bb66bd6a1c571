"""Batched RANSAC engine (see :mod:`lsqrrecipes_tpu_torch.ransac.engine`)."""

from lsqrrecipes_tpu_torch.ransac.engine import (
    RansacResult,
    consensus_refit,
    hypothesize_and_vote,
    hypothesize_and_vote_structured,
    ransac,
    ransac_adaptive,
    ransac_batched,
    ransac_exhaustive,
    ransac_fused_sweep,
    ransac_structured,
)
from lsqrrecipes_tpu_torch.ransac.sampling import (
    choose,
    num_tries,
    sample_k_subsets,
    sample_k_subsets_chunked,
    sample_k_with_replacement,
    structured_samples,
    structured_shift_table,
)

__all__ = [
    "RansacResult",
    "ransac",
    "ransac_adaptive",
    "ransac_batched",
    "ransac_exhaustive",
    "ransac_fused_sweep",
    "ransac_structured",
    "hypothesize_and_vote",
    "hypothesize_and_vote_structured",
    "consensus_refit",
    "sample_k_subsets",
    "sample_k_subsets_chunked",
    "sample_k_with_replacement",
    "structured_samples",
    "structured_shift_table",
    "num_tries",
    "choose",
]
