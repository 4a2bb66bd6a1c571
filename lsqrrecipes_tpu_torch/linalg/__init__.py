"""Linear algebra (see :mod:`lsqrrecipes_tpu_torch.linalg.lstsq`)."""

from lsqrrecipes_tpu_torch.linalg.eig import eigvec_largest, eigvec_smallest
from lsqrrecipes_tpu_torch.linalg.lstsq import (
    masked_pinv_solve,
    nullvector,
    pinv_solve,
    svd_f64,
    svd_rank,
)
from lsqrrecipes_tpu_torch.linalg.small import solve2, solve3

__all__ = [
    "eigvec_largest",
    "eigvec_smallest",
    "masked_pinv_solve",
    "nullvector",
    "pinv_solve",
    "svd_f64",
    "svd_rank",
    "solve2",
    "solve3",
]
