"""Linear algebra: SVD solves (:mod:`~lsqrrecipes_tpu_torch.linalg.lstsq`), tiny
closed-form, Cholesky and QR solves (:mod:`~lsqrrecipes_tpu_torch.linalg.small`)
and Levenberg-Marquardt (:mod:`~lsqrrecipes_tpu_torch.linalg.lm`)."""

from lsqrrecipes_tpu_torch.linalg.eig import eigvec_largest, eigvec_smallest
from lsqrrecipes_tpu_torch.linalg.lm import LMConfig, LMResult, levenberg_marquardt, lm_core
from lsqrrecipes_tpu_torch.linalg.lstsq import (
    masked_pinv_solve,
    nullvector,
    pinv_solve,
    svd_f64,
    svd_rank,
)
from lsqrrecipes_tpu_torch.linalg.small import (
    cholesky_solve_lanes,
    cholesky_solve_unrolled,
    qr_solve_lanes,
    solve2,
    solve3,
    solve_spd,
)

__all__ = [
    "LMConfig",
    "LMResult",
    "levenberg_marquardt",
    "lm_core",
    "cholesky_solve_lanes",
    "cholesky_solve_unrolled",
    "qr_solve_lanes",
    "solve_spd",
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
