"""SVD pseudo-inverse solves with absolute singular-value thresholding
(counterpart of ``lsqrrecipes_tpu/linalg/lstsq.py``).

Matches ``vnl_matrix_inverse`` + ``zero_out_absolute(EPS)``: singular values
``<= eps`` are zeroed, the reported rank counts the survivors (strict
``s > eps``), and callers treat ``rank < expected`` as degenerate.  The SVD
is a plain float64 ``torch.linalg.svd`` outside any kernel; functions
broadcast over leading batch axes.
"""

import torch

from lsqrrecipes_tpu_torch.config import EPS
from lsqrrecipes_tpu_torch.utils import profiling


def svd_f64(a, full_matrices=False):
    """``torch.linalg.svd`` computed in float64 regardless of input dtype
    (the reference's DBL_EPSILON rank thresholds only make sense there).
    On CUDA the call waits for the device, several times: the solver's own
    synchronisations, a copy to the host and the check of its status."""
    a64 = a.to(torch.float64)
    with profiling.wait("svd"):
        return torch.linalg.svd(a64, full_matrices=full_matrices)


def svd_rank(s, eps=EPS):
    """Rank after ``zero_out_absolute(eps)``: #{sigma_i > eps}."""
    return torch.sum(s > eps, dim=-1)


def pinv_solve(a, b, eps=EPS):
    """Least-squares solve ``x = pinv(a) @ b`` with absolute thresholding.

    a: ``[..., m, n]``, b: ``[..., m]`` -> ``(x[..., n], rank[...])`` with
    ``x`` in ``a``'s dtype.
    """
    u, s, vt = svd_f64(a, full_matrices=False)
    keep = s > eps
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    utb = torch.einsum("...ij,...i->...j", u, b.to(u.dtype))
    x = torch.einsum("...ji,...j->...i", vt, s_inv * utb)
    return x.to(a.dtype), torch.sum(keep, dim=-1)


def masked_pinv_solve(a, b, row_mask, eps=EPS):
    """``pinv_solve`` over the rows selected by ``row_mask`` (``[..., m]``
    bool): excluded rows of ``a`` and ``b`` are zeroed, which leaves
    ``A^T A``, ``A^T b`` and the rank decision of the subset unchanged."""
    m = row_mask[..., None].to(a.dtype)
    return pinv_solve(a * m, b * m.squeeze(-1), eps)


def nullvector(a, eps=EPS):
    """Unit null vector of ``a[..., m, n]`` (the last right-singular vector
    of the full float64 SVD) -> ``(x[..., n], rank[...])`` with ``x`` in
    ``a``'s dtype; callers needing a one-dimensional null space check the
    rank (``vnl_svd::nullvector``, ``PlaneParametersEstimator.hxx:81-91``)."""
    _, s, vt = svd_f64(a, full_matrices=True)
    return vt[..., -1, :].to(a.dtype), svd_rank(s, eps)
