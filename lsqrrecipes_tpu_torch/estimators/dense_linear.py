"""Dense linear equation system estimator on augmented rows ``[a_0..a_{n-1} | b]``
(counterpart of ``lsqrrecipes_tpu/estimators/dense_linear.py``).

Parity target:
``DenseLinearEquationSystemParametersEstimator.{h,hxx}``, whose data items
are augmented rows (``AugmentedRow``, ``...h:20-135``): here a ``[rows, n+1]``
tensor.
"""

import torch

from lsqrrecipes_tpu_torch.device import as_tensor
from lsqrrecipes_tpu_torch.estimators.base import Estimator, register
from lsqrrecipes_tpu_torch.linalg import masked_pinv_solve, pinv_solve


@register("dense_linear")
class DenseLinearSystemEstimator(Estimator):
    def __init__(self, delta: float, n: int):
        self.delta = float(delta)
        self.n = int(n)
        self.k = self.n
        self.nparams = self.n
        # The 6-unknown system (the reference's example workload) has a fused
        # sweep kernel; other sizes run on the generic engine.
        self.fused_family = "dense_linear6" if self.n == 6 else None

    def minimal_fit(self, samples):
        """n rows -> exact solve by float64 SVD pseudo-inverse with a rank
        check (``DenseLinearEquationSystemParametersEstimator.hxx:16-49``)."""
        x, rank = pinv_solve(samples[..., : self.n], samples[..., self.n])
        return x, rank >= self.n

    def lsq_fit(self, data, mask=None):
        """Overdetermined solve on the same SVD path (``...hxx:64-96``)."""
        a, b = data[..., : self.n], data[..., self.n]
        if mask is None:
            x, rank = pinv_solve(a, b)
            enough = torch.tensor(data.shape[-2] >= self.k, device=data.device)
        else:
            x, rank = masked_pinv_solve(a, b, mask)
            enough = torch.sum(mask) >= self.k
        return x, (rank >= self.n) & enough

    def lsq_stats(self, data, mask=None):
        w = self._mask_or_ones(mask, data.shape[0], data.dtype, data.device)
        a = data[..., : self.n] * w[:, None]
        b = data[..., self.n] * w
        return (a.T @ data[..., : self.n], a.T @ data[..., self.n], torch.sum(w))

    def lsq_solve_stats(self, stats):
        """Solve of the summed normal equations ``(A^T A, A^T b)``; the rank
        is that of ``A^T A`` (the JAX package's distributed-refit deviation
        from the reference's test on the singular values of ``A``)."""
        ata, atb, n = stats
        x, rank = pinv_solve(ata, atb)
        return x, (rank >= self.n) & (n >= self.k)

    def agree(self, params, data):
        """``|a . x - b| < delta`` (``...hxx:111-119``)."""
        residual = torch.sum(params[..., None, :] * data[..., : self.n], dim=-1) - data[..., self.n]
        return torch.abs(residual) < self.delta


def augmented_rows(a, b, *, device=None):
    """``(A[m, n], b[m]) -> rows[m, n+1]`` (``getAugmentedRows``,
    ``DenseLinearEquationSystemParametersEstimator.hxx:122-136``); numpy
    input goes to ``device`` (default CUDA)."""
    a = as_tensor(a, device)
    b = as_tensor(b, a.device, a.dtype)
    if b.shape[0] != a.shape[0]:
        raise ValueError("A and b row counts differ")
    return torch.cat([a, b[:, None]], dim=1)
