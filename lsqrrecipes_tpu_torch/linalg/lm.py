"""Levenberg-Marquardt with analytic Jacobians (counterpart of
``lsqrrecipes_tpu/linalg/lm.py``).

The replacement for ``vnl_levenberg_marquardt`` (MINPACK ``lmder``) used by
the ultrasound-calibration estimators
(``SinglePointTargetUSCalibrationParametersEstimator.cxx:272-297``):

  * the damped normal-equation step ``(J^T J + lam diag(J^T J)) d = -J^T r``
    with the Marquardt diagonal floored at the dtype's ``tiny``, solved by
    :func:`~lsqrrecipes_tpu_torch.linalg.small.cholesky_solve_unrolled`;
  * Nielsen's damping schedule (accept: ``lam *= max(1/3, 1 - (2 rho - 1)^3)``,
    reject: ``lam *= nu`` with ``nu`` doubling);
  * four convergence tests (gradient, step, relative decrease, damping blown
    past ``max_lambda``) and the ``max_iters`` cap;
  * per-residual masks: masked rows add nothing to the cost, the gradient or
    ``J^T J``, which is the same as deleting them;
  * a lane freeze: the state of a finished problem stops changing, so
    problems batched over leading axes of ``x0`` give what each gives alone.

The JAX package's ``lax.while_loop`` becomes a Python loop that asks the
device whether every problem is done only every ``_CHECK_EVERY`` steps (one
device sync per check); a finished problem's state is frozen, so the extra
steps change nothing and the result is the one a per-step check gives.
"""

from typing import Callable, NamedTuple, Optional

import torch

from lsqrrecipes_tpu_torch.linalg import small
from lsqrrecipes_tpu_torch.utils import profiling

# Steps between two completion checks: each check waits for the device, and
# up to _CHECK_EVERY - 1 frozen steps run after the last problem finishes.
_CHECK_EVERY = 4


class LMConfig(NamedTuple):
    ftol: float = 1e-15
    xtol: float = 1e-15
    gtol: float = 1e-15
    max_iters: int = 200
    init_lambda: float = 1e-3
    max_lambda: float = 1e12


class LMResult(NamedTuple):
    x: torch.Tensor           # [..., p] final parameters
    cost: torch.Tensor        # [...] final 0.5*||r||^2
    iterations: torch.Tensor  # [...] accepted + rejected steps taken
    converged: torch.Tensor   # [...] bool: a tolerance met before max_iters


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def lm_core(
    normal_system: Callable,
    cost_of: Callable,
    x0: torch.Tensor,
    config: LMConfig = LMConfig(),
) -> LMResult:
    """The damped LM loop over ``x0[..., p]`` (problems batched over the
    leading axes).

    ``normal_system(x) -> (jtj [..., p, p], g [..., p])`` with ``g = J^T r``
    and ``cost_of(x) -> 0.5 ||r||^2 [...]``.
    """
    dtype, dev = x0.dtype, x0.device
    batch = x0.shape[:-1]
    eps_tiny = torch.finfo(dtype).tiny
    n = x0.shape[-1]

    with profiling.span("lm"):
        x = x0
        cost = cost_of(x0)
        lam = torch.full(batch, config.init_lambda, dtype=dtype, device=dev)
        nu = torch.full(batch, 2.0, dtype=dtype, device=dev)
        it = torch.zeros(batch, dtype=torch.int32, device=dev)
        done = torch.zeros(batch, dtype=torch.bool, device=dev)
        converged = torch.zeros(batch, dtype=torch.bool, device=dev)
        eye = torch.eye(n, dtype=dtype, device=dev)

        step_no = -1
        for step_no in range(config.max_iters):
            with profiling.span("lm.step"):
                with profiling.leaf("lm.normal"):
                    jtj, g = normal_system(x)
                with profiling.leaf("lm.solve"):
                    diag = torch.clamp_min(torch.diagonal(jtj, dim1=-2, dim2=-1), eps_tiny)
                    a = jtj + lam[..., None, None] * (diag[..., None, :] * eye)
                    step, _ = small.cholesky_solve_unrolled(a, -g, n)
                with profiling.leaf("lm.trial"):
                    x_new = x + step
                    cost_new = cost_of(x_new)
                with profiling.leaf("lm.update"):
                    # Gain ratio: actual reduction over the local quadratic model's.
                    jtj_step = torch.einsum("...ij,...j->...i", jtj, step)
                    predicted = (-torch.sum(step * g, dim=-1)
                                 - 0.5 * torch.sum(step * jtj_step, dim=-1))
                    predicted = torch.clamp_min(predicted, eps_tiny)
                    rho = (cost - cost_new) / predicted
                    accept = torch.isfinite(cost_new) & (cost_new < cost)

                    shrink = torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
                    lam_accept = torch.clamp_min(lam * shrink, 1e-18)
                    lam_reject = torch.clamp_max(lam * nu, config.max_lambda)
                    lam_next = torch.where(accept, lam_accept, lam_reject)
                    nu_next = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
                    x_next = torch.where(accept[..., None], x_new, x)
                    cost_next = torch.where(accept, cost_new, cost)

                    small_grad = torch.amax(g.abs(), dim=-1) < config.gtol
                    small_step = _norm(step) < config.xtol * (_norm(x) + config.xtol)
                    small_decrease = accept & (
                        (cost - cost_new) <= config.ftol * torch.clamp_min(cost, eps_tiny)
                    )
                    lam_blown = lam_next >= config.max_lambda
                    conv = small_grad | small_step | small_decrease | lam_blown
                    now_done = conv | (it + 1 >= config.max_iters)

                    frz = done
                    x = torch.where(frz[..., None], x, x_next)
                    cost = torch.where(frz, cost, cost_next)
                    lam = torch.where(frz, lam, lam_next)
                    nu = torch.where(frz, nu, nu_next)
                    it = it + (~frz).to(it.dtype)
                    converged = converged | (conv & ~frz)
                    done = done | now_done
            if (step_no + 1) % _CHECK_EVERY == 0:
                with profiling.wait("lm_done"):
                    finished = bool(done.all())
                if finished:
                    break
        # Steps run, and (the largest of it) the steps in which a problem was live.
        profiling.count("lm.steps", step_no + 1, keep=it)
    return LMResult(x, cost, it, converged)


def levenberg_marquardt(
    residual_fn: Callable,
    jac_fn: Callable,
    x0: torch.Tensor,
    data,
    mask: Optional[torch.Tensor] = None,
    config: LMConfig = LMConfig(),
) -> LMResult:
    """Minimize ``0.5 * || mask * residual_fn(x, data) ||^2`` from ``x0[..., p]``;
    ``residual_fn(x, data) -> r[..., m]`` and ``jac_fn(x, data) -> J[..., m,
    p]`` (problems batched over the leading axes of ``x0``, ``mask`` and what
    the two functions return)."""

    def masked_residual(x):
        r = residual_fn(x, data)
        return r if mask is None else r * mask.to(r.dtype)

    def cost_of(x):
        r = masked_residual(x)
        return 0.5 * torch.sum(r * r, dim=-1)

    def normal_system(x):
        r = masked_residual(x)
        j = jac_fn(x, data)
        if mask is not None:
            j = j * mask.to(j.dtype)[..., None]
        if j.dim() == 2:        # one problem: the matrix-vector product
            return j.T @ j, j.T @ r
        return j.mT @ j, (j.mT @ r[..., None])[..., 0]

    return lm_core(normal_system, cost_of, x0, config)
