"""``lm_steps``: Levenberg-Marquardt loop steps per fit, over the window's
fits (the profiled fits come after them).  Each step of ``lm_core`` solves
its damped system once, through ``linalg.small.cholesky_solve_unrolled``,
which the counter wraps; the steps include those the loop runs after the
problem has finished, up to its next completion check.  Beside
``refit_launches`` it splits a change in launches per fit into launches
per step and steps per fit."""

COUNTERS = {"lm_step": "lsqrrecipes_tpu_torch.linalg.small.cholesky_solve_unrolled"}


def read(run):
    steps = run.calls.get("lm_step", 0)
    return steps / run.spanned if steps and run.spanned else None
