"""``lm_step_launches``: device kernels launched per Levenberg-Marquardt
step, over the profiled fits: the kernels launched inside ``lm_core``'s
span over the steps the counter saw in those fits.  The loop launches a
fixed number of kernels a step (on the H100: 174 for the sphere, 503 for
the crosswire; PERF.md), so this reads the loop's own cost whatever mix of
step counts the data gives; ``refit_launches`` is about this times
``lm_steps`` plus the refit's work outside the loop."""

SPANS = {"lm": "lsqrrecipes_tpu_torch.linalg.lm.lm_core"}
COUNTERS = {"lm_step": "lsqrrecipes_tpu_torch.linalg.small.cholesky_solve_unrolled"}


def read(run):
    steps = run.traced_calls.get("lm_step", 0)
    if run.trace is None or not steps or not run.trace.spans.get("lm"):
        return None
    kernels = run.trace.ops_in("lm", kernels_only=True)
    return len(kernels) / steps if kernels else None
