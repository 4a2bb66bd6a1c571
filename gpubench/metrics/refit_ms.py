"""``refit_ms``: host ms per fit in the consensus refit (the estimator's
least squares: the float64 solves and, for the iterative types, the LM),
from its span, over the window's fits (the profiled fits come after them)."""

SPANS = {"refit": "lsqrrecipes_tpu_torch.ransac.engine.consensus_refit"}


def read(run):
    return run.spans.mean_ms("refit", run.spanned)
