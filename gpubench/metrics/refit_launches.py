"""``refit_launches``: device kernels launched inside the consensus refit,
per fit, counted in the profiled fits (copies and sets left out)."""

SPANS = {"refit": "lsqrrecipes_tpu_torch.ransac.engine.consensus_refit"}


def read(run):
    if run.trace is None or not run.trace.dev or not run.trace.spans.get("refit"):
        return None
    return len(run.trace.ops_in("refit", kernels_only=True)) / len(run.trace.spans["refit"])
