"""``engine_self_ms``: host ms per fit in the entry outside the sweep and the
refit (``ransac_fused_sweep``'s own work, the winner's ``agree`` and
``_finalize``): the fit span less its two child spans, over the window's
fits (the profiled fits come after them)."""

SPANS = {"sweep": "lsqrrecipes_tpu_torch.ops.fused_sweep.fused_sweep",
         "refit": "lsqrrecipes_tpu_torch.ransac.engine.consensus_refit"}


def read(run):
    log = run.spans.log
    if not (len(log["fit"]) == len(log["sweep"]) == len(log["refit"]) > 0):
        return None
    return (run.spans.mean_ms("fit", run.spanned) - run.spans.mean_ms("sweep", run.spanned)
            - run.spans.mean_ms("refit", run.spanned))
