"""``sweep_ms``: host ms per fit in the fused sweep (slot planes, packing,
the launch and the post-processing), from its span, over the window's fits
(the profiled fits come after them)."""

SPANS = {"sweep": "lsqrrecipes_tpu_torch.ops.fused_sweep.fused_sweep"}


def read(run):
    return run.spans.mean_ms("sweep", run.spanned)
