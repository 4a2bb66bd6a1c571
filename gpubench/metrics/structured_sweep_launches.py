"""``structured_sweep_launches``: device kernels launched inside the
structured sweep (``ops.us_fast.structured_sweep``, which the harness's
span wraps) per profiled fit, copies and sets left out: the preparation's,
then each chunk's packing, subspace kernel, Rayleigh-Ritz, reconstruction
and vote."""

SPANS = {"structured_sweep": "lsqrrecipes_tpu_torch.ops.us_fast.structured_sweep"}


def read(run):
    if run.trace is None or not run.trace.dev or not run.trace.spans.get("structured_sweep"):
        return None
    kernels = run.trace.ops_in("structured_sweep", kernels_only=True)
    return len(kernels) / len(run.trace.spans["structured_sweep"]) if kernels else None
