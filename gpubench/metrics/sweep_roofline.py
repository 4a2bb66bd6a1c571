"""``sweep_roofline``: the least time for the problem's work in the fused
sweep over the device time of every operation the sweep span launched, in
%.  The work is frozen per family in ``gpubench/roofline/<family>.py``
(operations per hypothesis-point cell and per hypothesis; bytes of the
observations read once); the least time is the larger of operations over
the card's peak rate and bytes over its bandwidth
(``gpubench/roofline/peaks.py``).  Which of the two set it is printed."""

import sys

from gpubench.lib.runner import BENCH_DIR, load_file
from gpubench.roofline.peaks import PEAKS

SPANS = {"sweep": "lsqrrecipes_tpu_torch.ops.fused_sweep.fused_sweep"}


def read(run):
    if run.trace is None or run.device_kind not in PEAKS or not run.trace.spans.get("sweep"):
        return None
    family = load_file(BENCH_DIR / "roofline" / f"{run.cfg['family']}.py")
    n = run.cfg["data"]["n"]
    hypotheses = -(-run.cfg["hypotheses"] // n) * n
    ops, nbytes = family.work(hypotheses, n)
    rate, bandwidth = PEAKS[run.device_kind]
    t_ops, t_bytes = ops / rate, nbytes / bandwidth
    sweeps = len(run.trace.spans["sweep"])
    device_s = sum(op[1] - op[0] for op in run.trace.ops_in("sweep")) * 1e-6 / sweeps
    if device_s <= 0:
        return None
    bound_s = max(t_ops, t_bytes)
    print(f"sweep_roofline: bound {bound_s * 1e3:.6f} ms set by "
          f"{'operations' if t_ops >= t_bytes else 'bytes'} ({ops:.6e} ops, {nbytes} bytes), "
          f"device {device_s * 1e3:.6f} ms per sweep", file=sys.stderr)
    return 100.0 * bound_s / device_s
