"""``phantom_qr_roofline``: the least time for the plane phantom's subspace
kernel (B6, ``csrc/phantom_qr.cu``) over its device time per structured
sweep, in %.  The launches are the device operations inside the harness's
``structured_sweep`` span named by the kernel's symbol; the work is frozen
in ``gpubench/roofline/plane_phantom.py`` for the sweep's hypotheses
(``ceil(hypotheses / n) n``), and the least time is the larger of
operations over the card's peak rate and bytes over its bandwidth
(``gpubench/roofline/peaks.py``).  Which of the two set it is printed."""

import sys

from gpubench.lib.runner import BENCH_DIR, load_file
from gpubench.roofline.peaks import PEAKS

SPANS = {"structured_sweep": "lsqrrecipes_tpu_torch.ops.us_fast.structured_sweep"}
KERNEL = "phantom_qr_kernel"


def read(run):
    if run.trace is None or run.device_kind not in PEAKS \
            or not run.trace.spans.get("structured_sweep"):
        return None
    launches = [op for op in run.trace.ops_in("structured_sweep", kernels_only=True)
                if KERNEL in op[2]]
    if not launches:
        return None
    sweeps = len(run.trace.spans["structured_sweep"])
    device_s = sum(op[1] - op[0] for op in launches) * 1e-6 / sweeps
    if device_s <= 0:
        return None
    n = run.cfg["data"]["n"]
    ops, nbytes = load_file(BENCH_DIR / "roofline" / "plane_phantom.py").work(
        -(-run.cfg["hypotheses"] // n) * n, n)
    rate, bandwidth = PEAKS[run.device_kind]
    t_ops, t_bytes = ops / rate, nbytes / bandwidth
    bound_s = max(t_ops, t_bytes)
    print(f"phantom_qr_roofline: bound {bound_s * 1e3:.6f} ms set by "
          f"{'operations' if t_ops >= t_bytes else 'bytes'} ({ops:.6e} ops, {nbytes} bytes), "
          f"device {device_s * 1e3:.6f} ms in {len(launches) / sweeps:g} launches per sweep",
          file=sys.stderr)
    return 100.0 * bound_s / device_s
