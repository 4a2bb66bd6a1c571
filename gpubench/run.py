"""Run one cell of the benchmark once, on the card this process finds.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
traced, ``breakdown``, and ``host``, the host's speed before and after the
window (:mod:`gpubench.lib.host`); its last key, ``checks``, holds each
number the check compared with its limit, and the same lines end standard
error.
Exits non-zero with no result when there is no CUDA card (or fewer than the
cell asks for), when the program cannot be imported from this checkout, or
when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = "lsqrrecipes_tpu_torch"


def fail(code, message):
    print(f"gpubench: {message}", file=sys.stderr)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from gpubench.lib import guard, runner

    torch.set_num_threads(1)        # one process, one host thread of work: steadier timings

    try:
        import lsqrrecipes_tpu_torch
    except ImportError as exc:
        fail(2, f"the program {PROGRAM} cannot be imported: {exc}")
    if ROOT not in Path(lsqrrecipes_tpu_torch.__file__).resolve().parents:
        fail(2, f"{PROGRAM} was imported from outside this checkout")
    cell = runner.Cell(runner.load_benchmark(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        fail(3, f"{args.workload} needs {cell.chips} CUDA device(s); "
                f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")

    result = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    loaded = guard.forbidden_loaded()
    if loaded:
        fail(4, f"the run loaded {', '.join(loaded)}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
