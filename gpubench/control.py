"""The upper readings of a cell's check, at the cell's own size: the
control, and the faults.  The benchmark's own runs never run it.

    python3 gpubench/control.py --workload <cell> --seeds <n> [<n> ...]
        [--fits 8] [--dtype DTYPE | --lm-start | --fault NAME [--seconds S]]

Prints one JSON line per seed: the readings, each beside its limit, and
whether the run came out correct (it must not).

* By default, the control: the plain reference computed in the precision
  below the configuration's (``control_dtype``) and put in the program's
  place, judged by the same comparison.
* ``--dtype DTYPE``: the reference in ``DTYPE`` in the program's place (a
  fault where ``DTYPE`` is the configuration's own: a float32 refit).
* ``--lm-start``: the reference in the configuration's own precision with
  the iterative refit left at its start (the algebraic or analytic fit).
* ``--fault NAME``: the program itself with a fault of
  :mod:`gpubench.lib.faults` planted, run as the benchmark runs it (set-up,
  a window of ``--seconds``, the check of ``--fits`` fits).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LM_START = {"geometric": "algebraic", "iterative": "analytic"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fits", type=int, default=8)
    ap.add_argument("--device", default="cuda:0")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--dtype")
    mode.add_argument("--lm-start", action="store_true")
    mode.add_argument("--fault")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from gpubench.lib import faults, runner

    cell = runner.Cell(runner.load_benchmark(ROOT), args.workload)
    ls_type = cell.traffic["ls_type"]
    if args.lm_start and ls_type not in LM_START:
        ap.error(f"{args.workload} runs no LM")
    if args.fault:
        plant, cells = faults.FAULTS[args.fault]
        if args.workload not in cells:
            ap.error(f"{args.workload} cannot have the fault {args.fault}")
        cell.traffic["check_fits"] = args.fits
        for seed in args.seeds:
            patch = faults.Patch()
            plant(patch)
            try:
                got = runner.run(cell, seed, args.seconds, False, args.device, time.perf_counter())
            finally:
                patch.undo()
            checks = got["checks"]
            print(json.dumps({
                "workload": args.workload, "seed": seed, "fault": args.fault,
                "readings": {k: c["value"] for k, c in checks.items()},
                "limits": {k: c["limit"] for k, c in checks.items()},
                "correct": got["correct"],
            }), flush=True)
        return
    dtype = args.dtype or cell.cfg["dtype" if args.lm_start else "control_dtype"]
    refit_type = LM_START[ls_type] if args.lm_start else None
    for seed in args.seeds:
        got = runner.control_readings(cell, seed, args.fits, dtype, args.device, refit_type)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "dtype": dtype,
            "refit": refit_type or ls_type,
            "readings": got, "limits": cell.limits,
            "correct": all(got[k] <= cell.limits[k] for k in got),
        }), flush=True)


if __name__ == "__main__":
    main()
