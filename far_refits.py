"""Run ``chip_smoke.py`` phase 27's far refits on checkouts of the port, alternating.

    python3 far_refits.py DIR [DIR ...] [--rounds 2] [--seed 0] [--device cuda]

Each ``DIR`` is the root of a checkout (for example a parent commit and a
change, each unpacked with ``git archive``).  Each round runs one fresh
process per checkout, the order reversed every other round, and each process
imports ``lsqrrecipes_tpu_torch`` from its checkout only and the runs from
this script's ``chip_smoke.py`` (``far_refit_runs``), so every checkout sees
the same clouds: the data models and shapes of phases 5, 9 and 13,
``ransac_fused_sweep`` at the origin and ``FAR_OFFSET`` from it, the float64
refit of the far consensus, and the median wall of 10 ``consensus_refit``
calls at each offset (host clock, each call ending in a synchronize).

It prints, per case and checkout, the best counts at both offsets, the far
refit's truth errors with the offset taken back out and its distance from
the float64 refit (``far_refit_errors``), the refit walls by round and their
medians, and on the card the device busy time and kernel count of one
profiled refit at the origin per round (``chip_smoke.breakdown``, whose
lines the first two rounds print); then the card's name and power limit.  Nothing is checked here: a checkout from
before the float64 refits fails phase 27's limits, and this shows by how
much.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np


def load_chip_smoke():
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def worker(checkout, seed, device):
    here, root = os.path.dirname(os.path.abspath(__file__)), os.path.abspath(checkout)
    sys.path[:] = [root] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    chip_smoke = load_chip_smoke()
    import torch

    import lsqrrecipes_tpu_torch
    from lsqrrecipes_tpu_torch import kernels

    if not os.path.abspath(lsqrrecipes_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {lsqrrecipes_tpu_torch.__file__}, not {root}'s package")
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        kernels.build_all()
    else:
        torch.cuda.synchronize = lambda *args, **kwargs: None
    rows, _ = chip_smoke.far_refit_runs(torch, torch.device(device), seed,
                                        chip_smoke.Timer(torch))
    out = []
    for row in rows:
        d_count, errors, limits, dist = chip_smoke.far_refit_errors(row)
        case = {"label": row["label"], "counts": [row["origin"]["count"], row["far"]["count"]],
                "valid": [row["origin"]["valid"], row["far"]["valid"]],
                "errors": list(errors), "limits": list(limits), "from_f64": dist,
                "refit_ms": [row["origin"]["refit_ms"], row["far"]["refit_ms"]]}
        if device == "cuda":
            busy, kernels_run = chip_smoke.breakdown(torch, row["origin"]["refit"],
                                                     f"{row['label']} refit at the origin",
                                                     top=8)
            case["busy_ms"], case["kernels"] = busy, sum(k[1] for k in kernels_run)
        out.append(case)
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*", help="checkout roots")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.seed, args.device)
        return 0
    if not args.dirs:
        ap.error("give at least one checkout root")
    runs = {d: [] for d in args.dirs}
    for r in range(args.rounds):
        for d in (args.dirs if r % 2 == 0 else args.dirs[::-1]):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", d, "--seed",
                 str(args.seed), "--device", args.device],
                capture_output=True, text=True, check=True)
            lines = proc.stdout.strip().splitlines()
            runs[d].append(json.loads(lines[-1]))
            if r < 2:                       # each checkout's profiles, once
                print(f"{d}, round {r + 1}:", *lines[:-1], sep="\n")
    for i, case in enumerate(runs[args.dirs[0]][0]):
        print(f"{case['label']}:")
        for d in args.dirs:
            first = runs[d][0][i]
            walls = np.array([run[i]["refit_ms"] for run in runs[d]])
            errors = ", ".join(f"{e:.4g}" for e in first["errors"])
            busy = [f"{run[i]['busy_ms']:.3f} ms in {run[i]['kernels']} kernels"
                    for run in runs[d] if "busy_ms" in run[i]]
            print(f"  {d}: counts {first['counts']} valid {first['valid']}; truth errors "
                  f"[{errors}] (limits {first['limits']}); from the float64 refit "
                  f"{first['from_f64']:.4g}; refit ms at 0 "
                  f"{', '.join(f'{w:.3f}' for w in walls[:, 0])}, far "
                  f"{', '.join(f'{w:.3f}' for w in walls[:, 1])} (by round); medians "
                  f"{np.median(walls[:, 0]):.3f} / {np.median(walls[:, 1]):.3f}; device busy "
                  f"of one refit at 0: {', '.join(busy) or 'not measured'}")
    print(load_chip_smoke().nvidia_smi_line() if args.device == "cuda" else "no card: CPU run")
    return 0


if __name__ == "__main__":
    sys.exit(main())
