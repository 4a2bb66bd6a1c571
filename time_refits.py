"""Time the iterative consensus refits of two checkouts of the port, alternating.

    python3 time_refits.py DIR_A DIR_B [--rounds 3] [--reps 20] [--device cuda]

``DIR_A`` and ``DIR_B`` are roots of two checkouts (for example a parent
commit and a change, each unpacked with ``git archive``).  Each round runs
one fresh process per checkout, the order alternating between rounds (A, B
then B, A), and each process imports ``lsqrrecipes_tpu_torch`` from its
checkout only.  The inputs are ``chip_smoke.py``'s data models from fixed
seeds, so both checkouts refit the same data:

  * crosswire and pointer, n = 1,024, ITERATIVE, on the 820 planted inliers
    (``chip_smoke.py`` phase 16's consensus size);
  * the sphere, n = 1,024, GEOMETRIC, float32, on the 819 planted inliers
    (phase 21);
  * the plane phantom, n = 64, ITERATIVE, on the 58 unshoved poses
    (phase 22).

Each process prints, per refit, the median wall ms of ``--reps`` calls of
``est.lsq_fit(data, mask)`` (host clock, each call ending in
``torch.cuda.synchronize()``, after two warm-up calls) and a SHA-256 of the
returned parameters' bytes.  The summary lists each checkout's medians by
round and whether every process returned the same bits.  The card's name
and power limit are printed beside it.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 2024
N_US, N_SPHERE, N_PHANTOM = 1024, 1024, 64


def worker(checkout, reps, device):
    # The package from the checkout alone; the data models from this script's
    # own chip_smoke.py, so both checkouts see the same inputs.
    here, root = os.path.dirname(os.path.abspath(__file__)), os.path.abspath(checkout)
    sys.path[:] = [root] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    import torch

    import lsqrrecipes_tpu_torch
    from lsqrrecipes_tpu_torch import geometry, interop
    from lsqrrecipes_tpu_torch.estimators import SphereEstimator, get

    if not os.path.abspath(lsqrrecipes_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {lsqrrecipes_tpu_torch.__file__}, not {root}'s package")

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(SEED)
    cases = {}
    for family, reg in (("crosswire", "us_crosswire"), ("pointer", "us_pointer")):
        data = interop.data_to_torch(chip_smoke.us_data(rng, family, N_US, geometry), device=device)
        mask = torch.arange(N_US, device=device) < N_US - N_US // 5
        cases[family] = (get(reg)(chip_smoke.US_DELTA), data, mask)
    pts = torch.as_tensor(chip_smoke.bench_cloud(rng, N_SPHERE), device=device)
    cases["sphere GEOMETRIC"] = (SphereEstimator(chip_smoke.DELTA), pts,
                                 torch.arange(N_SPHERE, device=device) < N_SPHERE * 4 // 5)
    (frames, q), _, n_out = chip_smoke.phantom_data(rng, N_PHANTOM, geometry)
    data = interop.data_to_torch((frames, q), device=device)
    cases["plane phantom"] = (get("us_plane_phantom")(chip_smoke.PHANTOM_DELTA), data,
                              torch.arange(N_PHANTOM, device=device) < N_PHANTOM - n_out)

    out = {}
    for name, (est, data, mask) in cases.items():
        for _ in range(2):
            params, valid = est.lsq_fit(data, mask)
        sync()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            params, valid = est.lsq_fit(data, mask)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        digest = hashlib.sha256(params.detach().cpu().numpy().tobytes()).hexdigest()[:16]
        out[name] = {"ms": statistics.median(times), "sha": digest, "valid": bool(valid)}
    print(json.dumps(out))


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*", help="two checkout roots, A then B")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.reps, args.device)
        return 0
    if len(args.dirs) != 2:
        ap.error("give two checkout roots")
    runs = {d: [] for d in args.dirs}
    for r in range(args.rounds):
        for d in (args.dirs if r % 2 == 0 else args.dirs[::-1]):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", d, "--reps",
                 str(args.reps), "--device", args.device],
                capture_output=True, text=True, check=True)
            runs[d].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    names = list(runs[args.dirs[0]][0])
    shas = {(n, run[n]["sha"]) for d in args.dirs for run in runs[d] for n in names}
    for name in names:
        cells = [", ".join(f"{run[name]['ms']:.3f}" for run in runs[d]) for d in args.dirs]
        same = len({sha for n, sha in shas if n == name}) == 1
        valid = all(run[name]["valid"] for d in args.dirs for run in runs[d])
        print(f"{name}: A {cells[0]} | B {cells[1]} ms (medians of {args.reps} by round); "
              f"same bits {same}, valid {valid}")
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
