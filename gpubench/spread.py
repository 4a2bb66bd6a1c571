"""Run one cell several times, each in a fresh process, and report the
spread of each metric: the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median.

    python3 gpubench/spread.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]
        [--trace 0|1] [--out FILE]

Runs go one after another (one process on the card at a time), with the
seeds in the order given.  Each run's result line goes to ``--out`` (JSON
lines, with the seed, exit code and wall seconds added); the summary is
printed as one JSON line per metric.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rows = []
    for seed in args.seeds:
        cmd = [sys.executable, str(ROOT / "gpubench" / "run.py"), "--workload", args.workload,
               "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        row = json.loads(lines[-1]) if proc.returncode == 0 and lines else {}
        row.update(seed=seed, rc=proc.returncode, wall_s=wall,
                   notes=[ln for ln in proc.stderr.splitlines()
                          if ln.startswith(("gpubench:", "sweep_roofline:"))])
        if proc.returncode != 0 or not row.get("correct"):
            row["stderr_tail"] = proc.stderr[-2000:]
        rows.append(row)
        print(json.dumps({"seed": seed, "rc": proc.returncode, "wall_s": round(wall, 3),
                          "correct": row.get("correct"),
                          "metrics": {k: v["value"] for k, v in row.get("metrics", {}).items()},
                          "checks": {k: v["value"] for k, v in row.get("checks", {}).items()}}),
              flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(row) + "\n")
    names = sorted({k for r in rows for k in r.get("metrics", {})})
    for name in names:
        values = [r["metrics"][name]["value"] for r in rows if name in r.get("metrics", {})]
        summary = {"metric": name, "runs": len(values), "median": statistics.median(values)}
        if len(values) >= 2:
            summary["spread"] = spread(values)
        print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
