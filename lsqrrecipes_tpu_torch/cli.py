"""Console entry point (``lsqrrecipes-torch-bench``; counterpart of
``lsqrrecipes_tpu/cli.py``).

``info`` lists the port's version, PyTorch's and CUDA's, the visible CUDA
devices and the registered estimator suite; ``bench`` runs a self-contained
RANSAC throughput measurement, ``ransac_fused_sweep`` on a sphere cloud
(the fused sweep kernel on the card), and prints one JSON line.  The device
defaults to CUDA; without it ``bench`` exits non-zero instead of running on
the host.

    python -m lsqrrecipes_tpu_torch.cli info
    python -m lsqrrecipes_tpu_torch.cli bench --hypotheses 4194304 --n 1024
"""

import argparse
import json
import sys
import time


def _info() -> int:
    import torch

    import lsqrrecipes_tpu_torch
    from lsqrrecipes_tpu_torch.estimators import base

    print(f"lsqrrecipes_tpu_torch {lsqrrecipes_tpu_torch.__version__}")
    names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, devices: {names}")
    print("registered estimators:")
    for name in base.names():
        cls = base.get(name)
        k = getattr(cls, "k", "-")        # instance-dependent for some
        npar = getattr(cls, "nparams", "-")
        print(f"  {name:24s} k={k!s:<4s} nparams={npar}")
    return 0


def bench_cloud(generator, n, device):
    """The bench's sphere: centre (10, -4, 2.5), radius 25, N(0, 0.05)
    noise, the last ``n // 5`` points shifted by U(15, 40) per axis; float32
    ``[n, 3]`` on ``device``."""
    import torch

    f64 = {"dtype": torch.float64, "device": generator.device}
    center = torch.tensor([10.0, -4.0, 2.5], **f64)
    d = torch.randn((n, 3), generator=generator, **f64)
    pts = center + 25.0 * d / torch.linalg.norm(d, dim=-1, keepdim=True)
    pts = pts + 0.05 * torch.randn((n, 3), generator=generator, **f64)
    n_out = n // 5
    shift = 15.0 + 25.0 * torch.rand((n_out, 3), generator=generator, **f64)
    pts[n - n_out:] += shift
    return pts.to(device=device, dtype=torch.float32), center.to(device)


def _bench(hypotheses: int, n: int, device) -> int:
    import torch

    from lsqrrecipes_tpu_torch.device import resolve_device
    from lsqrrecipes_tpu_torch.estimators.sphere import SphereEstimator
    from lsqrrecipes_tpu_torch.ransac import ransac_fused_sweep

    try:
        dev = resolve_device(device)
    except RuntimeError as exc:
        print(f"lsqrrecipes-torch-bench: {exc}", file=sys.stderr)
        return 2
    gen = torch.Generator(device=dev).manual_seed(0)
    pts, center = bench_cloud(gen, n, dev)
    est = SphereEstimator(delta=0.5, dim=3)

    def run():
        return ransac_fused_sweep(
            est, pts, torch.Generator(device=dev).manual_seed(7), num_hypotheses=hypotheses,
        )

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    res = run()  # kernel build + warm
    sync()
    if not bool(res.valid):
        print("bench run produced no valid consensus", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    res = run()
    sync()
    dt = time.perf_counter() - t0
    err = float(torch.linalg.norm(res.params[:3].double() - center))
    print(
        json.dumps(
            {
                "metric": "cli_ransac_hypotheses_per_s",
                "value": round(hypotheses / dt, 1),
                "unit": "hyp/s",
                "center_error": round(err, 4),
                "inlier_fraction": round(float(res.inlier_fraction), 4),
            }
        )
    )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lsqrrecipes-torch-bench", description=__doc__)
    sub = p.add_subparsers(dest="cmd")
    sub.add_parser("info", help="versions, devices, estimator registry")
    b = sub.add_parser("bench", help="small RANSAC throughput measurement")
    b.add_argument("--hypotheses", type=int, default=16384)
    b.add_argument("--n", type=int, default=512)
    b.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.cmd == "bench":
        return _bench(args.hypotheses, args.n, args.device)
    return _info()


if __name__ == "__main__":
    raise SystemExit(main())
