"""Flagship showcase: whole-sweep fused RANSAC across estimator families.

Unlike the other examples (which mirror the reference's small-n example
programs, ``examples/readme.txt``), this one shows the fast path: millions
of hypotheses per family through ONE hand-written CUDA kernel per sweep
(``ransac_fused_sweep``; B1 sphere3d, B3 pivot and B3
absolute_orientation).  With ``--device cpu`` the kernels' plain PyTorch
versions run the same sweeps at a small budget.
"""

import time

import torch

from lsqrrecipes_tpu_torch.estimators import (
    ALGEBRAIC,
    AbsoluteOrientationEstimator,
    PivotCalibrationEstimator,
    SphereEstimator,
)
from lsqrrecipes_tpu_torch.examples.common import banner, generator, parse_args, report
from lsqrrecipes_tpu_torch.geometry import Frame, rotations
from lsqrrecipes_tpu_torch.ransac import ransac_fused_sweep

N = 1024  # any n works (sampling planes replicate up to 128 * 2^k); a
          # power-of-two width avoids the replication sampling bias entirely
F64 = torch.float64


def sphere_cloud(gen):
    dev = gen.device
    n_in = N * 4 // 5
    d = torch.randn((n_in, 3), generator=gen, device=dev, dtype=F64)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    inl = torch.tensor([5.0, -2.0, 11.0], dtype=F64, device=dev) + 25.0 * d
    inl = inl + 0.3 * torch.randn((n_in, 3), generator=gen, device=dev, dtype=F64)
    out = -40.0 + 80.0 * torch.rand((N - n_in, 3), generator=gen, device=dev, dtype=F64)
    return torch.cat([inl, out])


def pivot_frames(gen):
    dev = gen.device
    n_in = N * 4 // 5
    t_d = torch.tensor([10.0, -5.0, 2.0], dtype=F64, device=dev)
    t_w = torch.tensor([100.0, 50.0, -30.0], dtype=F64, device=dev)

    def rot(m):
        q = torch.randn((m, 4), generator=gen, device=dev, dtype=F64)
        return rotations.matrix_from_quaternion(q / torch.linalg.norm(q, dim=1, keepdim=True))

    r_in = rot(n_in)
    t_in = t_w - torch.einsum("nij,j->ni", r_in, t_d)
    t_in = t_in + 0.05 * torch.randn((n_in, 3), generator=gen, device=dev, dtype=F64)
    r_out = rot(N - n_in)
    t_out = -200.0 + 400.0 * torch.rand((N - n_in, 3), generator=gen, device=dev, dtype=F64)
    return Frame(torch.cat([r_in, r_out]), torch.cat([t_in, t_out]))


def registration_pairs(gen):
    dev = gen.device
    q = torch.tensor([0.9, 0.2, -0.3, 0.1], dtype=F64, device=dev)
    r = rotations.matrix_from_quaternion(q / torch.linalg.norm(q))
    t = torch.tensor([12.0, -7.0, 30.0], dtype=F64, device=dev)
    first = -100.0 + 200.0 * torch.rand((N, 3), generator=gen, device=dev, dtype=F64)
    second = first @ r.T + t + 0.1 * torch.randn((N, 3), generator=gen, device=dev, dtype=F64)
    bad = -100.0 + 200.0 * torch.rand((N // 5, 3), generator=gen, device=dev, dtype=F64)
    second[-(N // 5):] = bad
    return (first, second)


def main(argv=None) -> int:
    _, dev = parse_args(__doc__, argv)
    if dev.type == "cuda":
        budget = 4 << 20
    else:
        budget = 4 * N
        print("(CPU - the kernels' plain PyTorch versions, small budget)")

    cases = [
        (
            "3D sphere [c, r]",
            SphereEstimator(delta=1.0, dim=3, ls_type=ALGEBRAIC),
            sphere_cloud(generator(0, dev)),
        ),
        (
            "Pivot calibration [t_DRF, t_W]",
            PivotCalibrationEstimator(delta=1.0),
            pivot_frames(generator(0, dev)),
        ),
        (
            "Absolute orientation [q, t]",
            AbsoluteOrientationEstimator(delta=1.0),
            registration_pairs(generator(0, dev)),
        ),
    ]
    ok = True
    for name, est, data in cases:
        banner(name)
        result = ransac_fused_sweep(est, data, generator(1, dev), budget)  # build + first sweep
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        result = ransac_fused_sweep(est, data, generator(2, dev), budget)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
        report("RANSAC estimate", result.params)
        print(
            f"inlier fraction {float(result.inlier_fraction):.3f}; "
            f"{budget / elapsed / 1e6:.1f}M hypotheses/s "
            "(single sweep incl. host dispatch)"
        )
        ok = ok and bool(result.valid)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
