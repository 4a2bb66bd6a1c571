"""Robust dense linear system solving on the recorded outlier matrix
(mirrors ``examples/linearEquationSystemSolver.cxx``, which runs RANSAC
twice with different probabilities)."""

import os

import torch

from lsqrrecipes_tpu_torch.estimators import DenseLinearSystemEstimator
from lsqrrecipes_tpu_torch.examples.common import banner, generator, parse_args, report
from lsqrrecipes_tpu_torch.io import load_augmented_matrix
from lsqrrecipes_tpu_torch.ransac import ransac, ransac_adaptive


def main(argv=None) -> int:
    args, dev = parse_args(__doc__, argv, reads_data=True)
    path = os.path.join(args.data_dir, "augmentedMatrixWithOutliers.txt")
    if not os.path.exists(path):
        print("example data not mounted; nothing to do")
        return 0
    data = torch.as_tensor(load_augmented_matrix(path, 7), device=dev)
    banner(f"Dense 6-unknown system, {data.shape[0]} equations (~30% outliers)")

    est = DenseLinearSystemEstimator(delta=1.0, n=6)
    ls_params, _ = est.lsq_fit(data)
    report("Least squares x", ls_params)

    result = ransac(est, data, generator(1, dev), num_hypotheses=8192)
    report("RANSAC (fixed budget) x", result.params)
    print(f"inlier fraction: {float(result.inlier_fraction):.3f}\n")

    result2 = ransac_adaptive(
        est, data, generator(2, dev), desired_probability=0.999
    )
    report("RANSAC (adaptive) x", result2.params)
    print(f"inlier fraction: {float(result2.inlier_fraction):.3f}")
    return 0 if bool(result.valid) and bool(result2.valid) else 1


if __name__ == "__main__":
    raise SystemExit(main())
