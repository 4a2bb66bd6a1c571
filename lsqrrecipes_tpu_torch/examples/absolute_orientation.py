"""Absolute orientation with exhaustive RANSAC
(mirrors ``examples/AbsoluteOrientation.cxx``, which uses the
all-subsets variant for its small data set)."""

import torch

from lsqrrecipes_tpu_torch.estimators import AbsoluteOrientationEstimator
from lsqrrecipes_tpu_torch.examples.common import banner, parse_args, report
from lsqrrecipes_tpu_torch.geometry import Frame
from lsqrrecipes_tpu_torch.ransac import ransac_exhaustive
from lsqrrecipes_tpu_torch.utils import RandomNumberGenerator


def main(argv=None) -> int:
    _, dev = parse_args(__doc__, argv)
    rng = RandomNumberGenerator(5, dev)
    q = rng.normal(shape=(4,))
    q = q / torch.linalg.norm(q)
    frame = Frame.from_quaternion(q, rng.uniform(-100, 100, (3,)))

    first = rng.uniform(-100, 100, (12, 3))
    second = frame.apply(first) + rng.normal(0.5, shape=(12, 3))
    # Two gross outlier correspondences.
    second[:2] += 100.0

    banner("Absolute orientation (10 good pairs + 2 outliers, exhaustive RANSAC)")
    report("Known quaternion [s, x, y, z]", frame.quaternion())
    report("Known translation", frame.t)

    est = AbsoluteOrientationEstimator(delta=3.0)
    ls_params, _ = est.lsq_fit((first, second))
    report("Least squares [q, t]", ls_params)

    result = ransac_exhaustive(est, (first, second))
    report("Exhaustive RANSAC [q, t]", result.params)
    print(f"inlier fraction: {float(result.inlier_fraction):.3f}")
    return 0 if bool(result.valid) else 1


if __name__ == "__main__":
    raise SystemExit(main())
