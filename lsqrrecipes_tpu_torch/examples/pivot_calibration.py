"""Pivot calibration on the recorded outlier data set
(mirrors ``examples/pivotCalibration.cxx``)."""

import os

from lsqrrecipes_tpu_torch.estimators import PivotCalibrationEstimator
from lsqrrecipes_tpu_torch.examples.common import banner, generator, parse_args, report
from lsqrrecipes_tpu_torch.io import load_tracked_frames
from lsqrrecipes_tpu_torch.ransac import ransac


def main(argv=None) -> int:
    args, dev = parse_args(__doc__, argv, reads_data=True)
    path = os.path.join(args.data_dir, "pivotCalibrationDataWithOutliers.txt")
    if not os.path.exists(path):
        print("example data not mounted; nothing to do")
        return 0
    frames = load_tracked_frames(path, device=dev)
    banner(f"Pivot calibration on {frames.t.shape[0]} tracked poses (~30% outliers)")

    est = PivotCalibrationEstimator(delta=1.0)
    ls_params, _ = est.lsq_fit(frames)
    report("Least squares [t_DRF, t_W]", ls_params)

    result = ransac(est, frames, generator(1, dev), num_hypotheses=4096)
    report("RANSAC [t_DRF, t_W]", result.params)
    print(f"RANSAC inlier fraction: {float(result.inlier_fraction):.3f}")
    return 0 if bool(result.valid) else 1


if __name__ == "__main__":
    raise SystemExit(main())
