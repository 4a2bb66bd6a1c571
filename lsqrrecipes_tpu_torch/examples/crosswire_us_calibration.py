"""Crosswire-phantom US calibration on the experimental data
(mirrors ``examples/crosswireUSCalibration.cxx``)."""

import os

import torch

from lsqrrecipes_tpu_torch.estimators.us_calibration import (
    ANALYTIC,
    ITERATIVE,
    CrosswireUSCalibrationEstimator,
)
from lsqrrecipes_tpu_torch.examples.common import banner, generator, parse_args, report
from lsqrrecipes_tpu_torch.io import load_crosswire_phantom
from lsqrrecipes_tpu_torch.io.xml_out import (
    calibration_transform_from_params,
    write_precomputed_transform,
)
from lsqrrecipes_tpu_torch.ransac import ransac


def main(argv=None) -> int:
    args, dev = parse_args(__doc__, argv, reads_data=True)
    t_path = os.path.join(args.data_dir, "crossWirePhantomTransformations.txt")
    p_path = os.path.join(args.data_dir, "crossWirePhantom2DPoints.txt")
    if not os.path.exists(t_path):
        print("experimental data not mounted; nothing to do")
        return 0
    frames, pts = load_crosswire_phantom(t_path, p_path, device=dev)
    data = (frames, torch.as_tensor(pts, device=dev))
    banner(f"Crosswire US calibration on {pts.shape[0]} tracked images")

    for ls_type in (ANALYTIC, ITERATIVE):
        est = CrosswireUSCalibrationEstimator(delta=5.0, ls_type=ls_type)
        params, ok = est.lsq_fit(data)
        report(f"{ls_type} least squares [t1, t3, w, m]", params[:11])
        _, dmin, dmax, dmean = est.distance_statistics(params, data)
        print(
            f"reprojection distance mm: min {float(dmin):.3f} "
            f"max {float(dmax):.3f} mean {float(dmean):.3f}\n"
        )

    est = CrosswireUSCalibrationEstimator(delta=5.0, ls_type=ITERATIVE)
    result = ransac(est, data, generator(1, dev), num_hypotheses=512)
    report("RANSAC [t1, t3, w, m]", result.params[:11])
    print(f"inlier fraction: {float(result.inlier_fraction):.3f}")
    if not bool(result.valid):
        return 1
    # Persist the calibration the reference way
    # (``crosswireUSCalibration.cxx:185-211``).
    p = result.params
    _, _, _, dmean = est.distance_statistics(p, data)
    write_precomputed_transform(
        "crosswireUSCalibration.xml",
        "US calibration - cross wire phantom",
        calibration_transform_from_params(p[3:6], p[11:14], p[14:17], p[17:20]),
        dmean,
    )
    print("wrote crosswireUSCalibration.xml")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
