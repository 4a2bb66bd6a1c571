"""Calibrated-pointer US calibration on simulated data
(mirrors ``examples/pointerUSCalibration.cxx``)."""

import torch

from lsqrrecipes_tpu_torch.estimators.us_calibration import (
    ANALYTIC,
    ITERATIVE,
    PointerUSCalibrationEstimator,
    _euler_zyx_matrix,
)
from lsqrrecipes_tpu_torch.examples.common import banner, generator, parse_args, report
from lsqrrecipes_tpu_torch.geometry import Frame
from lsqrrecipes_tpu_torch.io.xml_out import (
    calibration_transform_from_params,
    write_precomputed_transform,
)
from lsqrrecipes_tpu_torch.ransac import ransac
from lsqrrecipes_tpu_torch.utils import RandomNumberGenerator


def main(argv=None) -> int:
    _, dev = parse_args(__doc__, argv)
    rng = RandomNumberGenerator(7, dev)
    like = {"dtype": torch.float64, "device": dev}
    m_x, m_y = 0.143, 0.139
    w3 = rng.uniform(0, 3.14159, (3,))
    r3 = _euler_zyx_matrix(w3[2], w3[1], w3[0])
    t3 = rng.uniform(-100, 100, (3,))

    n = 60
    q = rng.uniform(0, 1, (n, 2)) * torch.tensor([640.0, 480.0], **like)
    w2 = rng.uniform(0, 3.14159, (n, 3))
    r2 = _euler_zyx_matrix(w2[:, 2], w2[:, 1], w2[:, 0])
    t2 = rng.uniform(-100, 100, (n, 3))
    img = q[:, 0:1] * (m_x * r3[:, 0]) + q[:, 1:2] * (m_y * r3[:, 1]) + t3
    p = torch.einsum("nij,nj->ni", r2, img) + t2
    q_noisy = q + rng.normal(1.0, shape=q.shape)
    # 10 outlier correspondences (bad pointer readings).
    p[:10] += rng.uniform(30, 60, (10, 3))
    data = (Frame(r2, t2), q_noisy, p)

    banner("Pointer US calibration (50 good + 10 outlier correspondences)")
    report("Known [t3, w_zyx, m]",
           torch.cat([t3, w3.flip(0), torch.tensor([m_x, m_y], **like)]))

    for ls_type in (ANALYTIC, ITERATIVE):
        est = PointerUSCalibrationEstimator(delta=3.0, ls_type=ls_type)
        params, _ = est.lsq_fit(data)
        report(f"{ls_type} least squares [t3, w, m]", params[:8])

    est = PointerUSCalibrationEstimator(delta=3.0, ls_type=ITERATIVE)
    result = ransac(est, data, generator(1, dev), num_hypotheses=1024)
    report("RANSAC [t3, w, m]", result.params[:8])
    print(f"inlier fraction: {float(result.inlier_fraction):.3f}")
    if not bool(result.valid):
        return 1
    # Persist the calibration the reference way
    # (``pointerUSCalibration.cxx:218-244``).
    pr = result.params
    _, _, _, dmean = est.distance_statistics(pr, data)
    write_precomputed_transform(
        "pointerUSCalibration.xml",
        "US calibration - calibrated pointer",
        calibration_transform_from_params(pr[0:3], pr[8:11], pr[11:14], pr[14:17]),
        dmean,
    )
    print("wrote pointerUSCalibration.xml")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
