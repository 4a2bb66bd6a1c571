"""Plane-phantom US calibration on simulated data
(mirrors ``examples/planeUSCalibration.cxx``)."""

import torch

from lsqrrecipes_tpu_torch.estimators.us_calibration import (
    ANALYTIC,
    ITERATIVE,
    PlanePhantomUSCalibrationEstimator,
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
    rng = RandomNumberGenerator(8, dev)
    like = {"dtype": torch.float64, "device": dev}
    m_x, m_y = 0.143, 0.139
    w3 = rng.uniform(0, 3.14159, (3,))
    r3 = _euler_zyx_matrix(w3[2], w3[1], w3[0])
    t3 = rng.uniform(-100, 100, (3,))
    w1 = rng.uniform(-1, 1, (2,))  # wy, wx of the plane orientation
    cy1, sy1 = torch.cos(w1[0]), torch.sin(w1[0])
    cx1, sx1 = torch.cos(w1[1]), torch.sin(w1[1])
    r1_row3 = torch.stack([-sy1, cy1 * sx1, cy1 * cx1])
    t1_z = rng.uniform(-100, 100)

    n = 80
    q = rng.uniform(0, 1, (n, 2)) * torch.tensor([640.0, 480.0], **like)
    w2 = rng.uniform(0, 3.14159, (n, 3))
    r2 = _euler_zyx_matrix(w2[:, 2], w2[:, 1], w2[:, 0])
    img = q[:, 0:1] * (m_x * r3[:, 0]) + q[:, 1:2] * (m_y * r3[:, 1]) + t3
    mapped = torch.einsum("nij,nj->ni", r2, img)
    a = rng.uniform(-100, 100, (n, 3))
    violation = (mapped + a) @ r1_row3 + t1_z
    t2 = a - violation[:, None] * r1_row3
    q_noisy = q + rng.normal(1.0, shape=q.shape)
    data = (Frame(r2, t2), q_noisy)

    banner("Plane-phantom US calibration (80 simulated images, sigma = 1 px)")
    report(
        "Known [w1_y, w1_x, t1_z, t3, w3_zyx, m]",
        torch.cat([w1, t1_z.reshape(1), t3, w3.flip(0), torch.tensor([m_x, m_y], **like)]),
    )

    for ls_type in (ANALYTIC, ITERATIVE):
        est = PlanePhantomUSCalibrationEstimator(delta=1.0, ls_type=ls_type)
        params, ok = est.lsq_fit(data)
        report(f"{ls_type} least squares (11 minimal params)", params[:11])
        _, dmin, dmax, dmean = est.distance_statistics(params, data)
        print(
            f"plane distance mm: min {float(dmin):.4f} max {float(dmax):.4f} "
            f"mean {float(dmean):.4f}\n"
        )

    # Robust estimate, as the reference example runs it
    # (``planeUSCalibration.cxx:68-84``, RANSAC over k = 31 minimal samples
    # at p = 0.999-equivalent budget), then persist the calibration the
    # reference way (``:193-219``).
    est = PlanePhantomUSCalibrationEstimator(delta=2.0, ls_type=ITERATIVE)
    result = ransac(est, data, generator(1, dev), num_hypotheses=2048)
    report("RANSAC (11 minimal params)", result.params[:11])
    print(f"inlier fraction: {float(result.inlier_fraction):.3f}")
    if not bool(result.valid):
        return 1
    p = result.params
    r3_est = _euler_zyx_matrix(p[6], p[7], p[8])
    transform = calibration_transform_from_params(
        p[3:6], p[9] * r3_est[:, 0], p[10] * r3_est[:, 1], r3_est[:, 2]
    )
    _, _, _, dmean = est.distance_statistics(p, data)
    write_precomputed_transform(
        "planeUSCalibration.xml",
        "US calibration - Plane Phantom",
        transform,
        dmean,
    )
    print("wrote planeUSCalibration.xml")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
