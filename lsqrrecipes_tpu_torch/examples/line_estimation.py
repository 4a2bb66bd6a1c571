"""Robust 3D line estimation: least squares vs batched RANSAC.

Mirrors ``examples/lineEstimation.cxx``: 90 inliers along a random line
(sigma=1) + 10 far outliers; plain least squares is corrupted, RANSAC
recovers the line; writes OpenInventor scenes of both fits.
"""

import torch

from lsqrrecipes_tpu_torch.estimators import LineEstimator
from lsqrrecipes_tpu_torch.examples.common import banner, generator, parse_args, report
from lsqrrecipes_tpu_torch.ransac import ransac
from lsqrrecipes_tpu_torch.utils import RandomNumberGenerator
from lsqrrecipes_tpu_torch.viz import InventorScene


def generate_data(rng, inliers=90, outliers=10, outlier_distance=20.0):
    direction = rng.normal(shape=(3,))
    direction = direction / torch.linalg.norm(direction)
    anchor = rng.uniform(-100, 100, (3,))
    t = rng.uniform(-100, 100, (inliers,))
    pts_in = anchor + t[:, None] * direction + rng.normal(1.0, shape=(inliers, 3))
    # Outliers pushed off the line.
    perp = torch.linalg.cross(direction, torch.tensor([1.0, 0.0, 0.0], dtype=direction.dtype,
                                                      device=direction.device))
    perp = perp / torch.linalg.norm(perp)
    t_out = rng.uniform(-100, 100, (outliers,))
    pts_out = (
        anchor
        + t_out[:, None] * direction
        + (outlier_distance + rng.uniform(0, 50, (outliers,)))[:, None] * perp
    )
    return torch.cat([pts_in, pts_out]), torch.cat([direction, anchor])


def main(argv=None) -> int:
    _, dev = parse_args(__doc__, argv)
    rng = RandomNumberGenerator(0, dev)
    data, true_params = generate_data(rng)
    est = LineEstimator(delta=1.0, dim=3)

    banner("3D line estimation (90 inliers + 10 outliers)")
    report("Known line parameters [n, a]", true_params)

    ls_params, ok = est.lsq_fit(data)
    report("Least squares estimate [n, a]", ls_params)

    result = ransac(est, data, generator(1, dev), num_hypotheses=2048)
    report("RANSAC estimate [n, a]", result.params)
    print(f"RANSAC inlier fraction: {float(result.inlier_fraction):.3f}\n")

    dot = abs(float(torch.dot(ls_params[:3], true_params[:3])))
    dot_r = abs(float(torch.dot(result.params[:3], true_params[:3])))
    print(f"|direction dot| least squares: {dot:.6f}, RANSAC: {dot_r:.6f}")

    for name, params in [
        ("leastSquaresLineEstimation.iv", ls_params),
        ("RANSACLineEstimation.iv", result.params),
    ]:
        scene = InventorScene()
        scene.add_classified_points(data, est.agree(params, data))
        scene.add_line_segment(params[3:], params[:3], 150.0)
        scene.write(name)
        print(f"wrote {name}")
    return 0 if bool(result.valid) else 1


if __name__ == "__main__":
    raise SystemExit(main())
