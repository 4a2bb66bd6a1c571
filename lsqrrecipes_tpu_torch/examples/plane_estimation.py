"""Robust 3D plane estimation (mirrors ``examples/planeEstimation.cxx``)."""

import torch

from lsqrrecipes_tpu_torch.estimators import PlaneEstimator
from lsqrrecipes_tpu_torch.examples.common import banner, generator, parse_args, report
from lsqrrecipes_tpu_torch.ransac import ransac
from lsqrrecipes_tpu_torch.utils import RandomNumberGenerator
from lsqrrecipes_tpu_torch.viz import InventorScene


def generate_data(rng, inliers=90, outliers=10):
    normal = rng.normal(shape=(3,))
    normal = normal / torch.linalg.norm(normal)
    anchor = rng.uniform(-100, 100, (3,))
    raw = rng.uniform(-100, 100, (inliers, 3))
    on_plane = raw - torch.sum((raw - anchor) * normal, dim=1, keepdim=True) * normal
    pts_in = on_plane + rng.normal(1.0, shape=(inliers, 3))
    pts_out = on_plane[:outliers] + (
        20.0 + rng.uniform(0, 50, (outliers,))
    )[:, None] * normal
    return torch.cat([pts_in, pts_out]), torch.cat([normal, anchor])


def main(argv=None) -> int:
    _, dev = parse_args(__doc__, argv)
    rng = RandomNumberGenerator(2, dev)
    data, true_params = generate_data(rng)
    est = PlaneEstimator(delta=1.0, dim=3)

    banner("3D plane estimation (90 inliers + 10 outliers)")
    report("Known plane parameters [n, a]", true_params)

    ls_params, _ = est.lsq_fit(data)
    report("Least squares estimate [n, a]", ls_params)

    result = ransac(est, data, generator(1, dev), num_hypotheses=2048)
    report("RANSAC estimate [n, a]", result.params)
    print(f"RANSAC inlier fraction: {float(result.inlier_fraction):.3f}")

    scene = InventorScene()
    scene.add_classified_points(data, est.agree(result.params, data))
    scene.write("RANSACPlaneEstimation.iv")
    print("wrote RANSACPlaneEstimation.iv")
    return 0 if bool(result.valid) else 1


if __name__ == "__main__":
    raise SystemExit(main())
