"""Robust ray-intersection estimation
(mirrors ``examples/rayIntersectionEstimation.cxx``)."""

import math

import torch

from lsqrrecipes_tpu_torch.estimators import RayIntersectionEstimator
from lsqrrecipes_tpu_torch.examples.common import banner, generator, parse_args, report
from lsqrrecipes_tpu_torch.geometry import Ray3D
from lsqrrecipes_tpu_torch.ransac import ransac
from lsqrrecipes_tpu_torch.utils import RandomNumberGenerator
from lsqrrecipes_tpu_torch.viz import InventorScene


def main(argv=None) -> int:
    _, dev = parse_args(__doc__, argv)
    rng = RandomNumberGenerator(4, dev)
    target = rng.uniform(-500, 500, (3,))
    origins = rng.uniform(-1000, 1000, (40, 3)) + rng.normal(20.0, shape=(40, 3))
    directions = target - origins
    directions = directions / torch.linalg.norm(directions, dim=1, keepdim=True)
    # 8 outlier rays pointing somewhere else entirely.
    bad = rng.normal(shape=(8, 3))
    directions[:8] = bad / torch.linalg.norm(bad, dim=1, keepdim=True)
    rays = Ray3D(origins, directions)

    banner("Ray intersection (32 inlier rays + 8 outliers)")
    report("Known intersection", target)

    est = RayIntersectionEstimator(delta=60.0, min_angular_deviation=math.radians(1.0))
    ls_params, _ = est.lsq_fit(rays)
    report("Least squares estimate", ls_params)

    result = ransac(est, rays, generator(1, dev), num_hypotheses=2048)
    report("RANSAC estimate", result.params)
    print(f"RANSAC inlier fraction: {float(result.inlier_fraction):.3f}")

    scene = InventorScene()
    for i in range(origins.shape[0]):
        scene.add_polyline(
            [origins[i], origins[i] + 1500 * directions[i]],
            color=(0.0, 1.0, 0.0) if i >= 8 else (1.0, 0.0, 0.0),
        )
    scene.add_sphere(result.params, 15.0)
    scene.write("RANSACRayIntersection.iv")
    print("wrote RANSACRayIntersection.iv")
    return 0 if bool(result.valid) else 1


if __name__ == "__main__":
    raise SystemExit(main())
