"""Robust sphere estimation, algebraic + geometric LM
(mirrors ``examples/sphereEstimation.cxx``).

Beside the JAX example's report it counts the RANSAC estimate's inliers in
float32 with ``SphereEstimator.vote_counts``, the sphere vote kernel (B2)
on the card."""

import torch

from lsqrrecipes_tpu_torch.estimators import ALGEBRAIC, GEOMETRIC, SphereEstimator
from lsqrrecipes_tpu_torch.examples.common import banner, generator, parse_args, report
from lsqrrecipes_tpu_torch.ransac import ransac
from lsqrrecipes_tpu_torch.utils import RandomNumberGenerator
from lsqrrecipes_tpu_torch.viz import InventorScene


def main(argv=None) -> int:
    _, dev = parse_args(__doc__, argv)
    rng = RandomNumberGenerator(3, dev)
    center = rng.uniform(-100, 100, (3,))
    radius = float(rng.uniform(20, 60))
    d = rng.normal(shape=(90, 3))
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    inliers = center + radius * d + rng.normal(1.0, shape=(90, 3))
    outliers = center + rng.uniform(-2 * radius, 2 * radius, (10, 3))
    data = torch.cat([inliers, outliers])

    banner("Sphere estimation (90 inliers + 10 outliers)")
    report("Known sphere [c, r]",
           torch.cat([center, torch.tensor([radius], dtype=center.dtype, device=dev)]))

    for ls_type in (ALGEBRAIC, GEOMETRIC):
        est = SphereEstimator(delta=3.0, dim=3, ls_type=ls_type)
        params, _ = est.lsq_fit(data)
        report(f"Least squares ({ls_type}) [c, r]", params)

    est = SphereEstimator(delta=3.0, dim=3, ls_type=GEOMETRIC)
    result = ransac(est, data, generator(1, dev), num_hypotheses=4096)
    report("RANSAC estimate [c, r]", result.params)
    _, dmin, dmax, dmean = est.distance_statistics(result.params, data)
    print(
        f"distances to model: min {float(dmin):.3f} max {float(dmax):.3f} "
        f"mean {float(dmean):.3f}"
    )
    count32 = est.vote_counts(result.params[None].float(), data.float())
    print(f"float32 sphere vote of the estimate: {int(count32[0])} of {data.shape[0]} points")

    scene = InventorScene()
    scene.add_classified_points(data, est.agree(result.params, data))
    scene.add_sphere(result.params[:3], float(result.params[3]))
    scene.write("RANSACSphereEstimation.iv")
    print("wrote RANSACSphereEstimation.iv")
    return 0 if bool(result.valid) else 1


if __name__ == "__main__":
    raise SystemExit(main())
