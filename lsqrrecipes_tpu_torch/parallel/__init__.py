"""Multi-process scaling on ``torch.distributed`` (counterpart of
``lsqrrecipes_tpu/parallel``): a device mesh with named ``hypotheses`` and
``data`` axes (:mod:`.mesh`), RANSAC steps whose hypothesis blocks and
observation blocks are split over them with Sum-reduced vote counts and
sufficient statistics (:mod:`.sharded`), and the fused and ultrasound sweeps
split over ``hypotheses`` (:mod:`.fused`).  Only Sum all-reduces and
all-gathers cross processes."""

from lsqrrecipes_tpu_torch.parallel.fused import sharded_fused_sweep, sharded_us_sweep
from lsqrrecipes_tpu_torch.parallel.mesh import default_mesh, initialize_distributed
from lsqrrecipes_tpu_torch.parallel.sharded import (
    ShardedRansacResult,
    sharded_lsq_fit,
    sharded_ransac,
)

__all__ = [
    "default_mesh",
    "initialize_distributed",
    "sharded_ransac",
    "sharded_fused_sweep",
    "sharded_us_sweep",
    "sharded_lsq_fit",
    "ShardedRansacResult",
]
