"""Geometric primitives: rotations, rigid transforms (frames), rays
(counterpart of ``lsqrrecipes_tpu/geometry``).

Points and vectors are plain tensors with the coordinate axis last; every
function is batched over leading axes.
"""

from lsqrrecipes_tpu_torch.geometry import rotations
from lsqrrecipes_tpu_torch.geometry.frame import Frame
from lsqrrecipes_tpu_torch.geometry.ray import Ray3D, intersect_rays

__all__ = ["rotations", "Frame", "Ray3D", "intersect_rays"]
