"""Kernel wrappers and their plain PyTorch versions."""

import torch

from lsqrrecipes_tpu_torch.ops.vote import plane_vote_counts, sphere_vote_counts


def kernels_available() -> bool:
    """Whether the CUDA kernels can run here (the counterpart of the JAX
    package's ``pallas_available``).  It only informs callers: a wrapper
    launches its kernel on CUDA tensors and runs its plain version on CPU
    tensors whatever this says."""
    return torch.cuda.is_available()


__all__ = ["sphere_vote_counts", "plane_vote_counts", "kernels_available"]
