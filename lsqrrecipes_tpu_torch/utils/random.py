"""Data-synthesis random number generator (counterpart of
``lsqrrecipes_tpu/utils/random.py``).

Replaces ``common/RandomNumberGenerator.h`` (a ``vnl_random`` wrapper used
only by tests and examples) with a seeded ``torch.Generator`` on the
resolved device, so every synthetic data set is reproducible per seed and
per device.  The draws are not the JAX package's threefry draws.
"""

import torch

from lsqrrecipes_tpu_torch.device import resolve_device


class RandomNumberGenerator:
    """``uniform``/``normal`` draws as float64 tensors (the JAX package's
    dtype under x64) on ``device`` (default CUDA; raises without it)."""

    def __init__(self, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _shape(self, shape):
        return (shape,) if isinstance(shape, int) else tuple(shape)

    def uniform(self, low=0.0, high=1.0, shape=()):
        """Uniform in [low, high) (``RandomNumberGenerator.h:31-36``)."""
        u = torch.rand(self._shape(shape), generator=self._gen, device=self.device,
                       dtype=torch.float64)
        return low + (high - low) * u

    def normal(self, sigma=1.0, mu=0.0, shape=()):
        """Gaussian N(mu, sigma^2) (``RandomNumberGenerator.h:38-44``)."""
        z = torch.randn(self._shape(shape), generator=self._gen, device=self.device,
                        dtype=torch.float64)
        return mu + sigma * z

    def key(self):
        """A fresh ``torch.Generator`` on the same device, seeded by one draw
        (the counterpart of a raw PRNG key)."""
        seed = int(torch.randint(0, 2**62, (), generator=self._gen, device=self.device))
        return torch.Generator(device=self.device).manual_seed(seed)
