from lsqrrecipes_tpu_torch.utils import profiling
from lsqrrecipes_tpu_torch.utils.random import RandomNumberGenerator

__all__ = ["RandomNumberGenerator", "profiling"]
