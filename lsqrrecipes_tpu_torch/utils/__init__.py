from lsqrrecipes_tpu_torch.utils.profiling import Timer, throughput
from lsqrrecipes_tpu_torch.utils.random import RandomNumberGenerator

__all__ = ["RandomNumberGenerator", "Timer", "throughput"]
