"""Benchmark of the PyTorch and CUDA port, lsqrrecipes_tpu_torch (see README.md)."""
