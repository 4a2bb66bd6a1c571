"""Timing and throughput harness (counterpart of
``lsqrrecipes_tpu/utils/profiling.py``).

The reference has no profiling at all (SURVEY.md section 5); this gives the
hypotheses/s and LM-iterations/s measurements and a ``torch.profiler``
window.  CUDA work is asynchronous, so every clock here stops only after
``torch.cuda.synchronize()`` when CUDA is in use.
"""

import contextlib
import os
import tempfile
import time

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Wall-clock timer that waits for the device's queued work on exit."""

    def __enter__(self):
        _sync()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.elapsed = time.perf_counter() - self.start
        return False


def throughput(fn, *args, steps: int = 10, warmup: int = 1, items_per_step: int = 1):
    """items/s of ``fn(*args)``: build and warm with ``warmup`` calls, then
    the steady-state rate over ``steps`` -> ``(items/s, seconds)``."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn(*args)
    _sync()
    elapsed = time.perf_counter() - t0
    return items_per_step * steps / elapsed, elapsed


@contextlib.contextmanager
def trace(log_dir=None):
    """A ``torch.profiler`` window (CPU activity, and CUDA's when it is
    available) whose Chrome trace is written to ``log_dir/trace.json`` on
    exit (default: ``torch-trace`` in the temporary directory); yields
    ``log_dir``.  View it in ``chrome://tracing`` or Perfetto."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "torch-trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
