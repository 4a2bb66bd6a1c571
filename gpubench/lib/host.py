"""How fast the host ran around the measured window.

A fit is a loop of small kernels that the host launches one by one, so the
host's own speed sets ``fit_ms``.  On the card's machine ``/proc`` reads
nothing of it (load 0, one fixed clock on every CPU), so two fixed probes
read it instead, once before the window and once after: the time of a
pure-Python loop (``probe_ms``) and the host time per launch of a tiny
kernel (``launch_us``).  The result line carries them under ``host``;
nothing is judged by them.
"""

import time

import torch

PROBE_ITERATIONS = 200_000
PROBE_LAUNCHES = 2_000


def probe_ms():
    """Milliseconds for a fixed pure-Python loop."""
    t0 = time.perf_counter()
    s = 0
    for i in range(PROBE_ITERATIONS):
        s += i * i
    return 1e3 * (time.perf_counter() - t0)


def launch_us(device):
    """Microseconds per launch of a one-element add on ``device``, over a
    fixed run of launches that ends in a sync; None off the card."""
    if device.type != "cuda":
        return None
    x = torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(PROBE_LAUNCHES):
        x.add_(1.0)
    torch.cuda.synchronize(device)
    return 1e6 * (time.perf_counter() - t0) / PROBE_LAUNCHES


class Reading:
    """Both probes at one moment."""

    def __init__(self, device):
        self.probe_ms = probe_ms()
        self.launch_us = launch_us(device)

    def since(self, before):
        """The record of a window between ``before`` and this reading."""
        return {"probe_ms": [before.probe_ms, self.probe_ms],
                "launch_us": [before.launch_us, self.launch_us]}
