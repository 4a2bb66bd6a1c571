"""Seeds, the arithmetic of the measured window, and the fits to check."""

import statistics

import numpy as np

# Streams of the seed: the data pool, warm-up fits, the window's fits.
POOL, WARMUP, WINDOW = 0, 1, 2


def derive_seed(seed, stream, i):
    """A 63-bit generator seed for item ``i`` of ``stream`` under the run's
    ``seed`` (any whole number)."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), stream, i]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def fit_ms(window_s, fits):
    """Milliseconds per fit: the window's length over the fits completed in it."""
    return 1e3 * window_s / fits


def p95_ms(latencies_s):
    """95th percentile, in milliseconds, of every fit's latency (linear
    interpolation between order statistics)."""
    if len(latencies_s) == 1:
        return 1e3 * latencies_s[0]
    return 1e3 * statistics.quantiles(latencies_s, n=20, method="inclusive")[-1]


def fits_to_check(seed, latencies_s, count):
    """Indices of the fits the reference checks: the slowest, and the rest
    drawn from the seed without repeats."""
    slowest = int(np.argmax(latencies_s))
    rest = [i for i in range(len(latencies_s)) if i != slowest]
    rng = np.random.default_rng([int(seed) % (1 << 64), 7])
    picked = rng.choice(len(rest), size=min(count - 1, len(rest)), replace=False)
    return [slowest] + sorted(rest[i] for i in picked)
