"""``fit_ms``: the window's seconds over the fits completed in it, in ms."""

from gpubench.lib.window import fit_ms


def read(run):
    return fit_ms(run.window_s, len(run.latencies))
