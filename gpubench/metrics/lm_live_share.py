"""``lm_live_share``: of the Levenberg-Marquardt steps run in the window's
fits (the ``lm.steps`` counter), the share in % in which some problem was
still live (the largest element of the loop's final iteration tensor, read
after the window); the rest ran frozen, waiting for the next completion
check."""

from gpubench.lib import program


def read(run):
    counted = [r for r in program.window_records(run) if r.name == "lm.steps"]
    steps = sum(r.value for r in counted)
    return 100.0 * sum(r.reading for r in counted) / steps if steps else None
