"""``sweep_prep_ms``: host ms per fit in the program's ``sweep.prep``
leaf, over the window's fits: the sweep's host preparation before the
launch (the slot permutations, the slot planes and the packed vote rows)."""

from gpubench.lib import program


def read(run):
    prep = program.durations_ns(program.window_records(run), "sweep.prep")
    return 1e-6 * sum(prep) / run.spanned if prep else None
