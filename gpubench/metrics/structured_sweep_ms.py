"""``structured_sweep_ms``: host ms per fit in the program's ``sweep`` span
of the structured sweep (``ops.us_fast.structured_sweep``: the preparation,
then each chunk's fit and vote), over the window's fits.  A fit counts only
where its sweep recorded a ``sweep.fit`` leaf, which the fused sweep never
does; a program without those records leaves this metric nothing to read."""

from gpubench.lib import program


def read(run):
    recs = program.window_records(run)
    fits = {r.fit for r in recs if r.name == "sweep.fit"}
    sweep = program.durations_ns([r for r in recs if r.fit in fits], "sweep")
    return 1e-6 * sum(sweep) / run.spanned if sweep else None
