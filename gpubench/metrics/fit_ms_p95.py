"""``fit_ms_p95``: the 95th percentile of every fit's latency in the window,
in ms; a fit runs from the call into the entry until its params, validity
and count are on the host."""

from gpubench.lib.window import p95_ms


def read(run):
    return p95_ms(run.latencies)
