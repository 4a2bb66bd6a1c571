"""``host_syncs``: the CUDA runtime's ``cudaStreamSynchronize`` calls
inside the program's ``engine.fit`` span, per fit, over the profiled fits:
each blocks the host until the card has run its queue out.  The program's
``wait.*`` leaves hold them all, and one leaf may hold several (a
``wait.svd`` holds the solver's own, a copy to the host and the check of
its status); the harness's own ``cudaDeviceSynchronize`` calls are not
counted.  The program's records are put on the profile's clock fit by fit
through its leaves, each both a record and an ``lsqr.<leaf>`` range: a
record's start follows its range's, so the largest offset is the nearest."""

import bisect

from gpubench.lib import program

SYNC = "cudaStreamSynchronize"


def read(run):
    if run.trace is None or not run.trace.dev:
        return None
    recs = program.profiled_records(run)
    leaves = [r for r in recs if r.kind == "leaf"]
    ranges = [(a, n) for a, _, n in run.trace.host if n.startswith("lsqr.")]
    if not leaves or [n for _, n in ranges] != ["lsqr." + r.name for r in leaves]:
        return None
    offset = {}          # fit id -> profile clock (us) less the program's
    for r, (a, _) in zip(leaves, ranges):
        d = a - 1e-3 * r.start_ns
        offset[r.fit] = max(d, offset.get(r.fit, d))
    syncs = sorted(a for a, _, n in run.trace.host if n == SYNC)
    fits = [r for r in recs if r.name == "engine.fit"]
    total = 0
    for f in fits:
        t0, t1 = (1e-3 * t + offset[f.fit] for t in (f.start_ns, f.end_ns))
        total += bisect.bisect_right(syncs, t1) - bisect.bisect_left(syncs, t0)
    return total / len(fits)
