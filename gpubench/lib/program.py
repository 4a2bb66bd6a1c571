"""The program's own tracing (``lsqrrecipes_tpu_torch.utils.profiling``),
read by the per-layer metrics that use it.

Importing this module turns the program's tracing on.  Only per-layer
metric modules import it, and the runner loads those only in a
``--trace 1`` run, so the untraced runs, which give the end-to-end metrics,
keep it off.  A program without that tracing leaves those metrics nothing
to read.

A fit of the program is an ``engine.fit`` span and every record that shares
its fit id.  The harness's ``fit`` spans, on the same clock
(``time.perf_counter``), say which fit is which: the first ``run.spanned``
are the window's, the rest the profiled fits.
"""

import bisect

from lsqrrecipes_tpu_torch.utils import profiling

if getattr(profiling, "set_tracing", None) is None:
    profiling = None
else:
    profiling.set_tracing(True)

_last = (None, ([], []))     # (readout, (window records, profiled records))


def _select(run):
    global _last
    if profiling is None or run.spans is None or not run.spanned:
        return [], []
    if _last[0] is not run:
        recs = profiling.records()
        fits = [r for r in recs if r.name == "engine.fit"]

        def records_of(harness_fits):
            starts = [round(t0 * 1e9) for t0, _ in harness_fits]
            ends = [round(t1 * 1e9) for _, t1 in harness_fits]
            ids = set()
            for r in fits:
                i = bisect.bisect_right(starts, r.start_ns) - 1
                if i >= 0 and r.start_ns <= ends[i]:
                    ids.add(r.fit)
            return [r for r in recs if r.fit in ids]

        log = run.spans.log["fit"]
        _last = (run, (records_of(log[:run.spanned]), records_of(log[run.spanned:])))
    return _last[1]


def window_records(run):
    """The program's records of the window's fits (warm-up and profiled
    fits left out).  Empty without program tracing."""
    return _select(run)[0]


def profiled_records(run):
    """The program's records of the profiled fits."""
    return _select(run)[1]


def durations_ns(recs, name=None, prefix=None):
    """Host nanoseconds of each record named ``name`` or starting ``prefix``."""
    return [r.end_ns - r.start_ns for r in recs
            if r.name == name or (prefix is not None and r.name.startswith(prefix))]
