"""``idle_share``: the share of the profiled fits' window in which no
operation ran on the device, in %.  An upper bound: the profiler's own
work on the host lengthens the window."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
