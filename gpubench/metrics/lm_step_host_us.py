"""``lm_step_host_us``: mean host microseconds of the program's
``lm.step`` span over the window's fits: one Levenberg-Marquardt step's
normal system, damped solve, trial cost and update, as the host launches
them (the completion checks lie outside it, in ``wait.lm_done``)."""

from gpubench.lib import program


def read(run):
    steps = program.durations_ns(program.window_records(run), "lm.step")
    return 1e-3 * sum(steps) / len(steps) if steps else None
