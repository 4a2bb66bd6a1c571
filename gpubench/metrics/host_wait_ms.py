"""``host_wait_ms``: host ms per fit inside the program's ``wait.*``
leaves, over the window's fits: the host blocked on the card.  The
harness's own spans synchronise at the sweep's and the refit's ends in a
traced run, so a wait that follows one reads shorter than untraced."""

from gpubench.lib import program


def read(run):
    recs = program.window_records(run)
    if not recs:
        return None
    return 1e-6 * sum(program.durations_ns(recs, prefix="wait.")) / run.spanned
