"""Reading one ``torch.profiler`` window.

The window runs from the first ``gpubench.fit`` span's start to the last
one's end, on the profiler's host clock (microseconds).  Device operations
are the events the profiler puts on the card (kernels, copies and sets; the
device-side images of the harness's own spans are left out), moved onto the
host's clock by the least gap between an operation's start and its launch
(the profiler's two timelines were seen a fraction of a second apart).  An
operation belongs to the span whose host interval holds its launch: the CUDA
runtime or driver call that shares its correlation id, or, where the
profiler recorded none, its start.  Every harness span synchronises the card
at its start and its end, so no operation launched in one span runs in
another.
"""

import bisect
from collections import defaultdict

import torch

SPAN_PREFIX = "gpubench."
COPY_PREFIXES = ("Memcpy", "Memset")
TOP = 10


def _merge(intervals):
    out = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


class Trace:
    """Spans, device operations and host operations of one window."""

    def __init__(self, events):
        cuda = torch.autograd.DeviceType.CUDA
        spans, host, dev, launch = defaultdict(list), [], [], {}
        for e in events:
            t0, t1, name = e.time_range.start, e.time_range.end, e.name
            if e.device_type == cuda:
                if not name.startswith(SPAN_PREFIX):
                    dev.append((t0, t1, name, e.id))
            elif name.startswith(SPAN_PREFIX):
                spans[name[len(SPAN_PREFIX):]].append((t0, t1, e.thread))
            else:
                host.append((t0, t1, name, e.thread))
                if name.startswith("cu"):        # a runtime or driver call: its correlation id
                    launch.setdefault(e.id, t0)
        fits = spans.get("fit", [])
        if not fits:
            raise RuntimeError("the profiled window holds no fit span")
        self.fits = len(fits)
        self.t0 = min(s[0] for s in fits)
        self.t1 = max(s[1] for s in fits)
        main = fits[0][2]
        self.spans = {k: sorted((a, b) for a, b, _ in v) for k, v in spans.items()}
        self._starts = {k: [a for a, _ in v] for k, v in self.spans.items()}
        # The card's clock can sit off the host's: no operation starts before
        # its launch call, so the least start-minus-launch is the offset.
        lags = [a - launch[i] for a, _, _, i in dev if i in launch]
        off = min(lags) if lags else 0.0
        # (device start, end, name, host launch time), on the host's clock
        self.dev = sorted((a - off, b - off, n, launch.get(i, a - off)) for a, b, n, i in dev
                          if self.t0 <= launch.get(i, a - off) < self.t1)
        self.busy = _merge([(max(a, self.t0), min(b, self.t1)) for a, b, _, _ in self.dev
                            if min(b, self.t1) > max(a, self.t0)])
        # Outer operations before the ones they contain.
        self.host = sorted(((a, b, n) for a, b, n, th in host if th == main),
                           key=lambda h: (h[0], -h[1]))

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy) * 1e-6

    def ops_in(self, span, kernels_only=False):
        """Device operations launched inside any ``span`` interval."""
        ivals, starts = self.spans.get(span, []), self._starts.get(span, [])
        out = []
        for op in self.dev:
            i = bisect.bisect_right(starts, op[3]) - 1
            if i >= 0 and op[3] <= ivals[i][1]:
                if not (kernels_only and op[2].startswith(COPY_PREFIXES)):
                    out.append(op)
        return out

    def _top_level_host(self):
        top = []
        for a, b, name in self.host:
            if not top or a >= top[-1][1]:
                top.append((a, b, name))
        return top

    def _innermost_span(self, t):
        best = None
        for name, ivals in self.spans.items():
            i = bisect.bisect_right(self._starts[name], t) - 1
            if i >= 0 and t < ivals[i][1]:
                if best is None or ivals[i][0] > best[1]:
                    best = (name, ivals[i][0])
        return best[0] if best else "outside"

    def breakdown(self):
        """``{"device_ops": [[name, s], ...], "idle_gaps": [[name, s], ...]}``:
        device time summed by operation name, and idle time summed by what
        the host was doing: the innermost harness span and the top-level
        host operation, or "python" between operations."""
        dev = defaultdict(float)
        for a, b, name, _ in self.dev:
            dev[name] += (b - a) * 1e-6
        top = self._top_level_host()
        top_starts = [a for a, _, _ in top]
        cuts = sorted({t for a, b, _ in top for t in (a, b)}
                      | {t for ivals in self.spans.values() for iv in ivals for t in iv})
        gaps = defaultdict(float)
        edge = self.t0
        for a, b in self.busy + [[self.t1, self.t1]]:
            t = edge
            while t < a:
                k = bisect.bisect_right(cuts, t)
                end = min(a, cuts[k]) if k < len(cuts) else a
                i = bisect.bisect_right(top_starts, t) - 1
                op = top[i][2] if i >= 0 and t < top[i][1] else "python"
                gaps[f"{self._innermost_span(t)}: {op}"] += (end - t) * 1e-6
                t = end
            edge = max(edge, b)

        def head(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": head(dev), "idle_gaps": head(gaps)}
