"""Program tracing, and a ``torch.profiler`` window for an operator.

The reference has no profiling at all (SURVEY.md section 5).  Tracing is
off by default; :func:`set_tracing` turns it on and off.  When it is on,
the program records, in memory and on ``time.perf_counter_ns()``:

  * layer spans (:func:`span`): a name, start and end, the index of the
    enclosing span's record and the id of the fit it belongs to (every span
    inside one ``engine.fit`` shares that fit's id);
  * leaves (:func:`leaf`), the innermost spans, which also open a range
    named ``lsqr.<name>`` while a ``torch.profiler`` is recording, so a
    profile names the host's work inside a layer by its leaf; :func:`wait`
    is the leaf ``wait.<site>`` around a read that blocks the host until
    the device is done;
  * counters (:func:`count`): an int, and optionally a device tensor the
    program has already computed, read only by :func:`records`.

Layer spans open a range only inside :func:`trace`, the operator's window,
which shows the whole tree; elsewhere a range around a layer would hide
its leaves from a reader that names the host's work by its outermost range.

Tracing launches no device work and adds no synchronisation.  When it is
off, a span costs one check of a module flag and returns a shared null
context.  The log grows while tracing is on: :func:`records` and
:func:`reset` are the caller's to call between windows.  Tracing is for one
thread: the program's fits run on the caller's.
"""

import contextlib
import os
import tempfile
import time
from typing import NamedTuple, Optional

import torch

_on = False
_layer_ranges = False   # layer spans open ranges too (inside trace())
_log = []       # one list per record, the fields of Record; a kept tensor waits in "reading"
_open = []      # (record index, fit id) of the open spans, innermost last
_fits = 0       # fit ids handed out
_NULL = contextlib.nullcontext()


class Record(NamedTuple):
    kind: str                # "span", "leaf" or "count"
    name: str
    start_ns: int
    end_ns: int              # a counter's is its start
    parent: Optional[int]    # index of the enclosing span's record
    fit: Optional[int]       # id of the engine.fit it lies in, None outside any fit
    value: Optional[int]     # a counter's int
    reading: Optional[int]   # the largest element of a counter's kept tensor


def set_tracing(on: bool) -> bool:
    """Turn program tracing on or off; returns whether it was on."""
    global _on
    was, _on = _on, bool(on)
    return was


def records():
    """The log as :class:`Record` s, in the order spans opened and counters
    counted.  Reads the tensors counters kept (a wait for the device):
    call it after the fits it covers, never inside one."""
    out = []
    for rec in _log:
        if isinstance(rec[7], torch.Tensor):
            rec[7] = int(rec[7].max())
        out.append(Record(*rec))
    return out


def reset():
    """Clear the log; spans open now are left out of it."""
    _log.clear()
    _open.clear()


class _Span:
    __slots__ = ("kind", "name", "new_fit", "rec", "range")

    def __init__(self, kind, name, new_fit):
        self.kind, self.name, self.new_fit = kind, name, new_fit
        self.range = None

    def __enter__(self):
        global _fits
        parent, fit = _open[-1] if _open else (None, None)
        if self.new_fit:
            _fits += 1
            fit = _fits
        self.rec = [self.kind, self.name, 0, 0, parent, fit, None, None]
        _open.append((len(_log), fit))
        _log.append(self.rec)
        if (self.kind == "leaf" or _layer_ranges) and torch.autograd._profiler_enabled():
            # A function-scope range: a user-scope one (record_function)
            # also puts an image of itself on the device's timeline, which
            # a reader of the trace would take for device work.
            self.range = torch._C._profiler._RecordFunctionFast("lsqr." + self.name)
            self.range.__enter__()
        self.rec[2] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec[3] = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        if _open and _log[_open[-1][0]] is self.rec:
            _open.pop()
        return False


def span(name: str, new_fit: bool = False):
    """A layer span; ``new_fit`` starts a new fit id for it and everything
    inside it."""
    if not _on:
        return _NULL
    return _Span("span", name, new_fit)


def leaf(name: str):
    """An innermost span, and the profiler range ``lsqr.<name>``."""
    if not _on:
        return _NULL
    return _Span("leaf", name, False)


def wait(site: str):
    """The leaf ``wait.<site>``, around a read that blocks the host until
    the device is done."""
    if not _on:
        return _NULL
    return _Span("leaf", "wait." + site, False)


def count(name: str, n: int, keep: Optional[torch.Tensor] = None):
    """Add ``n`` to counter ``name``; ``keep`` is a tensor already computed
    whose largest element :func:`records` reads."""
    if not _on:
        return
    parent, fit = _open[-1] if _open else (None, None)
    t = time.perf_counter_ns()
    _log.append(["count", name, t, t, parent, fit, int(n), keep])


@contextlib.contextmanager
def trace(log_dir=None):
    """A ``torch.profiler`` window (CPU activity, and CUDA's when it is
    available) with program tracing on, whose Chrome trace is written to
    ``log_dir/trace.json`` on exit (default: ``torch-trace`` in the
    temporary directory); yields ``log_dir``.  The program's spans, layers
    and leaves alike, show in it as nested ``lsqr.<name>`` ranges.  A
    window that turned tracing on clears the log when it turns it off
    again: its records are in the trace.  View it in ``chrome://tracing``
    or Perfetto."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "torch-trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    global _layer_ranges
    was, _layer_ranges = set_tracing(True), True
    try:
        with profile(activities=activities) as prof:
            yield log_dir
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
    finally:
        _layer_ranges = False
        set_tracing(was)
        if not was:
            reset()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
