"""Spans around the program's functions, wrapped by dotted path.

A span synchronises the card at its start and its end, opens a
``torch.profiler.record_function`` range named ``gpubench.<name>`` and
records its host-clock interval.  A counter only counts calls: no sync and
no range, for a function called many times a fit.  Wrapping replaces a
module attribute, so it reaches every caller that looks the function up
through its module (or, inside that module, as a global) at call time.
"""

import importlib
import time
from collections import defaultdict

import torch

from gpubench.lib.trace import SPAN_PREFIX


def resolve(path):
    """``(module, attribute name)`` of a dotted path ``pkg.mod.attr``."""
    mod_path, attr = path.rsplit(".", 1)
    return importlib.import_module(mod_path), attr


class Spans:
    def __init__(self, sync):
        self.sync = sync
        self.log = defaultdict(list)     # name -> [(t0, t1)] host seconds
        self.calls = defaultdict(int)    # counter name -> calls
        self._undo = []

    def wrap(self, name, path):
        mod, attr = resolve(path)
        orig = getattr(mod, attr)
        log, sync, label = self.log[name], self.sync, SPAN_PREFIX + name

        def spanned(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            with torch.profiler.record_function(label):
                out = orig(*args, **kwargs)
                sync()
            log.append((t0, time.perf_counter()))
            return out

        setattr(mod, attr, spanned)
        self._undo.append((mod, attr, orig))
        return spanned

    def count(self, name, path):
        mod, attr = resolve(path)
        orig = getattr(mod, attr)
        calls = self.calls

        def counted(*args, **kwargs):
            calls[name] += 1
            return orig(*args, **kwargs)

        setattr(mod, attr, counted)
        self._undo.append((mod, attr, orig))
        return counted

    def restore(self):
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()

    def reset(self):
        for ivals in self.log.values():
            ivals.clear()
        self.calls.clear()

    def mean_ms(self, name, count):
        """Mean ms per call of span ``name`` over its first ``count`` calls
        (the fits the profiler did not trace)."""
        ivals = self.log[name][:count]
        return 1e3 * sum(t1 - t0 for t0, t1 in ivals) / len(ivals) if ivals else None
