"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell needs is found by name from ``BENCHMARK.json``:
``configs/<config>.json`` (its sizes; the entry's ``file``) beside
``configs/<config>.py`` (its data model and program objects),
``traffic/<traffic>.json``, ``limits/<cell>.json``,
``reference/<reference>.py`` and one ``metrics/<metric>.py`` per metric.

Traffic is a closed loop of one caller.  Set-up makes a pool of datasets
from the seed on the device and runs the warm-up fits.  The window then
runs fit after fit for ``seconds``: fit ``i`` takes dataset ``i mod
pool`` and a generator seeded from ``(seed, i)``, and ends when its
params, validity and count are on the host.  Once the window has closed,
the reference checks a sample of the fits (:mod:`gpubench.reference.judge`).
"""

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from gpubench.lib import host, window
from gpubench.lib.spans import Spans, resolve
from gpubench.lib.trace import Trace
from gpubench.reference import judge

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_file(path):
    """Import the Python file ``path`` as a module of its own."""
    name = "gpubench_" + "_".join(path.relative_to(BENCH_DIR).with_suffix("").parts)
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_benchmark(root=ROOT):
    return json.loads((root / "BENCHMARK.json").read_text())


def _read_json(path):
    return json.loads(path.read_text())


class Cell:
    """A workload of ``BENCHMARK.json`` with everything it names loaded.
    ``overrides`` (tests) replace top-level keys of the configuration,
    keys of its ``data`` and of the traffic mix."""

    def __init__(self, bench, name, overrides=None):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
        self.name, self.chips = name, w["chips"]
        self.cfg = _read_json(ROOT / entry["file"])
        self.module = load_file(BENCH_DIR / "configs" / f"{w['config']}.py")
        self.traffic = _read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
        self.limits = _read_json(BENCH_DIR / "limits" / f"{name}.json")
        self.cfg["data"] = {**self.cfg["data"], **self.traffic.get("data", {})}
        o = overrides or {}
        self.cfg.update({k: v for k, v in o.items() if k not in ("data", "traffic")})
        self.cfg["data"].update(o.get("data", {}))
        self.traffic.update(o.get("traffic", {}))
        if self.traffic["loop"] != "closed" or self.traffic["callers"] != 1:
            raise ValueError("the traffic generator runs a closed loop of one caller")

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def metrics(self, trace):
        specs = self.per_layer if trace else self.end_to_end
        return [(m, load_file(BENCH_DIR / "metrics" / f"{m['name']}.py")) for m in specs]


def _wraps_of(metric_modules, kind, first=None):
    """``{name: dotted path}`` of the ``kind`` (``SPANS`` or ``COUNTERS``)
    the metrics ask for; one name wraps one path."""
    wraps = dict(first or {})
    for _, mod in metric_modules:
        for name, path in getattr(mod, kind, {}).items():
            if wraps.setdefault(name, path) != path:
                raise ValueError(f"{name!r} wraps both {wraps[name]} and {path}")
    return wraps


def run(cell, seed, seconds, trace, device, t_start):
    """Run ``cell`` once and return the result object (see ``run.py``)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    cfg, traffic, mod = cell.cfg, cell.traffic, cell.module
    metric_modules = cell.metrics(trace)

    t_entry = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(window.derive_seed(seed, window.POOL, 0))
    pool = mod.make_pool(cfg, traffic["pool"], gen, dev)
    prog = [mod.program_data(d) for d in pool]
    est = mod.estimator(cfg, traffic["ls_type"])
    entry_mod, entry_attr = resolve(cfg["entry"])
    hyp = cfg["hypotheses"]

    def fit(i, stream):
        g = torch.Generator(device=dev)
        g.manual_seed(window.derive_seed(seed, stream, i))
        t0 = time.perf_counter()
        res = getattr(entry_mod, entry_attr)(est, prog[i % len(prog)], g, num_hypotheses=hyp)
        out = (res.params.cpu(), bool(res.valid), int(res.best_count))
        return time.perf_counter() - t0, out + (res.minimal_params, res.consensus)

    t_pool = time.perf_counter()
    warm = [fit(j, window.WARMUP)[0] for j in range(traffic["warmup_fits"])]
    spans = prof = None
    if trace:
        spans = Spans(sync)
        for name, path in _wraps_of(metric_modules, "SPANS", {"fit": cfg["entry"]}).items():
            spans.wrap(name, path)
        for name, path in _wraps_of(metric_modules, "COUNTERS").items():
            spans.count(name, path)
        acts = [torch.profiler.ProfilerActivity.CPU] + (
            [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        with torch.profiler.profile(activities=acts):     # the profiler's own start-up
            fit(0, window.WARMUP)
        spans.reset()
        prof = torch.profiler.profile(activities=acts)
    sync()
    setup_s = time.perf_counter() - t_start
    print(f"gpubench: set-up {setup_s:.3f} s: to the harness {t_entry - t_start:.3f}, "
          f"pool and program objects {t_pool - t_entry:.3f}, warm-up fits "
          f"{', '.join(f'{w:.3f}' for w in warm)}", file=sys.stderr)

    before = host.Reading(dev)
    lat, outs = [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        dt, out = fit(len(lat), window.WINDOW)
        lat.append(dt)
        outs.append(out)
    window_s = time.perf_counter() - t0
    spanned = len(lat)
    calls = dict(spans.calls) if spans is not None else {}
    host_record = host.Reading(dev).since(before)
    if prof is not None:    # profiled fits last: the profiler's own work stays out of the spans
        prof.start()
        for _ in range(traffic["trace_fits"]):
            dt, out = fit(len(lat), window.WINDOW)
            lat.append(dt)
            outs.append(out)
        prof.stop()
    traced_calls = ({k: v - calls.get(k, 0) for k, v in spans.calls.items()}
                    if spans is not None else {})
    if spans is not None:
        spans.restore()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    failed = sum(1 for o in outs if not o[1])

    checked = {}
    for i in window.fits_to_check(seed, lat, traffic["check_fits"]):
        params, valid, count, minimal, consensus = outs[i]
        checked[i] = {"params": params.double().numpy(), "valid": valid, "best_count": count,
                      "minimal": minimal.double().cpu().numpy(),
                      "consensus": consensus.cpu().numpy()}
    del outs, prog, est
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = judge.model(cfg["reference"])
    t_check = time.perf_counter()
    readings = [judge.judge(ref, pool[i % len(pool)], cfg["delta"],
                            window.derive_seed(seed, window.WINDOW, i), hyp,
                            traffic["ls_type"], out, dev)
                for i, out in checked.items()]
    print(f"gpubench: the reference checked {len(readings)} fits in "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    checks = {"failed": {"value": failed, "limit": 0}}
    for key in judge.NUMBERS:
        checks[key] = {"value": max(r[key] for r in readings), "limit": cell.limits[key]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    tr = Trace(prof.events()) if prof is not None else None
    readout = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, latencies=lat, spans=spans, trace=tr,
        spanned=spanned, calls=calls, traced_calls=traced_calls, cfg=cfg,
        device_kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
    )
    metrics = {}
    for spec, m in metric_modules:
        value = m.read(readout)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    result = {
        "correct": bool(correct), "attempted": len(lat), "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": readout.device_kind,
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["host"] = host_record
    result["checks"] = checks
    return result


def control_readings(cell, seed, fits, dtype, device, refit_type=None):
    """The largest readings of the reference computed in ``dtype`` and put
    in the program's place (the control), over the first ``fits`` fits of
    a run seeded ``seed``: the same datasets and generator seeds.
    ``refit_type`` replaces the reference's least-squares type (a fault:
    the LM left at its start is the algebraic or analytic refit)."""
    dev = torch.device(device)
    cfg, traffic, mod = cell.cfg, cell.traffic, cell.module
    gen = torch.Generator(device=dev)
    gen.manual_seed(window.derive_seed(seed, window.POOL, 0))
    pool = mod.make_pool(cfg, traffic["pool"], gen, dev)
    ref = judge.model(cfg["reference"])
    out = []
    for i in range(fits):
        s = window.derive_seed(seed, window.WINDOW, i)
        got = judge.reference_fit(ref, pool[i % len(pool)], cfg["delta"], s, cfg["hypotheses"],
                                  refit_type or traffic["ls_type"], dev, getattr(torch, dtype))
        out.append(judge.judge(ref, pool[i % len(pool)], cfg["delta"], s, cfg["hypotheses"],
                               traffic["ls_type"], got, dev))
    return {k: float(max(r[k] for r in out)) for k in judge.NUMBERS}
