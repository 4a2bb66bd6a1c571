"""The harness's arithmetic: the window, span self-time, the trace reader,
the frozen roofline counts, and BENCHMARK.json against the files it names."""

import json
import statistics
from types import SimpleNamespace

import pytest
import torch

from gpubench.lib import runner, window
from gpubench.lib.spans import Spans
from gpubench.lib.trace import Trace

BENCH = runner.load_benchmark()


def test_fit_ms_is_the_window_over_every_fit():
    assert window.fit_ms(30.0, 200) == pytest.approx(150.0)
    lat = [0.1] * 95 + [0.5] * 5
    assert window.p95_ms(lat) == pytest.approx(1e3 * statistics.quantiles(
        lat, n=20, method="inclusive")[-1])
    assert window.p95_ms([0.1] * 94 + [1.0] * 6) == pytest.approx(1000.0)
    assert window.p95_ms([0.25]) == pytest.approx(250.0)


def test_p95_counts_the_tail_of_all_fits():
    lat = [0.010 * (i + 1) for i in range(100)]
    assert window.p95_ms(lat) == pytest.approx(950.5, rel=1e-9)


def test_derived_seeds_are_fixed_distinct_and_take_large_seeds():
    big = 2**31 + 12345
    assert window.derive_seed(big, window.WINDOW, 0) == window.derive_seed(big, window.WINDOW, 0)
    seeds = {window.derive_seed(big, s, i) for s in range(3) for i in range(50)}
    assert len(seeds) == 150 and all(0 <= s < 2**63 for s in seeds)
    torch.Generator().manual_seed(max(seeds))


def test_fits_to_check_hold_the_slowest_and_repeat_none():
    lat = [0.1, 0.3, 0.2, 0.9, 0.1, 0.4]
    picked = window.fits_to_check(5, lat, 4)
    assert picked[0] == 3 and len(set(picked)) == 4
    assert window.fits_to_check(5, lat, 4) == picked
    assert sorted(window.fits_to_check(5, lat, 10)) == list(range(6))


def _fake_module_fn():
    return 7


def test_spans_wrap_by_dotted_path_and_give_self_time(monkeypatch):
    import gpubench.tests.test_gpubench_harness as me

    spans = Spans(lambda: None)
    spans.wrap("inner", f"{me.__name__}._fake_module_fn")
    assert me._fake_module_fn() == 7 and len(spans.log["inner"]) == 1
    spans.restore()
    assert me._fake_module_fn is _fake_module_fn
    spans.log["fit"] += [(0.0, 0.010), (1.0, 1.012)]
    spans.log["sweep"] += [(0.001, 0.003), (1.001, 1.003)]
    spans.log["refit"] += [(0.004, 0.009), (1.004, 1.011)]
    metric = runner.load_file(runner.BENCH_DIR / "metrics" / "engine_self_ms.py")
    got = metric.read(SimpleNamespace(spans=spans, spanned=2))
    assert got == pytest.approx(((10 - 2 - 5) + (12 - 2 - 7)) / 2)
    assert spans.mean_ms("refit", 1) == pytest.approx(5.0)


def test_a_counter_counts_calls_and_is_undone():
    import gpubench.tests.test_gpubench_harness as me

    spans = Spans(lambda: pytest.fail("a counter never synchronises"))
    spans.count("calls", f"{me.__name__}._fake_module_fn")
    assert [me._fake_module_fn() for _ in range(3)] == [7, 7, 7]
    assert spans.calls["calls"] == 3
    spans.reset()
    assert spans.calls["calls"] == 0
    spans.restore()
    assert me._fake_module_fn is _fake_module_fn
    metric = runner.load_file(runner.BENCH_DIR / "metrics" / "lm_steps.py")
    assert metric.read(SimpleNamespace(calls={"lm_step": 30}, spanned=4)) == pytest.approx(7.5)
    assert metric.read(SimpleNamespace(calls={}, spanned=4)) is None


def test_launches_per_lm_step_are_the_lm_spans_kernels_over_the_traced_steps():
    metric = runner.load_file(runner.BENCH_DIR / "metrics" / "lm_step_launches.py")
    trace = SimpleNamespace(spans={"lm": [(0, 1), (2, 3)]},
                            ops_in=lambda span, kernels_only: [None] * (348 if span == "lm" else 9))
    run = SimpleNamespace(trace=trace, traced_calls={"lm_step": 2}, calls={"lm_step": 50})
    assert metric.read(run) == pytest.approx(174.0)
    assert metric.read(SimpleNamespace(trace=trace, traced_calls={})) is None
    assert metric.read(SimpleNamespace(trace=None, traced_calls={"lm_step": 2})) is None


def test_the_lm_step_counter_counts_each_step_of_the_loop():
    """Each step of ``lm_core`` calls the wrapped solve once, through the
    module, so the count is the loop's steps."""
    from lsqrrecipes_tpu_torch.linalg import lm

    metric = runner.load_file(runner.BENCH_DIR / "metrics" / "lm_steps.py")
    spans = Spans(lambda: None)
    for name, path in metric.COUNTERS.items():
        spans.count(name, path)
    try:
        x0 = torch.tensor([3.0, -1.0], dtype=torch.float64)
        target = torch.tensor([1.0, 2.0], dtype=torch.float64)

        def normal_system(x):
            return torch.eye(2, dtype=x.dtype), x - target

        def cost_of(x):
            return 0.5 * torch.sum((x - target) ** 2)

        res = lm.lm_core(normal_system, cost_of, x0, lm.LMConfig(max_iters=6))
    finally:
        spans.restore()
    assert int(res.iterations) == 6 and spans.calls["lm_step"] == 6


def test_the_host_record_reads_the_host():
    from gpubench.lib import host

    cpu = torch.device("cpu")
    before = host.Reading(cpu)
    rec = host.Reading(cpu).since(before)
    assert set(rec) == {"probe_ms", "launch_us"}
    assert all(ms > 0 for ms in rec["probe_ms"]) and rec["launch_us"] == [None, None]


def _event(name, t0, t1, cuda=False, thread=1, corr=0):
    dt = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=t0, end=t1),
                           device_type=dt, thread=thread, id=corr)


def test_trace_busy_idle_kernels_in_spans_and_breakdown():
    events = [
        _event("gpubench.fit", 0, 100),
        _event("gpubench.sweep", 5, 40),
        _event("gpubench.refit", 50, 90),
        _event("aten::randperm", 6, 10),
        _event("aten::linalg_solve", 55, 70),
        _event("cudaLaunchKernel", 12, 12.5, corr=901),
        _event("cudaLaunchKernel", 56, 56.5, corr=902),
        _event("gpubench.sweep", 5, 40, cuda=True),          # device image of a span
        _event("sphere3d_kernel", 12, 30, cuda=True, corr=901),
        _event("Memcpy DtoH (Device -> Pinned)", 31, 33, cuda=True, corr=77),
        _event("small_kernel", 60, 62, cuda=True, corr=902),
        _event("small_kernel", 64, 66, cuda=True),
        _event("Memset (Device)", 80, 81, cuda=True),
    ]
    tr = Trace(events)
    assert tr.fits == 1 and tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx((18 + 2 + 2 + 2 + 1) * 1e-6)
    assert [op[2] for op in tr.ops_in("sweep")] == ["sphere3d_kernel",
                                                    "Memcpy DtoH (Device -> Pinned)"]
    assert len(tr.ops_in("refit", kernels_only=True)) == 2
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["sphere3d_kernel", pytest.approx(18e-6)]
    gaps = dict((k, v) for k, v in bd["idle_gaps"])
    want = {"fit: python": 25, "sweep: python": 11, "sweep: aten::randperm": 4,
            "refit: python": 24, "refit: aten::linalg_solve": 11}
    assert gaps == {k: pytest.approx(v * 1e-6) for k, v in want.items()}
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s)


def test_an_operation_belongs_to_the_span_that_launched_it():
    """The card's clock may sit off the host's: a kernel that started on the
    card after its span closed still counts where its launch call ran."""
    events = [
        _event("gpubench.fit", 0, 100),
        _event("gpubench.sweep", 5, 40),
        _event("gpubench.refit", 50, 90),
        _event("cuLaunchKernel", 38, 39, corr=5),
        _event("sphere3d_kernel", 41, 60, cuda=True, corr=5),
        _event("small_kernel", 70, 71, cuda=True, corr=6),
    ]
    tr = Trace(events)
    assert [op[2] for op in tr.ops_in("sweep")] == ["sphere3d_kernel"]
    assert [op[2] for op in tr.ops_in("refit")] == ["small_kernel"]


def test_the_cards_clock_is_moved_onto_the_hosts():
    """Device events recorded 300 us late: busy time and gaps still fall
    inside the window, where their launches put them."""
    late = 300
    events = [
        _event("gpubench.fit", 0, 100),
        _event("gpubench.sweep", 5, 40),
        _event("cudaLaunchKernel", 10, 11, corr=1),
        _event("cudaLaunchKernel", 90, 91, corr=2),
        _event("sphere3d_kernel", 11 + late, 30 + late, cuda=True, corr=1),
        _event("small_kernel", 95 + late, 99 + late, cuda=True, corr=2),
    ]
    tr = Trace(events)
    assert tr.busy_s == pytest.approx((19 + 4) * 1e-6)
    assert [op[:2] for op in tr.dev] == [(10, 29), (94, 98)]
    assert sum(v for _, v in tr.breakdown()["idle_gaps"]) == pytest.approx(77e-6)


@pytest.mark.parametrize("family,hyp,ms", [("sphere3d", 2**22, 0.7123430629),
                                           ("crosswire", 2**20, 0.7021546603)])
def test_frozen_roofline_counts(family, hyp, ms):
    """The problem's work at the main shapes, against the card's peak."""
    work = runner.load_file(runner.BENCH_DIR / "roofline" / f"{family}.py").work
    from gpubench.roofline.peaks import PEAKS

    ops, nbytes = work(hyp, 1024)
    rate, bw = PEAKS["NVIDIA H100 80GB HBM3"]
    assert max(ops / rate, nbytes / bw) * 1e3 == pytest.approx(ms, rel=1e-9)
    assert ops / rate > nbytes / bw


def test_benchmark_names_files_that_exist():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for name in names:
        metric = runner.load_file(runner.BENCH_DIR / "metrics" / f"{name}.py")
        assert callable(metric.read)
    for c in BENCH["configs"]:
        cfg = json.loads((runner.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert (runner.BENCH_DIR / "configs" / f"{c['name']}.py").exists()
        assert (runner.BENCH_DIR / "reference" / f"{cfg['reference']}.py").exists()
        assert (runner.BENCH_DIR / "roofline" / f"{cfg['family']}.py").exists()
    for w in BENCH["workloads"]:
        cell = runner.Cell(BENCH, w["name"])
        assert cell.end_to_end and cell.per_layer
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)


def test_benchmark_keeps_to_the_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for c in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(c["why"]) <= 200
