"""The port's own tracing (``lsqrrecipes_tpu_torch.utils.profiling``).

Off by default, it records nothing and opens no profiler range.  On, a
``ransac_fused_sweep`` fit records the tree of spans, leaves, waits and
counters at its layer boundaries under one fit id, with every child inside
its parent and the four leaves of each LM step inside the step; the fit's
results and the aten operations it dispatches are those of a fit with
tracing off; the LM's completion checks are ``wait.lm_done`` leaves, one
per check, and its ``lm.steps`` counter keeps the iteration tensor from
which the steps with a live problem are read.  Under a profiler, leaves are
``lsqr.<name>`` ranges and layer spans are not; inside the operator's
``trace()`` window both are.  A plane-phantom fit, which ``ransac_fused_sweep``
hands to the structured sweep, records that sweep as the span ``sweep``
(``sweep.prep``, then ``sweep.fit`` and ``sweep.vote`` once a chunk, the
``sweep.chunks`` counter) and the winner's ``agree`` as ``engine.agree``.
All on the CPU, through the plain sweep.
"""

import contextlib
import json
from collections import Counter

import pytest
import torch

from lsqrrecipes_tpu_torch.estimators.sphere import SphereEstimator
from lsqrrecipes_tpu_torch.estimators.us_calibration import (CrosswireUSCalibrationEstimator,
                                                             PlanePhantomUSCalibrationEstimator)
from lsqrrecipes_tpu_torch.linalg.lm import _CHECK_EVERY, LMConfig, lm_core
from lsqrrecipes_tpu_torch.ops import us_fast
from lsqrrecipes_tpu_torch.ransac import ransac_fused_sweep
from lsqrrecipes_tpu_torch.synthetic import make_crosswire_data, make_plane_phantom_data
from lsqrrecipes_tpu_torch.utils import profiling

torch.set_num_threads(2)

FITS = ("sphere_geometric", "crosswire_iterative")
LEAVES = {"sweep.prep", "sweep.launch", "sweep.post", "sweep.fit", "sweep.vote", "engine.agree",
          "wait.count", "refit.start", "wait.svd", "lm.normal", "lm.solve", "lm.trial",
          "lm.update", "wait.lm_done"}
LAYERS = {"engine.fit", "sweep", "refit", "lm", "lm.step"}
COUNTERS = {"lm.steps", "sweep.chunks"}
STEP_LEAVES = ["lm.normal", "lm.solve", "lm.trial", "lm.update"]


def _sphere_cloud(n=128, outliers=26):
    g = torch.Generator().manual_seed(3)
    u = torch.randn((n, 3), generator=g, dtype=torch.float64)
    pts = 25.0 * u / u.norm(dim=-1, keepdim=True) + 0.3 * torch.randn((n, 3), generator=g,
                                                                      dtype=torch.float64)
    pts[n - outliers:] = 80.0 * torch.rand((outliers, 3), generator=g, dtype=torch.float64) - 40.0
    return (pts + torch.tensor([5.0, -2.0, 11.0], dtype=torch.float64)).to(torch.float32)


def _make(which):
    """``(estimator, data)`` of a small fit of the families the benchmark's
    LM cells run."""
    if which == "sphere_geometric":
        return SphereEstimator(1.0, dim=3), _sphere_cloud()
    if which == "phantom_iterative":
        noisy, _, _ = make_plane_phantom_data(torch.Generator().manual_seed(3), n=64, sigma=0.5,
                                              device="cpu")
        return PlanePhantomUSCalibrationEstimator(1.0), noisy
    noisy, _, _ = make_crosswire_data(torch.Generator().manual_seed(5), n=128, sigma=0.5,
                                      device="cpu")
    return CrosswireUSCalibrationEstimator(3.0), noisy


def _fit(which):
    est, data = _make(which)
    return ransac_fused_sweep(est, data, torch.Generator().manual_seed(7), num_hypotheses=512)


@contextlib.contextmanager
def _tracing_on():
    """Program tracing on inside, off and empty after."""
    profiling.reset()
    profiling.set_tracing(True)
    try:
        yield profiling
    finally:
        profiling.set_tracing(False)
        profiling.reset()


@pytest.fixture
def tracing():
    with _tracing_on() as on:
        yield on


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events()]


def test_tracing_is_off_by_default():
    assert profiling.set_tracing(False) is False
    profiling.reset()
    names = _profiled(lambda: _fit("sphere_geometric"))
    assert profiling.records() == []
    assert not [n for n in names if n.startswith("lsqr.")]
    assert profiling.span("x") is profiling.leaf("y") is profiling.wait("z")


@pytest.mark.parametrize("which", FITS)
def test_a_fit_records_its_tree(tracing, which):
    _fit(which)
    recs = tracing.records()
    fits = [r for r in recs if r.name == "engine.fit"]
    assert len(fits) == 1 and fits[0].parent is None
    assert {r.fit for r in recs} == {fits[0].fit}
    names = Counter(r.name for r in recs)
    want = {"engine.fit", "sweep", "sweep.prep", "sweep.launch", "engine.agree", "wait.count",
            "refit", "refit.start", "lm", "lm.step", "lm.steps", "wait.lm_done", *STEP_LEAVES}
    if which == "crosswire_iterative":
        want.add("sweep.post")
    assert want <= set(names) <= want | {"wait.svd"}
    parent_of = {"sweep": "engine.fit", "sweep.prep": "sweep", "sweep.launch": "sweep",
                 "sweep.post": "sweep", "engine.agree": "engine.fit",
                 "wait.count": "engine.fit", "refit": "engine.fit", "refit.start": "refit",
                 "lm": "refit", "lm.step": "lm", "wait.lm_done": "lm", "lm.steps": "lm",
                 **{leaf: "lm.step" for leaf in STEP_LEAVES}}
    for r in recs:
        assert r.kind == ("count" if r.name in COUNTERS else
                          "leaf" if r.name in LEAVES else "span")
        if r.parent is None:
            continue
        p = recs[r.parent]
        assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
        if r.name != "wait.svd":
            assert p.name == parent_of[r.name], (r.name, p.name)
    # The four leaves tile each step, in order.
    steps = [i for i, r in enumerate(recs) if r.name == "lm.step"]
    for i in steps:
        kids = [r for r in recs if r.parent == i]
        assert [r.name for r in kids] == STEP_LEAVES
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    (counted,) = [r for r in recs if r.name == "lm.steps"]
    assert counted.value == len(steps) == names["lm.step"]
    assert names["wait.lm_done"] == len(steps) // _CHECK_EVERY
    assert 1 <= counted.reading <= counted.value


@pytest.mark.parametrize("chunk_cap", [None, 192])
def test_a_structured_phantom_fit_records_its_tree(tracing, monkeypatch, chunk_cap):
    """The structured sweep inside ``engine.fit``: ``sweep`` holds
    ``sweep.prep``, the ``sweep.chunks`` counter and a ``sweep.fit`` then a
    ``sweep.vote`` per chunk, ``ceil(groups n / _chunk_size)`` of them (512
    hypotheses make one chunk, three when chunks are cut to 192); the
    winner's ``agree`` is ``engine.agree``; the refit as in the fused
    cells."""
    if chunk_cap is not None:
        size = us_fast._chunk_size
        monkeypatch.setattr(us_fast, "_chunk_size",
                            lambda bsz, n, k=4: min(size(bsz, n, k), chunk_cap))
    _fit("phantom_iterative")
    recs = tracing.records()
    fits = [r for r in recs if r.name == "engine.fit"]
    assert len(fits) == 1 and {r.fit for r in recs} == {fits[0].fit}
    chunks = -(-512 // us_fast._chunk_size(512, 64, 31))
    assert chunks == (1 if chunk_cap is None else 3)
    names = Counter(r.name for r in recs)
    assert names["sweep"] == names["sweep.prep"] == names["sweep.chunks"] == 1
    assert names["sweep.fit"] == names["sweep.vote"] == chunks
    assert {"engine.agree", "wait.count", "refit", "refit.start", "lm", "lm.steps"} <= set(names)
    assert not {"sweep.launch", "sweep.post"} & set(names)
    (sweep,) = [i for i, r in enumerate(recs) if r.name == "sweep"]
    assert recs[recs[sweep].parent].name == "engine.fit"
    kids = [r for r in recs if r.parent == sweep]
    assert [r.name for r in kids] == (["sweep.prep", "sweep.chunks"]
                                      + ["sweep.fit", "sweep.vote"] * chunks)
    (counted,) = [r for r in kids if r.name == "sweep.chunks"]
    assert counted.kind == "count" and counted.value == chunks
    for r in recs:
        assert r.kind == ("count" if r.name in COUNTERS else
                          "leaf" if r.name in LEAVES else "span")
        if r.parent is not None:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    (agree,) = [r for r in recs if r.name == "engine.agree"]
    assert recs[agree.parent].name == "engine.fit" and agree.start_ns >= recs[sweep].end_ns


@pytest.mark.parametrize("which", [*FITS, "phantom_iterative"])
def test_tracing_changes_no_result(which):
    off = _fit(which)
    was = profiling.set_tracing(True)
    try:
        on = _fit(which)
    finally:
        profiling.set_tracing(was)
        profiling.reset()
    assert torch.equal(on.params, off.params) and torch.equal(on.consensus, off.consensus)
    assert int(on.best_count) == int(off.best_count) and bool(on.valid) == bool(off.valid)
    assert torch.equal(on.minimal_params, off.minimal_params)


@pytest.mark.parametrize("which", [*FITS, "phantom_iterative"])
def test_tracing_dispatches_the_same_operations(which):
    """Under a profiler, the aten operations of a fit with tracing on are
    those with it off; the profiler's own operations are left out."""

    def ops():
        names = _profiled(lambda: _fit(which))
        return Counter(n for n in names if n.startswith("aten::"))

    _fit(which)
    off = ops()
    was = profiling.set_tracing(True)
    try:
        on = ops()
    finally:
        profiling.set_tracing(was)
        profiling.reset()
    assert on == off and sum(off.values()) > 0


@pytest.mark.parametrize("finish,steps,waits,live", [
    ([1, 5, 6], 8, 2, 7),      # lanes finish in steps 2, 6 and 7; checks after 4 and 8
    ([0, 0], 4, 1, 1),         # both finish in the first step; one check
    ([7, 2], 8, 2, 8),         # the last lane finishes in the check's own step
])
def test_lm_waits_once_per_check_and_counts_live_steps(tracing, finish, steps, waits, live):
    """A batch whose lanes meet the gradient test at known steps: lane b's
    gradient is zero from step ``finish[b]`` (0-based) on."""
    finish_at = torch.tensor(finish)
    calls = []

    def normal_system(x):
        live_lane = (len(calls) < finish_at).to(x.dtype)
        calls.append(None)
        jtj = torch.eye(2, dtype=x.dtype).expand(*x.shape[:-1], 2, 2)
        return jtj, live_lane[:, None] * torch.ones_like(x)

    def cost_of(x):
        return 0.5 * torch.sum(x * x, dim=-1)

    x0 = torch.full((len(finish), 2), 10.0, dtype=torch.float64)
    res = lm_core(normal_system, cost_of, x0, LMConfig(max_iters=50))
    assert res.iterations.tolist() == [f + 1 for f in finish]
    recs = tracing.records()
    (counted,) = [r for r in recs if r.name == "lm.steps"]
    assert (counted.value, counted.reading) == (steps, live) and len(calls) == steps
    assert sum(r.name == "wait.lm_done" for r in recs) == waits
    assert sum(r.name == "lm.step" for r in recs) == steps


def test_leaves_are_profiler_ranges_and_layer_spans_are_not(tracing):
    names = _profiled(lambda: _fit("crosswire_iterative"))
    ranges = Counter(n[len("lsqr."):] for n in names if n.startswith("lsqr."))
    recs = tracing.records()
    assert ranges == Counter(r.name for r in recs if r.kind == "leaf")
    assert set(ranges) <= LEAVES and not set(ranges) & LAYERS
    assert {"sweep.prep", "lm.normal", "wait.count"} <= set(ranges)


@pytest.mark.parametrize("was_on", [False, True])
def test_the_operators_window_shows_every_span_and_owns_only_its_own_log(tmp_path, was_on):
    """Inside ``trace()`` layer spans are ranges too, so its Chrome trace
    shows the whole tree; a window that turned tracing on clears the log as
    it turns it off again, one that found it on leaves the caller's log."""
    profiling.reset()
    profiling.set_tracing(was_on)
    try:
        with profiling.trace(str(tmp_path)):
            _fit("sphere_geometric")
            recs = profiling.records()
        with open(tmp_path / "trace.json") as f:
            events = json.load(f)["traceEvents"]
        ranges = Counter(e["name"][len("lsqr."):] for e in events
                         if e.get("ph") == "X" and e.get("name", "").startswith("lsqr."))
        assert ranges == Counter(r.name for r in recs if r.kind != "count")
        assert LAYERS <= set(ranges) and {"sweep.prep", "lm.normal"} <= set(ranges)
        assert profiling.set_tracing(False) is was_on
        assert profiling.records() == (recs if was_on else [])
    finally:
        profiling.set_tracing(False)
        profiling.reset()
    # Outside the window, layer spans open no range again.
    with _tracing_on():
        names = _profiled(lambda: _fit("sphere_geometric"))
    assert not {n[len("lsqr."):] for n in names if n.startswith("lsqr.")} & LAYERS
