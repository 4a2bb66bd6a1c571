"""The plain references: their solves, the hypothesis sets they rebuild in
each sampling design, and each configuration's truth recovered at a small
size."""

import json
import math

import numpy as np
import pytest
import torch

from gpubench.lib import runner
from gpubench.reference import crosswire, judge, linalg, sampling, sphere3d

SMALL = {"data": {"n": 256}, "traffic": {"pool": 2}}


def test_ge_solve_matches_a_library_solve():
    g = torch.Generator().manual_seed(3)
    a = torch.randn((50, 12, 12), generator=g, dtype=torch.float64)
    b = torch.randn((50, 12), generator=g, dtype=torch.float64)
    want = torch.linalg.solve(a, b)
    assert torch.allclose(linalg.ge_solve(a, b), want, rtol=1e-9, atol=1e-9)


def test_polar_factor_and_euler_angles():
    g = torch.Generator().manual_seed(4)
    x = torch.randn((20, 3, 3), generator=g, dtype=torch.float64)
    x = x * torch.sign(torch.linalg.det(x))[:, None, None]
    u, _, vt = torch.linalg.svd(x)
    assert torch.allclose(linalg.polar3(x, iters=30), u @ vt, atol=1e-10)
    angles = torch.tensor([1.1, 0.4, -0.7], dtype=torch.float64)
    got = linalg.euler_angles(linalg.euler_zyx(*angles))
    assert torch.allclose(torch.stack(got), angles, atol=1e-12)


@pytest.mark.parametrize("family,n,groups", [("sphere3d", 128, 6), ("crosswire", 256, 3),
                                             ("sphere3d", 200, 2)])
def test_sampling_rebuilds_the_programs_hypothesis_set(family, n, groups):
    """The frozen description of the sweep's sampling against the
    program's own reconstruction, on the same permutations."""
    from lsqrrecipes_tpu_torch.geometry import Frame
    from lsqrrecipes_tpu_torch.ops import fused_sweep

    k = 4
    n_fit = sampling.fit_width(n, k)
    perms = sampling.draw_perms(9, n_fit, k, "cpu")
    if family == "sphere3d":
        data = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
        feats = data
    else:
        r = torch.arange(n * 9, dtype=torch.float64).reshape(n, 3, 3)
        data = (Frame(r, torch.zeros(n, 3, dtype=torch.float64)),
                torch.zeros(n, 2, dtype=torch.float64))
        feats = r.reshape(n, 9)
    got = sampling.sample_indices(perms, n, k, 0, groups)
    want = fused_sweep.reference_samples(family, data, perms, groups)      # [B, k, F]
    assert torch.equal(feats[got][..., : feats.shape[1]].to(want.dtype),
                       want[..., : feats.shape[1]])


@pytest.mark.parametrize("cells", [3 * 256 * 200, judge.CHUNK_CELLS], ids=["chunked", "whole"])
def test_no_sampling_key_means_the_fused_design(cells):
    """A configuration without ``sampling`` is checked in the fused design,
    whose indices are :func:`sampling.sample_indices` on the sweep's
    permutations, in chunks of whole groups within ``cells``."""
    bench = runner.load_benchmark()
    plain = [w["name"] for w in bench["workloads"]
             if "sampling" not in json.loads((runner.BENCH_DIR / "configs" /
                                              f"{w['config']}.json").read_text())]
    assert plain
    assert all(runner.Cell(bench, name).sampling == "fused" for name in plain)
    n, k, hypotheses = 200, 4, 5000
    chunks = list(judge.design("fused")(9, n, k, hypotheses, "cpu", cells))
    n_fit = sampling.fit_width(n, k)
    want = sampling.sample_indices(sampling.draw_perms(9, n_fit, k, "cpu"), n, k, 0,
                                   sampling.num_groups(hypotheses, n))
    assert torch.equal(torch.cat(chunks), want)
    assert all(c.shape[0] % n_fit == 0 and c.shape[0] * n <= cells for c in chunks)


@pytest.mark.parametrize("n,k,groups", [(64, 31, 1024), (200, 4, 3), (256, 4, 2)])
@pytest.mark.parametrize("cells", ["chunked", "whole"])
def test_structured_design_rebuilds_the_programs_hypothesis_set(n, k, groups, cells):
    """The frozen structured design against the program's own structured
    draw from a CPU generator seeded alike, on data ``arange(n)``; k = 31 at
    n = 64 is the plane phantom's, which the fused design cannot describe."""
    from lsqrrecipes_tpu_torch.ransac.sampling import structured_samples

    seed = 2**31 + 41
    budget = 37 * n if cells == "chunked" else judge.CHUNK_CELLS
    chunks = list(judge.design("structured")(seed, n, k, groups * n, "cpu", budget))
    want = structured_samples(torch.Generator().manual_seed(seed), torch.arange(n), k, groups)
    assert torch.equal(torch.cat(chunks), want)
    assert all(c.shape[0] * n <= budget for c in chunks)
    assert len(chunks) == (-(-groups * n // 37) if cells == "chunked" else 1)


def test_the_design_comes_from_the_configuration():
    cell = runner.Cell(runner.load_benchmark(), "sphere3d.algebraic", {"sampling": "structured"})
    assert cell.sampling == "structured"
    assert judge.design(cell.sampling).__module__ == "gpubench.reference.sampling_structured"
    with pytest.raises(ValueError, match="no sweep width"):
        next(judge.design()(1, 64, 31, 64 * 1024, "cpu", judge.CHUNK_CELLS))


def _pool(name):
    cell = runner.Cell(runner.load_benchmark(), name, SMALL)
    g = torch.Generator().manual_seed(21)
    return cell, cell.module.make_pool(cell.cfg, 2, g, torch.device("cpu"))


@pytest.mark.parametrize("ls_type", ["algebraic", "geometric"])
def test_sphere_reference_recovers_the_truth(ls_type):
    cell, pool = _pool(f"sphere3d.{ls_type}")
    truth = torch.tensor(cell.module.truth(cell.cfg), dtype=torch.float64)
    for data in pool:
        out = judge.reference_fit(sphere3d, data, cell.cfg["delta"], 5, 4096, ls_type, "cpu",
                                  torch.float64)
        assert out["valid"]
        assert np.abs(out["params"] - truth.numpy()).max() < 0.15
        assert out["best_count"] >= math.floor(0.8 * 256) * 0.95


@pytest.mark.parametrize("ls_type", ["analytic", "iterative"])
def test_crosswire_reference_recovers_the_truth(ls_type):
    cell, pool = _pool(f"crosswire.{ls_type}")
    truth = np.array(cell.module.truth(cell.cfg))
    for data in pool:
        out = judge.reference_fit(crosswire, data, cell.cfg["delta"], 6, 2048, ls_type, "cpu",
                                  torch.float64)
        assert out["valid"]
        p = out["params"][:11]
        assert np.abs(p[0:6] - truth[0:6]).max() < 1.0                  # mm
        assert np.degrees(np.abs(p[6:9] - truth[6:9])).max() < 1.0      # degrees
        assert np.abs(p[9:11] - truth[9:11]).max() < 0.005              # mm per pixel
        assert out["best_count"] >= 256 - math.floor(0.2 * 256) - 5


def test_reference_agreement_and_vote_count_alike():
    cell, pool = _pool("crosswire.iterative")
    data = pool[0]
    params, valid = crosswire.minimal_fit(crosswire.features(data)[torch.arange(64).reshape(16, 4)])
    counts = crosswire.vote_counts(params, data, 3.0)
    for i in range(16):
        if valid[i]:
            assert int(counts[i]) == int(crosswire.agree(params[i], data, 3.0).sum())
    cell, pool = _pool("sphere3d.geometric")
    data = pool[0].double()
    params, valid = sphere3d.minimal_fit(data[torch.arange(64).reshape(16, 4)])
    counts = sphere3d.vote_counts(params, data, 1.0)
    for i in range(16):
        if valid[i]:
            assert abs(int(counts[i]) - int(sphere3d.agree(params[i], data, 1.0).sum())) <= 1
