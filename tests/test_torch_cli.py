"""The port's console entry point (``lsqrrecipes_tpu_torch.cli``), mirroring
``tests/test_cli.py`` with ``--device cpu``: ``info`` prints the JAX CLI's
estimator registry (names, k, nparams), ``bench`` one JSON line; without
CUDA the default device makes ``bench`` exit non-zero."""

import json

import pytest
import torch

from lsqrrecipes_tpu.cli import main as jax_main
from lsqrrecipes_tpu_torch.cli import main
from lsqrrecipes_tpu_torch.ransac import engine


def _registry(out):
    lines = out.splitlines()
    start = lines.index("registered estimators:")
    return [line for line in lines[start + 1:] if line.startswith("  ")]


def test_cli_info(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("lsqrrecipes_tpu_torch ")
    assert "registered estimators" in out and "us_plane_phantom" in out
    assert jax_main(["info"]) == 0
    registry = _registry(out)
    assert len(registry) == 11 and registry == _registry(capsys.readouterr().out)


def test_cli_bench_small(capsys, monkeypatch):
    families = []
    fused = engine.ransac_fused_sweep

    def spy(est, data, *args, **kw):
        families.append(est.fused_family)
        return fused(est, data, *args, **kw)

    import lsqrrecipes_tpu_torch.ransac as ransac_pkg

    monkeypatch.setattr(ransac_pkg, "ransac_fused_sweep", spy)
    assert main(["bench", "--hypotheses", "1024", "--n", "128", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    payload = json.loads(line)
    assert payload["metric"] == "cli_ransac_hypotheses_per_s"
    assert payload["value"] > 0 and payload["unit"] == "hyp/s"
    assert payload["center_error"] < 1.0
    assert payload["inlier_fraction"] >= 0.75
    assert families == ["sphere3d", "sphere3d"]        # warm, then timed


def test_cli_bench_without_cuda_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    assert main(["bench", "--hypotheses", "1024", "--n", "128"]) != 0
    assert main(["bench", "--device", "cuda"]) != 0
    captured = capsys.readouterr()
    assert "CUDA is not available" in captured.err and captured.out == ""
