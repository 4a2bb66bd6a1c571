"""Run EVERY example of the port (``lsqrrecipes_tpu_torch.examples``) on the
CPU, in-process, in a temporary working directory.

Each must exit 0, print its RANSAC report and write the JAX example's
artifacts, checked as ``tests/test_examples.py`` checks them (the checks,
copied from there, live in ``examples/common.py``, which ``chip_smoke.py``
shares; ``line_estimation``'s two scenes are listed, as that test's source
scan does not find them): OpenInventor ``.iv`` scenes with the format
header and balanced braces, and the reference's ``<precomputed_transform>``
XML result.  The three examples that read the reference's data run on files
in its formats that the test writes (20% outliers), so none of them skips:
their RANSAC estimates must recover the truth the files were written from,
at the JAX tests' limits, and their deterministic least-squares report
lines must equal the JAX examples' on the same files.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from lsqrrecipes_tpu_torch.examples.common import (
    EXAMPLE_ARTIFACTS,
    READS_DATA,
    check_iv,
    check_xml,
    estimate_errors,
    reference_format_truth,
    report_values,
    write_reference_format_data,
)
from lsqrrecipes_tpu_torch.synthetic import M_X, M_Y

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "lsqrrecipes_tpu_torch" / "examples"
JAX_EXAMPLES = ROOT / "examples"
DATA_SEED = 1


def _discover_scenes(name):
    """Scan the example's source for the .iv scene names it writes."""
    with open(EXAMPLES / f"{name}.py") as f:
        src = f.read()
    return [
        tok
        for tok in set(
            part.strip("\"'")
            for part in src.replace("(", " ").replace(")", " ").split()
            if part.strip("\"'").endswith(".iv")
        )
    ]


def test_every_example_is_listed():
    found = {p.stem for p in EXAMPLES.glob("*.py")} - {"__init__", "common"}
    assert found == set(EXAMPLE_ARTIFACTS)
    for name, (scenes, _) in EXAMPLE_ARTIFACTS.items():
        assert set(_discover_scenes(name)) <= set(scenes)


@pytest.mark.parametrize("name", sorted(EXAMPLE_ARTIFACTS))
def test_example_runs(name, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu"]
    if name in READS_DATA:
        data_dir = write_reference_format_data(tmp_path / "data", seed=DATA_SEED)
        argv += ["--data-dir", str(data_dir)]
    module = importlib.import_module(f"lsqrrecipes_tpu_torch.examples.{name}")
    assert module.main(argv) == 0
    out = capsys.readouterr().out
    assert "RANSAC" in out or "ransac" in out
    assert "nothing to do" not in out
    scenes, xml_names = EXAMPLE_ARTIFACTS[name]
    for scene in scenes:
        path = tmp_path / scene
        assert path.exists(), f"{name} did not write {scene}\n{out}"
        check_iv(path)
    for xml_name in xml_names:
        path = tmp_path / xml_name
        assert path.exists(), f"{name} did not write {xml_name}\n{out}"
        check_xml(path)
    if name in READS_DATA:
        # The RANSAC estimates recover the truth the files were written from.
        errors = estimate_errors(name, out, reference_format_truth(DATA_SEED),
                                 xml_path=(tmp_path / xml_names[0]) if xml_names else None)
        for what, err, limit in errors:
            assert err < limit, f"{name}: {what} is off by {err} (limit {limit})\n{out}"


def test_showcase_sweeps_each_family_fused(monkeypatch, capsys):
    """The showcase's three sweeps take the fused path (the kernels' plain
    versions on the CPU): sphere3d, pivot, absolute_orientation, twice each."""
    from lsqrrecipes_tpu_torch.examples import fused_sweep_showcase
    from lsqrrecipes_tpu_torch.ops import fused_sweep as fs

    families, fused = [], fs.fused_sweep

    def spy(family, *args, **kw):
        families.append(family)
        return fused(family, *args, **kw)

    monkeypatch.setattr(fs, "fused_sweep", spy)
    assert fused_sweep_showcase.main(["--device", "cpu"]) == 0
    assert families == [f for f in ("sphere3d", "pivot", "absolute_orientation") for _ in "12"]
    assert "small budget" in capsys.readouterr().out


def test_sphere_estimation_counts_through_the_sphere_vote(monkeypatch, tmp_path, capsys):
    from lsqrrecipes_tpu_torch.examples import sphere_estimation
    from lsqrrecipes_tpu_torch.ops import vote

    calls, counts = [], vote.sphere_vote_counts

    def spy(params, *args, **kw):
        calls.append(params.dtype)
        return counts(params, *args, **kw)

    monkeypatch.setattr(vote, "sphere_vote_counts", spy)
    monkeypatch.chdir(tmp_path)
    assert sphere_estimation.main(["--device", "cpu"]) == 0
    assert calls and all(dt.is_floating_point for dt in calls)
    assert "float32 sphere vote of the estimate" in capsys.readouterr().out


@pytest.mark.parametrize("name", READS_DATA)
def test_data_example_without_data_does_nothing(name, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    module = importlib.import_module(f"lsqrrecipes_tpu_torch.examples.{name}")
    assert module.main(["--device", "cpu", "--data-dir", str(tmp_path / "missing")]) == 0
    assert "not mounted; nothing to do" in capsys.readouterr().out
    assert not list(tmp_path.iterdir())


def test_examples_default_to_cuda(tmp_path, monkeypatch, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    from lsqrrecipes_tpu_torch.examples import plane_estimation

    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        plane_estimation.main([])
    assert exc.value.code != 0
    assert "CUDA is not available" in capsys.readouterr().err


def _least_squares_reports(text):
    """The banner, every least-squares report and the reprojection distance
    lines of an example's output, as ``(banner, {label: values})``."""
    labels = [line[:-1] for line in text.splitlines()
              if line.endswith(":") and "least squares" in line.lower()]
    reports = {label: report_values(text, label) for label in labels}
    distances = [line for line in text.splitlines() if line.startswith("reprojection distance")]
    for i, line in enumerate(distances):
        # "reprojection distance mm: min A max B mean C"
        reports[f"reprojection distance {i}"] = np.array([float(v) for v in line.split()[4::2]])
    return text.splitlines()[0], reports


def _run_jax_example(name, data_dir, monkeypatch, capsys):
    """The JAX package's example ``examples/<name>.py`` in-process, reading
    ``data_dir`` in place of the reference checkout -> its output."""
    monkeypatch.syspath_prepend(str(JAX_EXAMPLES))
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  JAX_EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for const in ("REFERENCE_EXAMPLE_DATA", "REFERENCE_TESTING_DATA"):
        if hasattr(module, const):
            monkeypatch.setattr(module, const, str(data_dir))
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("name", READS_DATA)
def test_data_example_least_squares_equals_jax(name, tmp_path, monkeypatch, capsys):
    """On the same reference-format files, the port's example prints the JAX
    example's banner and its least-squares reports (and crosswire's
    reprojection distances), each number equal up to the printed rounding:
    1e-5 relative, one unit in the sixth significant digit."""
    data_dir = write_reference_format_data(tmp_path / "data", seed=DATA_SEED)
    monkeypatch.chdir(tmp_path)
    module = importlib.import_module(f"lsqrrecipes_tpu_torch.examples.{name}")
    assert module.main(["--device", "cpu", "--data-dir", str(data_dir)]) == 0
    port_banner, port = _least_squares_reports(capsys.readouterr().out)
    jax_banner, ref = _least_squares_reports(_run_jax_example(name, data_dir, monkeypatch, capsys))
    assert port_banner == jax_banner
    assert ref and sorted(port) == sorted(ref)
    for label, values in ref.items():
        np.testing.assert_allclose(port[label], values, rtol=1e-5, atol=1e-3 if "distance" in label
                                   else 1e-9, err_msg=label)


@pytest.mark.parametrize("name", READS_DATA)
def test_estimate_check_rejects_a_wrong_estimate(name):
    """The estimate check fails a report whose parameters are off: each
    value shifted by 3 (crosswire's angles by 0.05 rad, over 2 degrees)."""
    truth = reference_format_truth(DATA_SEED)
    if name == "crosswire_us_calibration":
        t = truth[name]
        good = np.concatenate([t["t1"], t["t3"], _angles(t["r3"]), [M_X, M_Y]])
        labels = ["RANSAC [t1, t3, w, m]"]
        bad = [good + np.r_[np.zeros(6), 0.05, 0.05, 0.05, 0.0, 0.0]]
    else:
        good = truth[name]
        labels = (["RANSAC [t_DRF, t_W]"] if name == "pivot_calibration"
                  else ["RANSAC (fixed budget) x", "RANSAC (adaptive) x"])
        bad = [good + 3.0]

    def text(x):
        return "".join(f"{label}:\n\t[ {', '.join(f'{v:.9g}' for v in x)} ]\n\n"
                       for label in labels)

    assert all(err < limit for _, err, limit in estimate_errors(name, text(good), truth))
    for x in bad:
        assert any(err >= limit for _, err, limit in estimate_errors(name, text(x), truth))


def _angles(r):
    """ZYX Euler angles ``(wz, wy, wx)`` of a rotation matrix."""
    return np.array([np.arctan2(r[1, 0], r[0, 0]), -np.arcsin(r[2, 0]),
                     np.arctan2(r[2, 1], r[2, 2])])


@pytest.mark.parametrize("name", READS_DATA)
def test_data_example_requires_a_data_dir(name, capsys):
    module = importlib.import_module(f"lsqrrecipes_tpu_torch.examples.{name}")
    with pytest.raises(SystemExit) as exc:
        module.main(["--device", "cpu"])
    assert exc.value.code == 2
    assert "--data-dir" in capsys.readouterr().err
