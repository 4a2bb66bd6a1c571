"""Shared helpers for the example programs, and the checks that hold
their artifacts and estimates (shared by the tests and ``chip_smoke.py``)."""

import argparse
import math
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np
import torch

from lsqrrecipes_tpu_torch.device import resolve_device
from lsqrrecipes_tpu_torch.estimators.us_calibration import _euler_zyx_matrix
from lsqrrecipes_tpu_torch.geometry import rotations
from lsqrrecipes_tpu_torch.synthetic import M_X, M_Y, make_crosswire_data

# Every example -> (the .iv scenes, the <precomputed_transform> XML files)
# it writes into the working directory.
EXAMPLE_ARTIFACTS = {
    "absolute_orientation": ([], []),
    "crosswire_us_calibration": ([], ["crosswireUSCalibration.xml"]),
    "fused_sweep_showcase": ([], []),
    "line_estimation": (["leastSquaresLineEstimation.iv", "RANSACLineEstimation.iv"], []),
    "linear_equation_system_solver": ([], []),
    "pivot_calibration": ([], []),
    "plane_estimation": (["RANSACPlaneEstimation.iv"], []),
    "plane_us_calibration": ([], ["planeUSCalibration.xml"]),
    "pointer_us_calibration": ([], ["pointerUSCalibration.xml"]),
    "ray_intersection_estimation": (["RANSACRayIntersection.iv"], []),
    "sphere_estimation": (["RANSACSphereEstimation.iv"], []),
}
# The examples that read the reference's data files (``--data-dir``).
READS_DATA = ("crosswire_us_calibration", "linear_equation_system_solver", "pivot_calibration")

# The truth of :func:`write_reference_format_data`'s pivot and linear files.
PIVOT_T_DRF = (10.0, -5.0, 2.0)
PIVOT_T_W = (100.0, 50.0, -30.0)
LINEAR_X = (1.5, -2.0, 0.5, 3.0, -1.0, 2.5)
# The limits the JAX package's tests hold these estimates to: pivot 0.1 and
# the dense system 0.05 per component (``tests/test_fused_sweep.py``'s fused
# drivers), crosswire 1 mm, 1 degree and 1.0 in scale
# (``tests/test_us_calibration.py``).
PIVOT_LIMIT = 0.1
LINEAR_LIMIT = 0.05
CROSSWIRE_LIMITS = {"translation": 1.0, "degrees": 1.0, "scale": 1.0}


def parse_args(description, argv=None, reads_data=False):
    """``--device`` (default ``cuda``) and, where ``reads_data``, the
    required ``--data-dir`` of the reference-format data files.  Returns
    ``(args, device)``; exits with status 2 when the device is CUDA and
    there is none."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    if reads_data:
        p.add_argument("--data-dir", required=True,
                       help="directory of the reference-format data files")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        p.error(str(exc))
    return args, dev


def generator(seed, device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (the JAX
    examples' ``PRNGKey(seed)``)."""
    return torch.Generator(device=device).manual_seed(seed)


def banner(title):
    print(title)
    print("-" * len(title))


def report(label, values):
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().reshape(-1).tolist()
    vals = ", ".join(f"{float(v):.6g}" for v in values)
    print(f"{label}:\n\t[ {vals} ]\n")


def _reference_crosswire(seed, n):
    gen = torch.Generator().manual_seed(seed)
    return make_crosswire_data(gen, n=n, sigma=0.5, device="cpu")


def write_reference_format_data(directory, seed=0, n=120, outlier_fraction=0.2):
    """Write the four files the data-reading examples read, in the
    reference's formats, from a seed: ``pivotCalibrationDataWithOutliers.txt``
    (``x y z qx qy qz qs`` about :data:`PIVOT_T_DRF`, :data:`PIVOT_T_W`,
    N(0, 0.05) noise), ``augmentedMatrixWithOutliers.txt`` (rows ``[a | b]``
    of :data:`LINEAR_X`, N(0, 0.05) noise), and
    ``crossWirePhantomTransformations.txt`` / ``crossWirePhantom2DPoints.txt``
    (:func:`lsqrrecipes_tpu_torch.synthetic.make_crosswire_data`, 0.5 px
    noise).  The last ``outlier_fraction`` of each set is corrupted: random
    poses, b shifted by U(5, 50), t2 shifted by U(30, 80) per axis.  For
    running those examples where the reference's own data is absent;
    :func:`reference_format_truth` gives what they should recover."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_out = int(round(n * outlier_fraction))

    def rows_text(rows):
        return "".join(" ".join(repr(float(v)) for v in row) + "\n" for row in rows)

    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    r = rotations.matrix_from_quaternion(torch.as_tensor(q)).numpy()
    t = np.array(PIVOT_T_W) - r @ np.array(PIVOT_T_DRF)
    t += 0.05 * rng.normal(size=(n, 3))
    t[n - n_out:] = rng.uniform(-200.0, 200.0, (n_out, 3))
    (directory / "pivotCalibrationDataWithOutliers.txt").write_text(
        rows_text(np.concatenate([t, q[:, 1:4], q[:, 0:1]], axis=1)))

    a = rng.uniform(-10.0, 10.0, (n, 6))
    b = a @ np.array(LINEAR_X) + 0.05 * rng.normal(size=n)
    b[n - n_out:] += rng.uniform(5.0, 50.0, n_out)
    (directory / "augmentedMatrixWithOutliers.txt").write_text(
        rows_text(np.concatenate([a, b[:, None]], axis=1)))

    (frames, q_px), _, _ = _reference_crosswire(seed, n)
    r2, t2 = frames.r.numpy(), frames.t.numpy().copy()
    t2[n - n_out:] += rng.uniform(30.0, 80.0, (n_out, 3))
    (directory / "crossWirePhantomTransformations.txt").write_text(
        rows_text(np.concatenate([r2, t2[:, :, None]], axis=2).reshape(-1, 4)))
    (directory / "crossWirePhantom2DPoints.txt").write_text(rows_text(q_px.numpy()))
    return directory


def reference_format_truth(seed=0, n=120):
    """What the data-reading examples should recover from
    :func:`write_reference_format_data`'s files of the same ``seed`` and
    ``n``: example name -> truth (pivot ``[t_DRF, t_W]`` and the linear
    system's ``x`` as float64 arrays; crosswire the generator's ``t1``,
    ``t3`` and ``r3``)."""
    _, _, truth = _reference_crosswire(seed, n)
    return {
        "pivot_calibration": np.array(PIVOT_T_DRF + PIVOT_T_W),
        "linear_equation_system_solver": np.array(LINEAR_X),
        "crosswire_us_calibration": {k: truth[k].numpy() for k in ("t1", "t3", "r3")},
    }


def report_values(text, label):
    """The numbers :func:`report` printed under ``label`` in ``text``, as a
    float64 array; raises ``ValueError`` when there is no such report."""
    lines = text.splitlines()
    for i, line in enumerate(lines[:-1]):
        if line == f"{label}:":
            body = lines[i + 1].strip()
            if body.startswith("[") and body.endswith("]"):
                return np.array([float(v) for v in body[1:-1].split(",")])
    raise ValueError(f"no report {label!r} in the output")


def _crosswire_errors(x, truth):
    r = _euler_zyx_matrix(*(torch.tensor(float(v), dtype=torch.float64) for v in x[6:9]))
    cos = (float(torch.trace(r.T @ torch.as_tensor(truth["r3"]))) - 1.0) / 2.0
    return {
        "translation": float(np.abs(np.concatenate([x[0:3] - truth["t1"],
                                                    x[3:6] - truth["t3"]])).max()),
        "degrees": math.degrees(math.acos(min(1.0, max(-1.0, cos)))),
        "scale": float(np.abs(x[9:11] - [M_X, M_Y]).max()),
    }


def _xml_matrix(path):
    transform = ET.parse(path).getroot().find("transformation")
    return np.array([[float(v) for v in row.split()]
                     for row in transform.text.strip().splitlines() if row.strip()])


def _crosswire_xml_errors(path, truth):
    """The written ``[m_x R3(:,0), m_y R3(:,1), R3(:,2) | t3]`` against the
    truth: t3 in mm, each column's direction in degrees, the two scales."""
    m = _xml_matrix(path)
    r3 = truth["r3"]
    cols = m[:, 0:3] / np.linalg.norm(m[:, 0:3], axis=0)
    cos = np.clip((cols * r3).sum(axis=0), -1.0, 1.0)
    return {
        "translation": float(np.abs(m[:, 3] - truth["t3"]).max()),
        "degrees": float(np.degrees(np.arccos(cos)).max()),
        "scale": float(np.abs(np.linalg.norm(m[:, 0:2], axis=0) - [M_X, M_Y]).max()),
    }


def estimate_errors(name, text, truth, xml_path=None):
    """The RANSAC estimates a data-reading example printed in ``text``,
    against ``truth`` (:func:`reference_format_truth`) -> a list of
    ``(what, error, limit)``; an estimate is right when every error is
    below its limit.  For crosswire, ``xml_path`` adds the written
    calibration matrix against the truth's at the same limits."""
    if name == "pivot_calibration":
        x = report_values(text, "RANSAC [t_DRF, t_W]")
        return [("RANSAC [t_DRF, t_W]", float(np.abs(x - truth[name]).max()), PIVOT_LIMIT)]
    if name == "linear_equation_system_solver":
        return [(label, float(np.abs(report_values(text, label) - truth[name]).max()),
                 LINEAR_LIMIT)
                for label in ("RANSAC (fixed budget) x", "RANSAC (adaptive) x")]
    if name == "crosswire_us_calibration":
        errs = _crosswire_errors(report_values(text, "RANSAC [t1, t3, w, m]"), truth[name])
        out = [(f"RANSAC [t1, t3, w, m] {k}", e, CROSSWIRE_LIMITS[k]) for k, e in errs.items()]
        if xml_path is not None:
            errs = _crosswire_xml_errors(xml_path, truth[name])
            out += [(f"{Path(xml_path).name} {k}", e, CROSSWIRE_LIMITS[k])
                    for k, e in errs.items()]
        return out
    raise ValueError(f"{name} reads no reference data")


def check_iv(path):
    """An OpenInventor scene as the reference's viewer needs it: the format
    header and balanced braces.  Raises ``ValueError`` otherwise."""
    text = Path(path).read_text()
    if not text.startswith("#Inventor"):
        raise ValueError(f"{path}: missing Inventor header")
    if not text.count("{") == text.count("}") > 0:
        raise ValueError(f"{path}: unbalanced braces")


def check_xml(path):
    """The reference's ``<precomputed_transform>`` result: one
    ``transformation`` with a float ``estimation_error`` and a 3 x 4 matrix
    of floats.  Raises ``ValueError`` otherwise."""
    root = ET.parse(path).getroot()
    transform = root.find("transformation")
    if root.tag != "precomputed_transform" or transform is None:
        raise ValueError(f"{path}: not a <precomputed_transform> with a transformation")
    float(transform.attrib["estimation_error"])
    rows = [r.split() for r in transform.text.strip().splitlines() if r.strip()]
    if len(rows) != 3 or any(len(r) != 4 for r in rows):
        raise ValueError(f"{path}: not a 3x4 transform")
    [float(v) for r in rows for v in r]
