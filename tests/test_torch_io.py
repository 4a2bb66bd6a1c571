"""Port parity: ``lsqrrecipes_tpu_torch.io`` vs ``lsqrrecipes_tpu.io``.

Reference-format files written from a numpy seed are loaded by both
packages: the arrays must be equal and each ``Frame``'s R and t agree to
1e-15 (the same float64 quaternion formula in two libraries).  The XML
result writer must give identical bytes from tensors and from numpy, with
the clock pinned.
"""

import time

import numpy as np
import pytest
import torch

from lsqrrecipes_tpu import io as jio
from lsqrrecipes_tpu.io import xml_out as jxml
from lsqrrecipes_tpu_torch import io as tio
from lsqrrecipes_tpu_torch.examples.common import write_reference_format_data
from lsqrrecipes_tpu_torch.io import xml_out as txml

FRAME_TOL = 1e-15


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_reference_format_data(tmp_path_factory.mktemp("reference_data"), seed=4, n=50)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _frames_close(got, want):
    for g, w in ((got.r, want.r), (got.t, want.t)):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float64
        assert g.device.type == "cpu"
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=FRAME_TOL)


def test_augmented_matrix_equals_jax(data_dir):
    path = data_dir / "augmentedMatrixWithOutliers.txt"
    got = tio.load_augmented_matrix(path, 7)
    want = jio.load_augmented_matrix(path, 7)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64 and got.shape == (50, 7)
    np.testing.assert_array_equal(got, want)


def test_tracked_frames_equal_jax(data_dir):
    path = data_dir / "pivotCalibrationDataWithOutliers.txt"
    got = tio.load_tracked_frames(path, device="cpu")
    assert got.r.shape == (50, 3, 3)
    _frames_close(got, jio.load_tracked_frames(path))


def test_crosswire_phantom_equals_jax(data_dir):
    paths = (data_dir / "crossWirePhantomTransformations.txt",
             data_dir / "crossWirePhantom2DPoints.txt")
    frames, pts = tio.load_crosswire_phantom(*paths, device="cpu")
    jframes, jpts = jio.load_crosswire_phantom(*paths)
    assert isinstance(pts, np.ndarray) and pts.shape == (50, 2)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(frames.r.numpy(), np.asarray(jframes.r))
    np.testing.assert_array_equal(frames.t.numpy(), np.asarray(jframes.t))


def test_loaders_default_to_cuda(data_dir):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tio.load_tracked_frames(data_dir / "pivotCalibrationDataWithOutliers.txt")


def _transform(seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(3, 4)) * 50.0, float(rng.uniform(0.1, 2.0))


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_precomputed_transform_bytes_equal_jax(tmp_path, monkeypatch, as_tensor):
    monkeypatch.setattr(time, "strftime", lambda fmt: "2024 Jan 02 03:04:05")
    transform, err = _transform(9)
    jxml.write_precomputed_transform(tmp_path / "jax.xml", "US calibration - test", transform, err)
    arg = torch.as_tensor(transform) if as_tensor else transform
    e = torch.tensor(err, dtype=torch.float64) if as_tensor else err
    txml.write_precomputed_transform(tmp_path / "port.xml", "US calibration - test", arg, e)
    assert (tmp_path / "port.xml").read_bytes() == (tmp_path / "jax.xml").read_bytes()
    assert b"2024 Jan 02 03:04:05" in (tmp_path / "port.xml").read_bytes()


def test_calibration_transform_from_params_equals_jax():
    rng = np.random.default_rng(12)
    t3, c1, c2, c3 = (rng.normal(size=3) for _ in range(4))
    want = jxml.calibration_transform_from_params(t3, c1, c2, c3)
    got = txml.calibration_transform_from_params(*(torch.as_tensor(v) for v in (t3, c1, c2, c3)))
    assert got == want == txml.calibration_transform_from_params(t3, c1, c2, c3)
    with pytest.raises(ValueError, match="3x4"):
        txml.write_precomputed_transform("unused.xml", "d", [[0.0] * 4] * 2, 0.0)
