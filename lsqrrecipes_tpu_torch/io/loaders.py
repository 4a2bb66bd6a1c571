"""Loaders for the reference's experimental data formats (counterpart of
``lsqrrecipes_tpu/io/loaders.py``).

File formats (the reference's ``testing/Data``):
  * ``pivotCalibrationData.txt``: one tracked pose per line as
    ``x y z qx qy qz qs`` (scalar-last quaternion; see the reader in
    ``testing/PivotCalibrationParametersEstimatorTest.cxx:23-34``).
  * ``augmentedMatrix.txt``: whitespace-separated rows ``[a_0..a_{n-1} b]``.
  * ``crossWirePhantomTransformations.txt``: 3 lines per frame, each line
    ``r0 r1 r2 t`` (a row of ``[R | t]``); paired with
    ``crossWirePhantom2DPoints.txt``: ``u v`` per line
    (``testing/SinglePointTargetUSCalibrationParametersEstimatorTest.cxx:115-166``).

Parsing is numpy's.  Arrays come back as numpy where the JAX loaders return
numpy, and frames as a :class:`Frame` of float64 tensors on the resolved
device (default CUDA; raises without it).
"""

import numpy as np
import torch

from lsqrrecipes_tpu_torch.device import resolve_device
from lsqrrecipes_tpu_torch.geometry.frame import Frame


def _parse_floats(path):
    with open(path) as f:
        return np.array(f.read().split(), dtype=np.float64)


def _f64(arr, dev):
    return torch.as_tensor(np.ascontiguousarray(arr), dtype=torch.float64, device=dev)


def load_augmented_matrix(path, n_cols):
    """-> float64 numpy ``[rows, n_cols]`` (last column is b)."""
    return _parse_floats(path).reshape(-1, n_cols)


def load_tracked_frames(path, device=None):
    """Pivot-calibration format ``x y z qx qy qz qs`` -> batched Frame."""
    dev = resolve_device(device)
    rows = _parse_floats(path).reshape(-1, 7)
    # Reorder to scalar-first [s, qx, qy, qz].
    q = np.concatenate([rows[:, 6:7], rows[:, 3:6]], axis=1)
    return Frame.from_quaternion(_f64(q, dev), _f64(rows[:, :3], dev))


def load_crosswire_phantom(transforms_path, points_path, device=None):
    """-> ``(Frame[n], points2d[n, 2])`` for the crosswire US data; the
    points as float64 numpy, as the JAX loader returns them."""
    dev = resolve_device(device)
    rows = _parse_floats(transforms_path).reshape(-1, 3, 4)
    frames = Frame(_f64(rows[:, :, :3], dev), _f64(rows[:, :, 3], dev))
    pts = _parse_floats(points_path).reshape(-1, 2)
    return frames, pts
