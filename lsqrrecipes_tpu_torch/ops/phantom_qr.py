"""The plane phantom's f32 subspace stage (counterpart of
``lsqrrecipes_tpu/ops/phantom_qr.py``, the Pallas kernel B6).

For each hypothesis b of the k = 31 plane-phantom minimal fit it takes the
homogeneous 31x31 system in float32 and returns four unit vectors ``v[4,
31, B]`` whose span holds the system's null direction:

  * the Householder R factor of A itself (not of the normal matrix, which
    would square the conditioning), with the alpha / denominator guards of
    :func:`~lsqrrecipes_tpu_torch.linalg.small.qr_r_planar`;
  * the diagonal clamped at ``max(FLT_EPS max|d|, 1e-6)`` with its sign kept,
    so that exact-null and duplicate-row pivots stay finite;
  * two steps of block inverse iteration with ``(A^T A)^{-1} = R^{-1}
    R^{-T}`` (:func:`~lsqrrecipes_tpu_torch.linalg.small.solve_rt_r_planar`)
    on four fixed starts, each step followed by normalisation and
    Gram-Schmidt.

The f64 Rayleigh-Ritz that picks the null vector out of the span stays
outside (``ops/us_fast.py``), as in the JAX package.

Input layout: the systems are packed hypothesis-major by
:func:`pack_systems`, ``bands[B, 31, 32]``: column c of hypothesis b is the
contiguous 32-float band ``bands[b, c]``, rows 0-30 then a zero pad row, so
one warp of the kernel reads a column as 128 contiguous bytes.  The four
starts ``cos(0.7 r (q + 1)) + 0.1``, normalised, are one float32 table made
once on the host in numpy float64 (:func:`start_table`) and given to the
kernel and the plain version alike.

On CUDA tensors :func:`phantom_subspace` launches the hand-written kernel
(``csrc/phantom_qr.cu``, one warp per hypothesis); on CPU tensors it runs
:func:`phantom_subspace_plain`, the kernel's arithmetic in plain PyTorch:
every sum over the 31 rows is a :func:`~lsqrrecipes_tpu_torch.linalg.small.
rows_sum32`, the order of the kernel's shuffle butterfly, and every product,
sum, division and square root is its own correctly rounded operation, so on
the card the two agree bit for bit.  (On the CPU, PyTorch's float32
``sqrt`` is vectorised and not always correctly rounded, so there the plain
version may differ from the kernel's arithmetic in the last bit.)
"""

import ctypes
import functools

import numpy as np
import torch

from lsqrrecipes_tpu_torch import kernels
from lsqrrecipes_tpu_torch.linalg.small import (
    qr_r_planar,
    rows_sum32,
    rsqrt,
    scalar_like,
    solve_rt_r_planar,
)

N = 31           # unknowns of the homogeneous system, and rows of a sample
Q = 4            # subspace vectors
ITERS = 2        # inverse-iteration steps
ROWS = 32        # rows per column band (row 31 is zero)
FLT_EPS = 1.1920929e-07


@functools.lru_cache(maxsize=None)
def start_table() -> np.ndarray:
    """The four start vectors ``[4, 32]`` float32 (row 31 zero):
    ``cos(r (q + 1) 0.7) + 0.1`` over rows r, normalised in float64, then
    rounded (the JAX package's XLA stage, ``us_fast.py:456-463``)."""
    out = np.zeros((Q, ROWS), np.float32)
    for q in range(Q):
        c = np.cos(np.arange(N) * (q + 1) * 0.7) + 0.1
        out[q, :N] = (c / np.linalg.norm(c)).astype(np.float32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def _starts(device):
    """The start table on ``device``, copied there once (a copy per launch
    would wait for the stream)."""
    return torch.tensor(start_table(), device=device)


def pack_systems(a):
    """``a[31, 31, B]`` (rows, columns, hypotheses; any float dtype) ->
    ``bands[B, 31, 32]`` float32, hypothesis-major, the pad row zero."""
    if a.shape[:2] != (N, N):
        raise ValueError(f"a must be [31, 31, B], got {tuple(a.shape)}")
    bands = torch.zeros((a.shape[2], N, ROWS), dtype=torch.float32, device=a.device)
    bands[:, :, :N] = a.permute(2, 1, 0)
    return bands


def _check_bands(bands):
    if bands.ndim != 3 or bands.shape[1:] != (N, ROWS):
        raise ValueError(f"bands must be [B, 31, 32], got {tuple(bands.shape)}")
    if bands.dtype != torch.float32:
        raise ValueError(f"bands must be float32, got {bands.dtype}")


def _normalize(v):
    """``v * rsqrt(max(|v|^2, 1e-30))`` per vector of ``v[q, 31, B]``."""
    n2 = rows_sum32(v * v, dim=1)
    return v * rsqrt(torch.clamp_min(n2, 1e-30))


def phantom_subspace_plain(bands):
    """Plain PyTorch version of the kernel: ``bands[B, 31, 32]`` float32 ->
    ``v[4, 31, B]`` float32 (see the module docstring)."""
    _check_bands(bands)
    starts = _starts(bands.device)
    a = bands.permute(2, 1, 0)[:N]                       # [31 rows, 31 cols, B]
    r = qr_r_planar(a)
    idx = torch.arange(N, device=bands.device)
    d_raw = r[idx, idx]                                  # [31, B]
    amax = torch.amax(d_raw.abs(), dim=0, keepdim=True)
    floor = torch.clamp_min(scalar_like(FLT_EPS, amax) * amax, 1e-6)
    mag = torch.maximum(d_raw.abs(), floor)
    d = torch.where(d_raw < 0, -mag, mag)

    v = starts[:, :N, None].expand(Q, N, bands.shape[0])
    for _ in range(ITERS):
        v = _normalize(solve_rt_r_planar(r, d, v))
        ortho = []
        for q in range(Q):
            c = v[q : q + 1]
            for p in ortho:
                c = c - rows_sum32(p * c, dim=1) * p
            ortho.append(_normalize(c))
        v = torch.cat(ortho)
    return v


def phantom_subspace_cuda(bands):
    """Launch ``csrc/phantom_qr.cu`` on the current stream; same contract as
    :func:`phantom_subspace_plain`.  The kernel writes ``[B, 4, 32]``
    (hypothesis-major, the pad row 0); the result is its ``[4, 31, B]`` view.
    Raises on a non-CUDA or non-f32 input and when the build or the launch
    fails."""
    _check_bands(bands)
    starts = _starts(bands.device)
    bands = bands.contiguous()
    kernels.check_inputs(bands=bands, starts=starts)
    b = bands.shape[0]
    if b >= 2**31:
        raise ValueError("phantom_subspace supports fewer than 2^31 hypotheses")
    out = torch.empty((b, Q, ROWS), dtype=torch.float32, device=bands.device)
    if b:
        with torch.cuda.device(bands.device):
            stream = torch.cuda.current_stream().cuda_stream
            kernels.PHANTOM_QR.launch(bands.data_ptr(), starts.data_ptr(), ctypes.c_int(b),
                                      out.data_ptr(), stream)
    return out[:, :, :N].permute(1, 2, 0)


def phantom_subspace(bands):
    """``bands[B, 31, 32]`` float32 (:func:`pack_systems`) -> the
    inverse-iteration subspace ``v[4, 31, B]`` float32.  CUDA tensors launch
    the kernel, CPU tensors run :func:`phantom_subspace_plain`."""
    fn = phantom_subspace_cuda if bands.is_cuda else phantom_subspace_plain
    return fn(bands)
