"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface (one launch symbol per
kernel; several kernels may share a source) and is compiled by ``nvcc`` for
``sm_90a`` into one shared library, called through ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Builds happen at first use, from the
sources in this package only, into ``build/kernels/`` beside the package; a
library's file name carries a hash of its source, of every ``csrc/*.cuh``
header and of the flags, so a stale build is never loaded.  Nothing here
runs at import time.

Every :class:`Kernel` keeps ``launches``, a plain count that its wrapper
raises by one per launch, so a run can show that it went through the kernel.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# No --use_fast_math: it changes sqrtf/division rounding and flushes
# denormals, and both kernels are held against f32 plain versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``.  Raises ``FileNotFoundError`` if none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.access(path, os.X_OK):
            return path
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def check_inputs(dtypes=(torch.float32,), **tensors) -> None:
    """Raise ``ValueError`` unless every tensor is a contiguous CUDA tensor
    of one of ``dtypes`` (float32 alone, what every kernel here but the
    crosswire residual's and the phantom's Rayleigh-Ritz takes)."""
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype not in dtypes:
            allowed = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise ValueError(f"{name} must be {allowed}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class Kernel:
    """One ``.cu`` source, its built library and its launch count.

    ``symbol`` is the C launch function: it returns ``cudaGetLastError()``
    (0 on success) after enqueueing on the stream it is given.
    """

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._lib = None

    def library_path(self) -> Path:
        """``build/kernels/<source stem>-<hash>.so``; the hash covers the
        source, the headers beside it and the flags."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start ``nvcc`` unless the library exists; returns
        ``(process, temporary output)`` or None.  Finish with
        :meth:`finish_build`."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        return proc, tmp

    def finish_build(self, started) -> None:
        """Wait for a build from :meth:`start_build`; raise if it failed."""
        if started is None:
            return
        proc, tmp = started
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{self.build_log}")
        os.replace(tmp, self.library_path())

    def load(self):
        """The C launch function, building the library first if needed."""
        if self._fn is None:
            self.finish_build(self.start_build())
            self._lib = ctypes.CDLL(str(self.library_path()))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = self._lib.lsq_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the C launch function; raise on a nonzero CUDA error, else
        count the launch."""
        code = self.load()(*args)
        if code != 0:
            msg = self._lib.lsq_cuda_error_string(code).decode()
            raise RuntimeError(f"{self.name} launch failed: CUDA error {code} ({msg})")
        self.launches += 1

    def shape(self, num_hyp: int, query: str = "shape") -> dict:
        """The launch shape at ``num_hyp`` hypotheses on the current device,
        from the source's ``<name>_<query>`` query (the redesigned kernels
        have ``<name>_shape``; the ultrasound sweeps' fit kernels
        ``<name>_fit_shape``; B5's "hypotheses" are its problems):
        registers and spill bytes per thread, threads and hypotheses per
        block, blocks, resident blocks per SM, and waves = blocks / (blocks
        per SM x SMs)."""
        self.load()
        query = getattr(self._lib, self.symbol.replace("_launch", f"_{query}"))
        query.argtypes = [ctypes.c_int, _P]
        query.restype = ctypes.c_int
        out = (ctypes.c_int * 6)()
        code = query(int(num_hyp), ctypes.cast(out, _P))
        if code != 0:
            msg = self._lib.lsq_cuda_error_string(code).decode()
            raise RuntimeError(f"{self.name} shape query failed: CUDA error {code} ({msg})")
        keys = ("registers", "spill_bytes", "threads", "hyp_per_block", "blocks", "blocks_per_sm")
        shape = dict(zip(keys, out))
        sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
        shape["waves"] = shape["blocks"] / (max(1, shape["blocks_per_sm"]) * sms)
        return shape


SPHERE_VOTE = Kernel(
    "sphere_vote", "sphere_vote.cu", "sphere_vote_launch",
    # params, points_t, valid, n_pad, num_hyp, delta, counts, stream
    [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P, _P],
)

FUSED_SWEEP_SPHERE3D = Kernel(
    "fused_sweep_sphere3d", "fused_sweep_sphere3d.cu", "fused_sweep_sphere3d_launch",
    # coords, coords_stride, p, p_stride, vote_cols, n_fit, num_groups,
    # b, m, mask, delta, best_key, best_out, best_index, stream
    [_P, ctypes.c_longlong, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
     ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
     ctypes.c_float, _P, _P, _P, _P],
)

# The three point families of csrc/fused_sweep_points.cu share one library.
_POINT_SWEEP_ARGS = [
    # coords, coords_stride, p, p_stride, vote_cols, n_fit, num_groups,
    # b, m, mask, inv_delta, delta_sq, best_key, best_out, best_index, stream
    _P, ctypes.c_longlong, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
    ctypes.c_float, ctypes.c_float, _P, _P, _P, _P,
]

FUSED_SWEEP_PLANE3D = Kernel(
    "fused_sweep_plane3d", "fused_sweep_points.cu", "fused_sweep_plane3d_launch",
    _POINT_SWEEP_ARGS,
)

FUSED_SWEEP_LINE3D = Kernel(
    "fused_sweep_line3d", "fused_sweep_points.cu", "fused_sweep_line3d_launch",
    _POINT_SWEEP_ARGS,
)

FUSED_SWEEP_LINE2D = Kernel(
    "fused_sweep_line2d", "fused_sweep_points.cu", "fused_sweep_line2d_launch",
    _POINT_SWEEP_ARGS,
)

PLANE_VOTE = Kernel(
    "plane_vote", "plane_vote.cu", "plane_vote_launch",
    # params, points_t, valid, dim, n_pad, num_hyp, delta_sq, counts, stream
    [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P, _P],
)

# The four rigid-body and linear-system families of csrc/fused_sweep_rigid.cu
# share one library and one signature (the ultrasound families below reuse it).
_RIGID_SWEEP_ARGS = [
    # coords, coords_stride, p, p_stride, vote_cols, n_fit, num_groups,
    # b, m, mask, delta, delta_sq, cross_eps, best_key, best_out, best_index,
    # stream
    _P, ctypes.c_longlong, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
    ctypes.c_float, ctypes.c_float, ctypes.c_float, _P, _P, _P, _P,
]

RIGID_FAMILIES = ("pivot", "absolute_orientation", "ray3d", "dense_linear6")

_RIGID_SWEEPS = {
    family: Kernel(f"fused_sweep_{family}", "fused_sweep_rigid.cu",
                   f"fused_sweep_{family}_launch", _RIGID_SWEEP_ARGS)
    for family in RIGID_FAMILIES
}

# The crosswire and calibrated-pointer ultrasound sweeps of
# csrc/fused_sweep_us.cu: one library, the rigid families' signature plus
# the workspace f32[rows, chunk] and chunk before the stream (each sweep runs
# a fit and a vote kernel per chunk of hypotheses).
US_FAMILIES = ("crosswire", "pointer")

_US_SWEEPS = {
    family: Kernel(f"fused_sweep_{family}", "fused_sweep_us.cu", f"fused_sweep_{family}_launch",
                   _RIGID_SWEEP_ARGS[:-1] + [_P, ctypes.c_int, _P])
    for family in US_FAMILIES
}

FUSED_SWEEPS = {
    "sphere3d": FUSED_SWEEP_SPHERE3D,
    "plane3d": FUSED_SWEEP_PLANE3D,
    "line3d": FUSED_SWEEP_LINE3D,
    "line2d": FUSED_SWEEP_LINE2D,
    **_RIGID_SWEEPS,
    **_US_SWEEPS,
}

SPHERE_LM = Kernel(
    "sphere_lm", "sphere_lm.cu", "sphere_lm_launch",
    # points, x0, num_problems, m, max_iters, init_lambda, max_lambda, gtol,
    # out, stream
    [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
     ctypes.c_float, _P, _P],
)

# The per-step sphere sweep and the planar fit-and-vote of
# csrc/sphere_ransac.cu share one library.
SPHERE_MEGA = Kernel(
    "sphere_mega", "sphere_ransac.cu", "sphere_mega_launch",
    # shifts, coords2, points_t, valid, n, n_pad, num_groups, delta, counts,
    # params_t, stream
    [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P, _P, _P],
)

SPHERE_PLANAR_VOTE = Kernel(
    "sphere_planar_vote", "sphere_ransac.cu", "sphere_planar_vote_launch",
    # sxyz, points_t, valid, num_hyp, n_pad, delta, counts, params_t, stream
    [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P, _P, _P],
)

# The plane phantom's f32 QR + inverse-iteration subspace (one warp per
# hypothesis).
PHANTOM_QR = Kernel(
    "phantom_qr", "phantom_qr.cu", "phantom_qr_launch",
    # bands, starts, num_hyp, out, stream
    [_P, _P, ctypes.c_int, _P, _P],
)

# The plane phantom's Rayleigh-Ritz, rank gate and reconstruction after B6,
# in float32 or float64 (one thread per hypothesis, the dtype a flag).
PHANTOM_RITZ = Kernel(
    "phantom_ritz", "phantom_ritz.cu", "phantom_ritz_launch",
    # a, v, num_hyp, is_double, shift_coef, tiny, rank_coef, half_pi,
    # small_angle, p0, params, valid, stream
    [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
     ctypes.c_double, ctypes.c_double, ctypes.c_float, _P, _P, _P],
)

# The crosswire calibration's residual and Jacobian for the LM refit, in
# float32 or float64 (one library, the dtype a flag).
US_CROSSWIRE = Kernel(
    "us_crosswire_residual", "us_residual.cu", "us_crosswire_launch",
    # x, r2, t2, q, num_problems, n, is_double, res, jac, stream
    [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P],
)

ALL = (FUSED_SWEEP_SPHERE3D, SPHERE_VOTE, FUSED_SWEEP_PLANE3D, FUSED_SWEEP_LINE3D,
       FUSED_SWEEP_LINE2D, PLANE_VOTE, *_RIGID_SWEEPS.values(), *_US_SWEEPS.values(),
       SPHERE_LM, SPHERE_MEGA, SPHERE_PLANAR_VOTE, PHANTOM_QR, PHANTOM_RITZ,
       US_CROSSWIRE)


def build_all(kernels=ALL) -> None:
    """Build every kernel's library, one ``nvcc`` per source, all started
    together, then load them."""
    started, seen = [], set()
    for k in kernels:
        path = k.library_path()
        if path not in seen:          # kernels that share a source share a build
            seen.add(path)
            started.append((k, k.start_build()))
    errors = []
    for k, build in started:      # wait for every build before raising
        try:
            k.finish_build(build)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in kernels:
        k.load()


def reset_launch_counts(kernels=ALL) -> None:
    for k in kernels:
        k.launches = 0


def launch_counts(kernels=ALL) -> dict:
    return {k.name: k.launches for k in kernels}
