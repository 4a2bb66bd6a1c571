"""The port's kernel build/loader and its CUDA kernels.

The loader tests run on the CPU with fakes in place of ``nvcc`` and the
built library.  The ``cuda``-marked tests need a card and skip without one;
this file imports neither JAX nor the JAX package, so on a machine with the
card and no JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from lsqrrecipes_tpu_torch import kernels
from lsqrrecipes_tpu_torch.device import as_tensor
from lsqrrecipes_tpu_torch.estimators import ALGEBRAIC, LineEstimator, SphereEstimator
from lsqrrecipes_tpu_torch.geometry import Frame, Ray3D, rotations
from lsqrrecipes_tpu_torch.ops import fused_sweep as fs
from lsqrrecipes_tpu_torch.ops import phantom_qr, sphere_lm, sphere_ransac, us_fast, vote
from lsqrrecipes_tpu_torch.tree import tree_map

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def fake_kernel(monkeypatch):
    """A Kernel whose C launch function is a Python fake returning ``codes``."""
    kernel = kernels.Kernel("fake", "sphere_vote.cu", "fake_launch", [])
    codes = []

    class Lib:
        @staticmethod
        def lsq_cuda_error_string(code):
            return b"fake error"

    def load():
        kernel._lib = Lib
        return lambda *args: codes.pop(0)

    monkeypatch.setattr(kernel, "load", load)
    return kernel, codes


def _cloud(seed, n):
    rng = np.random.default_rng(seed)
    n_in = n * 4 // 5
    d = rng.normal(size=(n_in, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inl = np.array([5.0, -2.0, 11.0]) + 25.0 * d + 0.3 * rng.normal(size=(n_in, 3))
    out = rng.uniform(-40.0, 40.0, size=(n - n_in, 3))
    return np.concatenate([inl, out]).astype(np.float32)


# ------------------------------------------------------------------ loader


def test_every_kernel_source_exists_and_names_what_it_replaces():
    for k in kernels.ALL:
        text = k.source.read_text()
        # The crosswire residual's kernel and the phantom's Rayleigh-Ritz have
        # no TPU kernel to name: XLA fuses the JAX package's jacfwd and its
        # Rayleigh-Ritz tail.
        assert ("Replaces no TPU kernel." if k in (kernels.US_CROSSWIRE, kernels.PHANTOM_RITZ)
                else "Replaces lsqrrecipes_tpu/ops/") in text
        assert f'extern "C" int {k.symbol}(' in text
        assert "lsq_cuda_error_string" in text


def test_library_path_is_keyed_by_source_and_flags(monkeypatch):
    k = kernels.SPHERE_VOTE
    path = k.library_path()
    assert path.parent == kernels.BUILD_DIR and path.name.startswith("sphere_vote-")
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-lineinfo",))
    assert k.library_path() != path
    assert "--use_fast_math" not in kernels.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_library_path_changes_with_a_header(tmp_path):
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// v1\n")
    k = kernels.Kernel("k", "k.cu", "k_launch", [])
    k.source = tmp_path / "k.cu"
    first = k.library_path()
    (tmp_path / "notes.txt").write_text("not a header")
    assert k.library_path() == first
    header.write_text("// v2\n")
    second = k.library_path()
    assert second != first and second.name.startswith("k-")
    (tmp_path / "other.cuh").write_text("// another header\n")
    assert k.library_path() not in (first, second)


def test_point_sweeps_share_one_source_and_build():
    sweeps = [kernels.FUSED_SWEEPS[f] for f in ("plane3d", "line3d", "line2d")]
    assert {k.source.name for k in sweeps} == {"fused_sweep_points.cu"}
    assert len({k.library_path() for k in sweeps}) == 1
    assert len({k.symbol for k in sweeps}) == 3
    assert kernels.FUSED_SWEEPS["sphere3d"] is kernels.FUSED_SWEEP_SPHERE3D
    assert set(kernels.ALL) == set(kernels.FUSED_SWEEPS.values()) | {
        kernels.SPHERE_VOTE, kernels.PLANE_VOTE, kernels.SPHERE_LM, kernels.SPHERE_MEGA,
        kernels.SPHERE_PLANAR_VOTE, kernels.PHANTOM_QR, kernels.PHANTOM_RITZ,
        kernels.US_CROSSWIRE}


def test_rigid_sweeps_share_one_source_and_build():
    sweeps = [kernels.FUSED_SWEEPS[f] for f in kernels.RIGID_FAMILIES]
    assert {k.source.name for k in sweeps} == {"fused_sweep_rigid.cu"}
    assert len({k.library_path() for k in sweeps}) == 1
    assert [k.symbol for k in sweeps] == [f"fused_sweep_{f}_launch" for f in kernels.RIGID_FAMILIES]
    assert set(kernels.RIGID_FAMILIES) <= set(fs._FAMILIES)


def test_us_sweeps_share_one_source_and_build():
    sweeps = [kernels.FUSED_SWEEPS[f] for f in kernels.US_FAMILIES]
    assert {k.source.name for k in sweeps} == {"fused_sweep_us.cu"}
    assert len({k.library_path() for k in sweeps}) == 1
    assert [k.symbol for k in sweeps] == [f"fused_sweep_{f}_launch" for f in kernels.US_FAMILIES]
    # Both take the rigid families' arguments plus their workspace and chunk
    # (a fit and a vote kernel per chunk) before the stream.
    rigid = kernels.FUSED_SWEEPS["pivot"].argtypes
    for family in kernels.US_FAMILIES:
        assert kernels.FUSED_SWEEPS[family].argtypes == rigid[:-1] + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    assert set(kernels.US_FAMILIES) <= set(fs._FAMILIES)
    assert len(kernels.ALL) == 18 and len({k.source for k in kernels.ALL}) == 11


def test_sphere_step_kernels_share_one_source_and_build():
    pair = (kernels.SPHERE_MEGA, kernels.SPHERE_PLANAR_VOTE)
    assert {k.source.name for k in pair} == {"sphere_ransac.cu"}
    assert len({k.library_path() for k in pair}) == 1
    assert [k.symbol for k in pair] == ["sphere_mega_launch", "sphere_planar_vote_launch"]
    assert kernels.SPHERE_LM.source.name == "sphere_lm.cu"
    # Every sphere kernel with a fit shares the circumsphere header.
    for name in ("fused_sweep_sphere3d.cu", "sphere_ransac.cu"):
        assert '#include "sphere_fit.cuh"' in (kernels.CSRC_DIR / name).read_text()


def test_phantom_kernel_has_its_own_source_and_launch_symbol():
    k = kernels.PHANTOM_QR
    assert k.source.name == "phantom_qr.cu" and k.symbol == "phantom_qr_launch"
    assert "Replaces lsqrrecipes_tpu/ops/phantom_qr.py::_make_kernel" in k.source.read_text()
    assert k.library_path() not in {o.library_path() for o in kernels.ALL if o is not k}


def test_phantom_ritz_kernel_has_its_own_source_and_launch_symbol():
    k = kernels.PHANTOM_RITZ
    text = k.source.read_text()
    assert k.source.name == "phantom_ritz.cu" and k.symbol == "phantom_ritz_launch"
    assert "lsqrrecipes_tpu_torch/ops/us_fast.py::phantom_ritz_plain" in text
    assert k.library_path() not in {o.library_path() for o in kernels.ALL if o is not k}
    # The benchmark's B6 roofline matches device operations by B6's kernel
    # name, so this kernel's names must not contain it.
    assert "phantom_qr" not in text.replace("phantom_qr_launch", "")
    assert "__global__ void __launch_bounds__(kThreads)\nphantom_ritz_kernel(" in text
    # Rounded operations only: no FMA, and no tensor made from a Python number.
    assert "fma" not in text
    assert [t.__name__ for t in k.argtypes].count("c_double") == 5


_SPLIT_LAYOUT = "constexpr int kSplitHypPerThread = 4;"   # sweep_common.cuh

# kernel: (the layout constant, whether its source holds FMAs).  B2, the
# sphere3d, line3d, crosswire, pointer, dense_linear6 and
# absolute_orientation sweeps fuse their votes into FMAs (their plain
# versions round each one as CUDA does); B4 keeps separate multiplies and
# adds, as JAX's counts.
_REDESIGNED = {
    "phantom_qr": ("constexpr int kGroup = 16;", None),
    "sphere_mega": ("constexpr int kMegaHypPerThread = 4;", None),
    "sphere_vote": ("constexpr int kHypPerThread = 4;", True),
    "plane_vote": ("constexpr int kHypPerThread = 4;", False),
    "fused_sweep_sphere3d": ("constexpr int kSphereHypPerThread = 8;", True),
    "fused_sweep_line3d": (_SPLIT_LAYOUT, True),
    "fused_sweep_crosswire": (_SPLIT_LAYOUT, True),
    "fused_sweep_pointer": (_SPLIT_LAYOUT, True),
    "fused_sweep_dense_linear6": ("split_sweep_kernel<DenseLinear6>", True),
    "fused_sweep_absolute_orientation": ("split_sweep_kernel<AbsoluteOrientation>", True),
    "fused_sweep_pivot": ("split_sweep_kernel<Pivot>", True),
    "fused_sweep_ray3d": ("split_sweep_kernel<Ray3D>", True),
    "sphere_lm": ("constexpr int kLanes = 16;", None),
    "sphere_planar_vote": ("constexpr int kPlanarHypPerThread = 8;", True),
    "us_crosswire_residual": ("constexpr int kThreads = 128;", None),
    "phantom_ritz": ("constexpr int kThreads = 32;", False),
}


@pytest.mark.parametrize("name", list(_REDESIGNED))
def test_redesigned_kernels_declare_a_shape_query(name):
    # Kernel.shape reads registers, block shape and blocks per SM through
    # <name>_shape beside <name>_launch; the layouts are fixed constants.
    k = {k.name: k for k in kernels.ALL}[name]
    text = k.source.read_text()
    assert f'extern "C" int {k.symbol.replace("_launch", "_shape")}(int num_hyp' in text
    assert "#ifndef" not in text
    layout, fused = _REDESIGNED[name]
    if layout == _SPLIT_LAYOUT:
        assert "lsq_sweep::kSplitHypPerBlock" in text
        text = (kernels.CSRC_DIR / "sweep_common.cuh").read_text() + text
    assert layout in text
    if fused is not None:
        assert ("__fmaf_rn" in text) == fused
    if name in ("fused_sweep_crosswire", "fused_sweep_pointer"):   # fit kernels: a query each
        assert f'extern "C" int {name}_fit_shape(int num_hyp' in text


def test_nvcc_path_raises_when_missing(monkeypatch):
    monkeypatch.setattr(kernels.os, "access", lambda *a: False)
    with pytest.raises(FileNotFoundError, match="nvcc"):
        kernels.nvcc_path()


def test_launch_counts_only_successful_launches(fake_kernel):
    kernel, codes = fake_kernel
    codes.extend([0, 0, 209])
    kernel.launch()
    kernel.launch()
    assert kernel.launches == 2
    with pytest.raises(RuntimeError, match="CUDA error 209"):
        kernel.launch()
    assert kernel.launches == 2


def test_reset_and_read_launch_counts():
    kernels.SPHERE_VOTE.launches = 3
    assert kernels.launch_counts()["sphere_vote"] == 3
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}


def test_build_all_waits_for_every_build_before_raising(monkeypatch):
    finished = []

    def finish(self, started):
        finished.append(self.name)
        if self.name == "fused_sweep_sphere3d":
            raise RuntimeError("nvcc failed for fused_sweep_sphere3d")

    monkeypatch.setattr(kernels.Kernel, "start_build", lambda self: None)
    monkeypatch.setattr(kernels.Kernel, "finish_build", finish)
    with pytest.raises(RuntimeError, match="fused_sweep_sphere3d"):
        kernels.build_all()
    # One build per source: the three point sweeps share fused_sweep_points.cu,
    # the four rigid sweeps fused_sweep_rigid.cu, the two ultrasound sweeps
    # fused_sweep_us.cu and the two per-step sphere kernels sphere_ransac.cu.
    assert finished == ["fused_sweep_sphere3d", "sphere_vote", "fused_sweep_plane3d",
                        "plane_vote", "fused_sweep_pivot", "fused_sweep_crosswire",
                        "sphere_lm", "sphere_mega", "phantom_qr", "phantom_ritz",
                        "us_crosswire_residual"]


# ------------------------------------------------------- on the card only


@pytest.mark.cuda
def test_vote_kernel_equals_plain_on_card(cuda_device):
    pts = torch.as_tensor(_cloud(13, 1000), device=cuda_device)
    rng = np.random.default_rng(14)
    params = np.concatenate([rng.uniform(-20, 30, (65536, 3)), rng.uniform(1, 45, (65536, 1))], 1)
    params = torch.as_tensor(params.astype(np.float32), device=cuda_device)
    tt, vt, _ = vote.pack_points(pts)
    before = kernels.SPHERE_VOTE.launches
    got = vote.sphere_vote_counts(params, tt, vt, 1.0)
    plain = vote.sphere_vote_counts_plain(params, tt, vt, 1.0)
    assert kernels.SPHERE_VOTE.launches == before + 1
    assert torch.equal(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("n,gps,subsample", [(1024, 1, 0), (1000, 4, 0), (1024, 1, 512)])
def test_sweep_kernel_matches_plain_on_card(cuda_device, n, gps, subsample):
    pts = torch.as_tensor(_cloud(10 + n + gps, n), device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(gps)
    coords, p, nf, cols = fs.sweep_inputs("sphere3d", pts, gen, subsample)
    groups = -(-63 // gps) * gps
    before = kernels.FUSED_SWEEP_SPHERE3D.launches
    kc, kp, ki = fs.sweep("sphere3d", coords, p, nf, groups, cols, 1.0)
    pc, pp, pi = fs.sweep_plain("sphere3d", coords, p, nf, groups, cols, 1.0)
    assert kernels.FUSED_SWEEP_SPHERE3D.launches == before + 1
    assert int(kc) == int(pc) and int(ki) == int(pi) and torch.equal(kp, pp)


@pytest.mark.cuda
@pytest.mark.parametrize("n,groups,vote_cols", [(1024, 63, 1), (1000, 5, 300), (1000, 3, 1000),
                                                (4096, 1, 2049), (200, 7, 256)])
def test_sphere3d_kernel_ragged_shapes_equal_plain_on_card(cuda_device, n, groups, vote_cols):
    # vote_cols 1, 300, 1,000 and past one 2,048-point tile; n = 200 votes
    # on its 56 padding columns too.
    pts = torch.as_tensor(_cloud(30 + n, n), device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(n + groups)
    coords, p, nf, _ = fs.sweep_inputs("sphere3d", pts, gen)
    kc, kp, ki = fs.sweep_cuda("sphere3d", coords, p, nf, groups, vote_cols, 1.0)
    pc, pp, pi = fs.sweep_plain("sphere3d", coords, p, nf, groups, vote_cols, 1.0)
    assert int(kc) == int(pc) and int(ki) == int(pi) and torch.equal(kp, pp)


@pytest.mark.cuda
def test_sphere3d_kernel_pad_columns_never_vote_on_card(cuda_device):
    # 200 points on a sphere through the origin, with the padding columns'
    # 1e30 guard replaced by their true |p|^2 = 0: the 56 zero columns lie on
    # the sphere, and the kernel stages them as NaN.
    d = np.random.default_rng(31).normal(size=(200, 3))
    centre = np.array([6.0, -2.0, 3.0])                       # radius |centre| = 7
    pts = torch.as_tensor((centre + 7.0 * d / np.linalg.norm(d, axis=1, keepdims=True))
                          .astype(np.float32), device=cuda_device)
    coords, p, nf, cols = fs.sweep_inputs("sphere3d", pts,
                                          torch.Generator(device=cuda_device).manual_seed(1))
    p[4, 200:] = 0.0
    kc, kp, ki = fs.sweep_cuda("sphere3d", coords, p, nf, 4, cols, 1.0)
    pc, pp, pi = fs.sweep_plain("sphere3d", coords, p, nf, 4, cols, 1.0)
    assert int(kc) == int(pc) == 200 and int(ki) == int(pi) and torch.equal(kp, pp)


def _family_cloud(family, seed, n):
    """80% inliers (N(0, 0.2) noise) on a plane / 3D line / 2D line, 20%
    uniform outliers in [-40, 40]^d, f32."""
    rng = np.random.default_rng(seed)
    dim = fs._FAMILIES[family][4]
    n_in = n - n // 5
    base = rng.uniform(-30, 30, (n_in, dim))
    if family == "plane3d":
        base[:, 2] = 4.0 + 0.5 * base[:, 0] - 0.2 * base[:, 1]
    else:
        u = np.ones(dim) / np.sqrt(dim)
        base = np.outer(rng.uniform(-40, 40, n_in), u)
    inl = base + 0.2 * rng.normal(size=base.shape)
    return np.concatenate([inl, rng.uniform(-40, 40, (n - n_in, dim))]).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["plane3d", "line3d", "line2d"])
@pytest.mark.parametrize("n,gps,subsample", [(1024, 1, 0), (1000, 4, 0), (1024, 1, 512)])
def test_point_sweep_kernels_match_plain_on_card(cuda_device, family, n, gps, subsample):
    pts = torch.as_tensor(_family_cloud(family, 20 + n + gps, n), device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(gps)
    coords, p, nf, cols = fs.sweep_inputs(family, pts, gen, subsample)
    groups = -(-63 // gps) * gps
    kernel = kernels.FUSED_SWEEPS[family]
    before = kernel.launches
    kc, kp, ki = fs.sweep(family, coords, p, nf, groups, cols, 1.0)
    pc, pp, pi = fs.sweep_plain(family, coords, p, nf, groups, cols, 1.0)
    assert kernel.launches == before + 1
    assert abs(int(kc) - int(pc)) <= 1
    assert kp.shape == (fs._FAMILIES[family][2],)
    if int(ki) == int(pi):
        assert torch.equal(kp, pp)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
def test_plane_vote_kernel_equals_plain_on_card(cuda_device, d):
    rng = np.random.default_rng(30 + d)
    pts = torch.as_tensor(rng.uniform(-40, 40, (1000, d)).astype(np.float32), device=cuda_device)
    normals = rng.normal(size=(65536, d))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    params = np.concatenate([normals, rng.uniform(-20, 20, (65536, 1))], 1).astype(np.float32)
    params = torch.as_tensor(params, device=cuda_device)
    tt, vt, _ = vote.pack_points(pts)
    before = kernels.PLANE_VOTE.launches
    got = vote.plane_vote_counts(params, tt, vt, 1.0)
    plain = vote.plane_vote_counts_plain(params, tt, vt, 1.0)
    assert kernels.PLANE_VOTE.launches == before + 1
    assert torch.equal(got, plain)


# Ragged shapes for the two vote kernels: 128 hypotheses per block, 2,048
# points per shared-memory tile (n = 2,049 pads to 2,176: two tiles).
VOTE_RAGGED_B = (1, 3, 127, 129, 65537)
VOTE_RAGGED_N = (1000, 2049, 8192)


def _sphere_params(seed, b, device):
    """``[b, 4]`` f32: the even rows near the cloud's sphere, the odd ones wide."""
    rng = np.random.default_rng(seed)
    near = np.concatenate([[5.0, -2.0, 11.0] + rng.normal(0, 0.1, (b, 3)),
                           25.0 + rng.normal(0, 0.1, (b, 1))], 1)
    wide = np.concatenate([rng.uniform(-20, 30, (b, 3)), rng.uniform(0.2, 45, (b, 1))], 1)
    params = np.where((np.arange(b) % 2 == 0)[:, None], near, wide)
    return torch.as_tensor(params.astype(np.float32), device=device)


def _plane_params(seed, b, d, device):
    """``[b, d + 1]`` f32 rows [unit normal, offset], the even ones near the
    data's plane (line) n.p = 2 of :func:`_flat_cloud`."""
    rng = np.random.default_rng(seed)
    true_n = np.array([0.3, -0.5, 0.81][:d]) / np.linalg.norm([0.3, -0.5, 0.81][:d])
    normals = np.where((np.arange(b) % 2 == 0)[:, None], true_n + rng.normal(0, 0.002, (b, d)),
                       rng.normal(size=(b, d)))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    off = np.where(np.arange(b) % 2 == 0, 2.0 + rng.normal(0, 0.1, b), rng.uniform(-20, 20, b))
    return torch.as_tensor(np.concatenate([normals, off[:, None]], 1).astype(np.float32),
                           device=device)


def _flat_cloud(seed, n, d):
    """80% of the points within N(0, 0.3) of the plane (line) n.p = 2, 20%
    uniform in [-40, 40]^d, f32."""
    rng = np.random.default_rng(seed)
    true_n = np.array([0.3, -0.5, 0.81][:d]) / np.linalg.norm([0.3, -0.5, 0.81][:d])
    n_in = n * 4 // 5
    raw = rng.uniform(-30, 30, (n_in, d))
    inl = raw - (raw @ true_n - 2.0)[:, None] * true_n + 0.3 * rng.normal(size=(n_in, d))
    return np.concatenate([inl, rng.uniform(-40, 40, (n - n_in, d))]).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n", VOTE_RAGGED_N)
@pytest.mark.parametrize("b", VOTE_RAGGED_B)
def test_vote_kernel_ragged_shapes_equal_plain_on_card(cuda_device, b, n):
    pts = torch.as_tensor(_cloud(15 + n, n), device=cuda_device)
    params = _sphere_params(16 + b, b, cuda_device)
    tt, vt, _ = vote.pack_points(pts)
    before = kernels.SPHERE_VOTE.launches
    got = vote.sphere_vote_counts(params, tt, vt, 1.0)
    plain = vote.sphere_vote_counts_plain(params, tt, vt, 1.0)
    assert kernels.SPHERE_VOTE.launches == before + 1
    assert torch.equal(got, plain) and int(plain.max()) > n // 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", VOTE_RAGGED_N)
@pytest.mark.parametrize("b", VOTE_RAGGED_B)
@pytest.mark.parametrize("d", [2, 3])
def test_plane_vote_kernel_ragged_shapes_equal_plain_on_card(cuda_device, d, b, n):
    pts = torch.as_tensor(_flat_cloud(17 + n, n, d), device=cuda_device)
    params = _plane_params(18 + b, b, d, cuda_device)
    tt, vt, _ = vote.pack_points(pts)
    before = kernels.PLANE_VOTE.launches
    got = vote.plane_vote_counts(params, tt, vt, 1.0)
    plain = vote.plane_vote_counts_plain(params, tt, vt, 1.0)
    assert kernels.PLANE_VOTE.launches == before + 1
    assert torch.equal(got, plain) and int(plain.max()) > n // 2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [None, 2, 3])
def test_vote_kernels_pad_columns_never_vote_on_card(cuda_device, d):
    # 100 points, then 4,000 padding columns (one whole tile and more) that
    # hold copies of the points: none of them may vote.
    n, n_pad = 100, 4096
    cloud = _cloud(19, n) if d is None else _flat_cloud(19, n, d)
    rows = cloud.shape[1]
    points_t = torch.as_tensor(np.tile(cloud.T, (1, n_pad // n + 1))[:, :n_pad].copy(),
                               device=cuda_device)
    valid = torch.zeros((1, n_pad), dtype=torch.float32, device=cuda_device)
    valid[0, :n] = 1.0
    if d is None:
        params = _sphere_params(20, 129, cuda_device)
        got = vote.sphere_vote_counts(params, points_t, valid, 1.0)
        plain = vote.sphere_vote_counts_plain(params, points_t, valid, 1.0)
        alone = vote.sphere_vote_counts(params, points_t[:, :n].contiguous(),
                                        valid[:, :n].contiguous(), 1.0)
    else:
        params = _plane_params(20, 129, rows, cuda_device)
        got = vote.plane_vote_counts(params, points_t, valid, 1.0)
        plain = vote.plane_vote_counts_plain(params, points_t, valid, 1.0)
        alone = vote.plane_vote_counts(params, points_t[:, :n].contiguous(),
                                       valid[:, :n].contiguous(), 1.0)
    assert torch.equal(got, plain) and torch.equal(got, alone) and int(got.max()) > n // 2


@pytest.mark.cuda
@pytest.mark.parametrize("b", [500, 512])
def test_estimator_vote_counts_launch_the_kernel_at_any_b_on_card(cuda_device, b):
    est = SphereEstimator(1.0, 3, ALGEBRAIC)
    pts = torch.as_tensor(_cloud(21, 1000), device=cuda_device)
    params = _sphere_params(22, b, cuda_device)
    before = kernels.SPHERE_VOTE.launches
    got = est.vote_counts(params, pts)
    assert kernels.SPHERE_VOTE.launches == before + 1
    tt, vt, _ = vote.pack_points(pts)
    assert torch.equal(got, vote.sphere_vote_counts_plain(params, tt, vt, 1.0))


RIGID_SIZES = {"pivot": (512, 480)}   # (n, a size that is not 128 * 2^k)
RAY_DELTA = (1.0, float(np.sin(0.05) ** 2))


def _rigid_data(family, seed, n, device):
    """80% inliers of the family's planted truth, 20% outliers, f32: pivot
    frames about t_D = (10, -5, 2), t_W = (100, 50, -30); point pairs under
    a fixed rotation and t = (12, -7, 30); rays through (3, -4, 20); rows
    ``[a | b]`` of x = (1.5, -2, 0.5, 3, -1, 2.5)."""
    rng = np.random.default_rng(seed)
    n_in = n - n // 5

    def rotations_np(m):
        q = rng.normal(size=(m, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        return rotations.matrix_from_quaternion(torch.as_tensor(q)).numpy()

    if family == "pivot":
        r = rotations_np(n)
        t = np.array([100.0, 50.0, -30.0]) - r @ np.array([10.0, -5.0, 2.0])
        t += 0.05 * rng.normal(size=t.shape)
        t[n_in:] = rng.uniform(-200, 200, (n - n_in, 3))
        data = Frame(r, t)
    elif family == "absolute_orientation":
        first = rng.uniform(-100, 100, (n, 3))
        second = first @ rotations_np(1)[0].T + np.array([12.0, -7.0, 30.0])
        second += 0.1 * rng.normal(size=second.shape)
        second[n_in:] = rng.uniform(-100, 100, (n - n_in, 3))
        data = (first, second)
    elif family == "ray3d":
        p = rng.uniform(-60, 60, (n, 3))
        d = np.array([3.0, -4.0, 20.0]) - p + 0.05 * rng.normal(size=(n, 3))
        d[n_in:] = rng.normal(size=(n - n_in, 3))
        data = Ray3D(p, d / np.linalg.norm(d, axis=1, keepdims=True))
    else:
        a = rng.uniform(-10, 10, (n, 6))
        b = a @ np.array([1.5, -2.0, 0.5, 3.0, -1.0, 2.5]) + 0.05 * rng.normal(size=n)
        b[n_in:] += rng.uniform(5, 50, n - n_in)
        data = np.concatenate([a, b[:, None]], axis=1)
    return as_tensor(data, device, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["pivot", "absolute_orientation", "ray3d", "dense_linear6"])
@pytest.mark.parametrize("case,gps,subsample", [(0, 1, 0), (1, 4, 0), (0, 1, 256)])
def test_rigid_sweep_kernels_match_plain_on_card(cuda_device, family, case, gps, subsample):
    n = RIGID_SIZES.get(family, (1024, 1000))[case]
    data = _rigid_data(family, 40 + n + gps, n, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(gps)
    coords, p, nf, cols = fs.sweep_inputs(family, data, gen, subsample)
    groups = -(-63 // gps) * gps
    delta = RAY_DELTA if family == "ray3d" else 1.0
    kernel = kernels.FUSED_SWEEPS[family]
    before = kernel.launches
    kc, kp, ki = fs.sweep(family, coords, p, nf, groups, cols, delta)
    pc, pp, pi = fs.sweep_plain(family, coords, p, nf, groups, cols, delta)
    assert kernel.launches == before + 1
    assert int(kc) > 0
    assert kp.shape == (fs._FAMILIES[family][2],)
    # FMA votes rounded alike: the same winner, bit for bit.
    assert int(kc) == int(pc) and int(ki) == int(pi) and torch.equal(kp, pp)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["pivot", "absolute_orientation", "ray3d", "dense_linear6"])
def test_rigid_kernel_pad_columns_never_vote_on_card(cuda_device, family):
    # n = 200: the 56 padding columns hold zero rows, which lie in the band of
    # a fit whose residual there is ~0 (t_W = 0, t = 0, a ray target at the
    # origin; any x for the linear system).  The kernel stages them as NaN.
    rng = np.random.default_rng(50)
    n = 200
    if family == "pivot":
        q = rng.normal(size=(n, 4))
        r = rotations.matrix_from_quaternion(torch.as_tensor(q / np.linalg.norm(q, axis=1,
                                                                              keepdims=True)))
        data = Frame(r, -r @ torch.tensor([10.0, -5.0, 2.0], dtype=r.dtype))
    elif family == "absolute_orientation":
        first = rng.uniform(-50, 50, (n, 3))
        data = (first, first.copy())
    elif family == "ray3d":
        p = rng.uniform(-50, 50, (n, 3))
        data = Ray3D(p, -p / np.linalg.norm(p, axis=1, keepdims=True))
    else:
        data = rng.normal(size=(n, 7)) * 10.0
    data = as_tensor(data, cuda_device, torch.float32)
    delta = RAY_DELTA if family == "ray3d" else 0.05 if family == "dense_linear6" else 1.0
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    coords, p, nf, cols = fs.sweep_inputs(family, data, gen)
    kc, kp, ki = fs.sweep_cuda(family, coords, p, nf, 6, cols, delta)
    pc, pp, pi = fs.sweep_plain(family, coords, p, nf, 6, cols, delta)
    assert int(kc) == int(pc) and int(kc) <= n
    if family != "dense_linear6":
        assert int(kc) >= n - 1
    if int(ki) == int(pi):
        assert torch.equal(kp, pp)


@pytest.mark.cuda
@pytest.mark.parametrize("family", kernels.RIGID_FAMILIES)
@pytest.mark.parametrize("groups,vote_cols", [(63, 1), (5, 300), (3, 1000), (3, 1365),
                                              (2, 2100)])
def test_split_rigid_kernels_ragged_shapes_equal_plain_on_card(cuda_device, family, groups,
                                                              vote_cols):
    # vote_cols 1, 300, 1,000, 1,365 (two 682-point tiles of three float4s
    # and one point more) and past two 1,024-point tiles: slot planes of the
    # first 1,024 observations, votes on up to 2,100.
    data = _rigid_data(family, 70 + groups, 2100, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(groups)
    coords, _, nf, _ = fs.sweep_inputs(family, tree_map(lambda x: x[:1024], data), gen)
    p = fs.pack_p(family, data)
    delta = RAY_DELTA if family == "ray3d" else 1.0
    kc, kp, ki = fs.sweep_cuda(family, coords, p, nf, groups, vote_cols, delta)
    pc, pp, pi = fs.sweep_plain(family, coords, p, nf, groups, vote_cols, delta)
    assert int(kc) == int(pc) and int(ki) == int(pi) and torch.equal(kp, pp)


def _euler(w):
    """``Rz(w0) Ry(w1) Rx(w2)`` for ``w[..., 3]`` in numpy."""
    cz, sz, cy, sy, cx, sx = (f(w[..., i]) for i in range(3) for f in (np.cos, np.sin))
    return np.stack([
        np.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx], -1),
        np.stack([sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx], -1),
        np.stack([-sy, cy * sx, cy * cx], -1),
    ], -2)


def _us_data(family, seed, n, device, noise=True):
    """The ultrasound calibration model: m_x = 0.143, m_y = 0.139, R3 of Euler
    angles (1.1, 0.4, -0.7), t3 = (20, -15, 40) (t3 = 0 without noise),
    crosswire target t1 = (30, 76, -58); pixels in 640 x 480, pose angles in
    [0, pi); with noise, 0.5 px on q and 20% of t2 (crosswire) or p (pointer)
    shifted by 30-80.  f32 leaves ``(Frame, q)`` or ``(Frame, q, p)``."""
    rng = np.random.default_rng(seed)
    r3 = _euler(np.array([1.1, 0.4, -0.7]))
    t3 = np.array([20.0, -15.0, 40.0]) if noise else np.zeros(3)
    q = rng.uniform(size=(n, 2)) * np.array([640.0, 480.0])
    r2 = _euler(rng.uniform(0, np.pi, (n, 3))[:, ::-1])
    img = q[:, 0:1] * (0.143 * r3[:, 0]) + q[:, 1:2] * (0.139 * r3[:, 1]) + t3
    mapped = np.einsum("nij,nj->ni", r2, img)
    n_out = n // 5 if noise else 0
    shift = (30.0 + 50.0 * rng.uniform(size=(n_out, 3))) * np.sign(rng.normal(size=(n_out, 3)))
    if family == "crosswire":
        t2 = np.array([30.0, 76.0, -58.0]) - mapped
        t2[n - n_out:] += shift
        rest = ()
    else:
        t2 = rng.uniform(-100, 100, (n, 3))
        p = mapped + t2
        p[n - n_out:] += shift
        rest = (p,)
    if noise:
        q = q + 0.5 * rng.normal(size=q.shape)
    return as_tensor((Frame(r2, t2), q, *rest), device, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["crosswire", "pointer"])
@pytest.mark.parametrize("n,gps,subsample", [(1024, 1, 0), (1000, 4, 0), (1024, 1, 512)])
def test_us_sweep_kernels_match_plain_on_card(cuda_device, family, n, gps, subsample):
    data = _us_data(family, 60 + n + gps, n, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(gps)
    coords, p, nf, cols = fs.sweep_inputs(family, data, gen, subsample)
    groups = -(-63 // gps) * gps
    kernel = kernels.FUSED_SWEEPS[family]
    before = kernel.launches
    kc, kp, ki = fs.sweep(family, coords, p, nf, groups, cols, 3.0)
    pc, pp, pi = fs.sweep_plain(family, coords, p, nf, groups, cols, 3.0)
    assert kernel.launches == before + 1
    assert int(kc) > (subsample or n) // 2
    assert int(kc) == int(pc) and int(ki) == int(pi)
    assert kp.shape == (fs._FAMILIES[family][2],)
    assert torch.equal(kp, pp)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["crosswire", "pointer"])
def test_us_kernel_pad_columns_never_vote_on_card(cuda_device, family):
    # n = 200, exact data with t3 = 0: the 56 padding columns hold zero rows,
    # whose residual under the planted calibration is |t3| = 0.  The kernel
    # stages them as NaN.
    data = _us_data(family, 70, 200, cuda_device, noise=False)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    coords, p, nf, cols = fs.sweep_inputs(family, data, gen)
    kc, kp, ki = fs.sweep_cuda(family, coords, p, nf, 6, cols, 3.0)
    pc, pp, pi = fs.sweep_plain(family, coords, p, nf, 6, cols, 3.0)
    assert int(kc) == int(pc) and 199 <= int(kc) <= 200
    assert int(ki) == int(pi) and torch.equal(kp, pp)


@pytest.mark.cuda
@pytest.mark.parametrize("n,groups,vote_cols", [(1024, 63, 1), (1000, 5, 300), (1000, 3, 1000),
                                                (2049, 2, 2049), (200, 7, 256)])
def test_line3d_kernel_ragged_shapes_equal_plain_on_card(cuda_device, n, groups, vote_cols):
    # vote_cols 1, 300, 1,000 and past one 2,048-point tile; n = 200 votes
    # on its 56 padding columns too.
    pts = torch.as_tensor(_family_cloud("line3d", 80 + n, n), device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(n + groups)
    coords, p, nf, _ = fs.sweep_inputs("line3d", pts, gen)
    kc, kp, ki = fs.sweep_cuda("line3d", coords, p, nf, groups, vote_cols, 1.0)
    pc, pp, pi = fs.sweep_plain("line3d", coords, p, nf, groups, vote_cols, 1.0)
    assert int(kc) == int(pc) and int(ki) == int(pi) and torch.equal(kp, pp)


@pytest.mark.cuda
def test_line3d_kernel_pad_columns_never_vote_on_card(cuda_device):
    # 200 points on the x axis: the 56 zero padding columns lie on every
    # line through the origin, and the kernel stages them as NaN.
    pts = torch.zeros((200, 3), device=cuda_device)
    pts[:, 0] = torch.linspace(-30, 30, 200, device=cuda_device)
    coords, p, nf, cols = fs.sweep_inputs("line3d", pts,
                                          torch.Generator(device=cuda_device).manual_seed(1))
    kc, kp, ki = fs.sweep_cuda("line3d", coords, p, nf, 2, cols, 1.0)
    pc, pp, pi = fs.sweep_plain("line3d", coords, p, nf, 2, cols, 1.0)
    assert int(kc) == int(pc) == 200 and int(ki) == int(pi) and torch.equal(kp, pp)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1e3, 1e4])
def test_line3d_kernel_far_from_the_origin_equals_plain_on_card(cuda_device, offset):
    # The vote expands |p - a|^2 about P's column 0: a cloud far from the
    # origin counts as the plain version does, its best within 1 of the
    # float64 `agree` maximum over the same hypotheses.
    pts = torch.as_tensor(_family_cloud("line3d", 81, 1024) + np.float32(offset),
                          device=cuda_device)
    perms = fs.draw_slot_perms(1024, 2, torch.Generator(device=cuda_device).manual_seed(2),
                               device=cuda_device)
    coords, p, nf, cols = fs.sweep_inputs("line3d", pts, None, perms=perms)
    kc, kp, ki = fs.sweep_cuda("line3d", coords, p, nf, 8, cols, 1.0)
    pc, pp, pi = fs.sweep_plain("line3d", coords, p, nf, 8, cols, 1.0)
    assert int(kc) == int(pc) and int(ki) == int(pi) and torch.equal(kp, pp)
    est = LineEstimator(1.0, 3)
    params, valid = est.minimal_fit(fs.reference_samples("line3d", pts, perms, 8).double())
    best = int(torch.where(valid, est.agree(params, pts.double()).sum(-1), 0).max())
    assert abs(int(kc) - best) <= 1


def _far_sphere(offset, device, n=1024):
    """80% of ``n`` points on the radius-10 sphere about (1, 2, -3) with
    N(0, 0.2) radial noise, the rest uniform in [-40, 40]^3, every
    coordinate offset by ``offset``, f32 (``tests/test_torch_vote.py``'s
    far-cloud model)."""
    rng = np.random.default_rng(41)
    n_in = n * 4 // 5
    d = rng.normal(size=(n_in, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inl = np.array([1.0, 2.0, -3.0]) + (10.0 + 0.2 * rng.normal(size=(n_in, 1))) * d
    pts = np.concatenate([inl, rng.uniform(-40.0, 40.0, size=(n - n_in, 3))]) + offset
    return torch.as_tensor(pts.astype(np.float32), device=device)


def _f64_best(samples, pts):
    """The float64 ``minimal_fit`` + ``agree`` maximum over ``samples``."""
    est = SphereEstimator(1.0, 3)
    params, valid = est.minimal_fit(samples.double())
    return int(torch.where(valid, est.agree(params, pts.double()).sum(-1), 0).max())


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1e3, 1e4])
def test_vote_kernel_far_from_the_origin_equals_plain_on_card(cuda_device, offset):
    # B2 expands |p - c|^2 about the packed points' column 0: on a cloud far
    # from the origin it counts as its plain version, the best within 1 of
    # the float64 `agree` maximum over the same hypotheses.
    pts = _far_sphere(offset, cuda_device)
    rng = np.random.default_rng(43)
    params = np.concatenate([np.array([1.0, 2.0, -3.0]) + offset + rng.normal(0, 0.3, (4096, 3)),
                             10.0 + rng.normal(0, 0.3, (4096, 1))], 1)
    params = torch.as_tensor(params.astype(np.float32), device=cuda_device)
    tt, vt, _ = vote.pack_points(pts)
    got = vote.sphere_vote_counts_cuda(params, tt, vt, 1.0)
    assert torch.equal(got, vote.sphere_vote_counts_plain(params, tt, vt, 1.0))
    want = SphereEstimator(1.0, 3).agree(params.double(), pts.double()).sum(-1)
    assert abs(int(got.max()) - int(want.max())) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1e3, 1e4])
def test_sphere3d_kernel_far_from_the_origin_equals_plain_on_card(cuda_device, offset):
    pts = _far_sphere(offset, cuda_device)
    perms = fs.draw_slot_perms(1024, 4, torch.Generator(device=cuda_device).manual_seed(2),
                               device=cuda_device)
    coords, p, nf, cols = fs.sweep_inputs("sphere3d", pts, None, perms=perms)
    kc, kp, ki = fs.sweep_cuda("sphere3d", coords, p, nf, 8, cols, 1.0)
    pc, pp, pi = fs.sweep_plain("sphere3d", coords, p, nf, 8, cols, 1.0)
    assert int(kc) == int(pc) and int(ki) == int(pi) and torch.equal(kp, pp)
    assert abs(int(kc) - _f64_best(fs.reference_samples("sphere3d", pts, perms, 8), pts)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1e3, 1e4])
def test_sphere_mega_kernel_far_from_the_origin_equals_plain_on_card(cuda_device, offset):
    pts = _far_sphere(offset, cuda_device)
    points_t, valid, _ = vote.pack_points(pts)
    coords2 = sphere_ransac._slot_planes(pts, torch.Generator(device=cuda_device).manual_seed(3),
                                         1024)
    shifts = torch.as_tensor(sphere_ransac.mega_group_shifts(8, 1024), dtype=torch.int32,
                             device=cuda_device)
    counts, params_t = sphere_ransac.megakernel_call_cuda(shifts, coords2, points_t, valid, 1.0)
    pcounts, pparams = sphere_ransac.megakernel_call_plain(shifts, coords2, points_t, valid, 1.0)
    assert torch.equal(counts, pcounts) and torch.equal(params_t, pparams)
    samples = sphere_ransac.reference_mega_samples(pts, None, 8, coords2=coords2)
    assert abs(int(counts.max()) - _f64_best(samples, pts)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1e3, 1e4])
def test_sphere_planar_vote_kernel_far_from_the_origin_equals_plain_on_card(cuda_device, offset):
    pts = _far_sphere(offset, cuda_device)
    points_t, valid, _ = vote.pack_points(pts)
    sxyz = sphere_ransac.planar_sphere_samples(
        torch.Generator(device=cuda_device).manual_seed(4), pts, 8)
    counts, params_t = sphere_ransac.sphere_fit_and_vote_planar_cuda(sxyz, points_t, valid, 1.0)
    pcounts, pparams = sphere_ransac.sphere_fit_and_vote_planar_plain(sxyz, points_t, valid, 1.0)
    assert torch.equal(counts, pcounts) and torch.equal(params_t, pparams)
    samples = torch.stack([sxyz[0:4].T, sxyz[4:8].T, sxyz[8:12].T], dim=-1)
    assert abs(int(counts.max()) - _f64_best(samples, pts)) <= 1


def _us_chunks_equal_plain(family, monkeypatch, device, chunk, n, groups, vote_cols):
    monkeypatch.setattr(fs, "US_CHUNK", chunk)
    data = _us_data(family, 90 + n, n, device)
    gen = torch.Generator(device=device).manual_seed(n + groups)
    coords, p, nf, _ = fs.sweep_inputs(family, data, gen)
    kernel = kernels.FUSED_SWEEPS[family]
    before = kernel.launches
    kc, kp, ki = fs.sweep_cuda(family, coords, p, nf, groups, vote_cols, 3.0)
    pc, pp, pi = fs.sweep_plain(family, coords, p, nf, groups, vote_cols, 3.0)
    assert kernel.launches == before + 1
    assert int(kc) == int(pc) and int(ki) == int(pi) and torch.equal(kp, pp)


_US_CHUNK_CASES = [(1024, 7, 1024), (1000, 3, 300), (1000, 2, 1), (2049, 2, 2049)]


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1 << 20, 128, 300, 4096])
@pytest.mark.parametrize("n,groups,vote_cols", _US_CHUNK_CASES)
def test_crosswire_kernel_chunks_equal_plain_on_card(cuda_device, monkeypatch, chunk, n, groups,
                                                     vote_cols):
    # The fit and vote kernels run once per chunk of hypotheses (ragged at
    # 300 and 4,096) and the best key accumulates across chunks; vote_cols
    # 1, 300 and past four 512-point tiles.
    _us_chunks_equal_plain("crosswire", monkeypatch, cuda_device, chunk, n, groups, vote_cols)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1 << 20, 128, 300, 4096])
@pytest.mark.parametrize("n,groups,vote_cols", _US_CHUNK_CASES)
def test_pointer_kernel_chunks_equal_plain_on_card(cuda_device, monkeypatch, chunk, n, groups,
                                                   vote_cols):
    # As crosswire's: chunks of 128, 300 and 4,096 hypotheses; vote_cols 1,
    # 300 and past one 2,048-point tile.
    _us_chunks_equal_plain("pointer", monkeypatch, cuda_device, chunk, n, groups, vote_cols)


def _lm_problems(seed, b, m):
    """The bench's LM problems: centres in U(-50, 50)^3, radius 25, N(0, 0.3)
    noise, start at centre + 1 and radius 23 (f32)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-50, 50, (b, 3))
    d = rng.normal(size=(b, m, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = centers[:, None, :] + 25.0 * d + 0.3 * rng.normal(size=(b, m, 3))
    x0 = np.concatenate([centers + 1.0, np.full((b, 1), 23.0)], axis=1)
    return pts.astype(np.float32), x0.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m", [(4096, 256), (100, 37), (1, 1), (7, 37), (4097, 256),
                                 (7, 300), (1, 600)])
def test_sphere_lm_kernel_matches_plain_on_card(cuda_device, b, m):
    # B = 1, 7 and 4,097 leave a warp's second problem empty; m = 300 and
    # 600 pass the 256 points a problem keeps in registers and read the rest
    # from global memory.
    pts, x0 = _lm_problems(80 + m, b, m)
    pts_d, x0_d = torch.as_tensor(pts, device=cuda_device), torch.as_tensor(x0, device=cuda_device)
    before = kernels.SPHERE_LM.launches
    x, cost, it, conv = sphere_lm.sphere_lm_batch(pts_d, x0_d)
    px, pcost, pit, pconv = sphere_lm.sphere_lm_batch_plain(pts_d, x0_d)
    assert kernels.SPHERE_LM.launches == before + 1
    assert bool(conv.all()) and torch.equal(conv, pconv)
    assert float((x - px).abs().max()) < 1e-3
    assert int(it.max()) <= 30


@pytest.mark.cuda
def test_sphere_lm_entry_point_takes_a_non_contiguous_view_on_card(cuda_device):
    # The kernel reads points[B, m, 3] as it lies; sphere_lm_batch makes a
    # strided view contiguous first, so every other column of a [B, m, 6]
    # array gives what its copy gives.
    pts, x0 = _lm_problems(83, 33, 64)
    wide = torch.zeros((33, 64, 6), device=cuda_device)
    wide[..., ::2] = torch.as_tensor(pts, device=cuda_device)
    view = wide[..., ::2]
    assert not view.is_contiguous()
    x0_d = torch.as_tensor(x0, device=cuda_device)
    got = sphere_lm.sphere_lm_batch(view, x0_d)
    want = sphere_lm.sphere_lm_batch(view.contiguous(), x0_d)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[3].all())


@pytest.mark.cuda
def test_sphere_lm_kernel_non_finite_step_matches_plain_on_card(cuda_device):
    # A point at 1e20 overflows s: the f sums and the step are NaN, x + 0 NaN
    # poisons the centre, and the problem stops when lam reaches max_lambda,
    # with the plain version's iteration count; its neighbours are untouched.
    pts, x0 = _lm_problems(77, 40, 64)
    pts[5, 3] = 1e20
    pts[22, 0, 1] = -1e20
    pts_d, x0_d = torch.as_tensor(pts, device=cuda_device), torch.as_tensor(x0, device=cuda_device)
    x, cost, it, conv = sphere_lm.sphere_lm_batch_cuda(pts_d, x0_d)
    px, pcost, pit, pconv = sphere_lm.sphere_lm_batch_plain(pts_d, x0_d)
    bad = torch.zeros(40, dtype=torch.bool, device=cuda_device)
    bad[[5, 22]] = True
    assert torch.equal(x.isnan(), px.isnan()) and bool(x[bad].isnan().all())
    assert torch.equal(it[bad], pit[bad]) and bool(conv.all()) and torch.equal(conv, pconv)
    assert float((x[~bad] - px[~bad]).abs().max()) < 1e-3


_SQRT_RCP_CHECK = r"""
// Every float bit pattern through B5's branch-free sqrt_rn against sqrtf,
// and through rcp_rn against 1.f / x on the inputs the kernel gives it.
#include <cstdio>
#include "sphere_lm.cu"

__global__ void check(unsigned long long* bad) {
  unsigned long long b_sqrt = 0, b_rcp = 0;
  for (unsigned long long i = blockIdx.x * 256ull + threadIdx.x; i < (1ull << 32);
       i += gridDim.x * 256ull) {
    const float x = __uint_as_float(static_cast<unsigned>(i));
    const float a = sqrt_rn(x), b = sqrtf(x);
    b_sqrt += !((a != a && b != b) || __float_as_uint(a) == __float_as_uint(b));
    if ((x >= 1e-12f && x < 0x1p126f) || x == INFINITY || x != x) {
      const float c = rcp_rn(x), d = 1.f / x;
      b_rcp += !((c != c && d != d) || __float_as_uint(c) == __float_as_uint(d));
    }
  }
  atomicAdd(bad, b_sqrt);
  atomicAdd(bad + 1, b_rcp);
}

int main() {
  unsigned long long* bad;
  cudaMallocManaged(&bad, 2 * sizeof(unsigned long long));
  bad[0] = bad[1] = 0;
  check<<<132 * 16, 256>>>(bad);
  const cudaError_t err = cudaDeviceSynchronize();
  printf("%d %llu %llu\n", static_cast<int>(err), bad[0], bad[1]);
  return err != cudaSuccess;
}
"""


@pytest.mark.cuda
def test_sphere_lm_square_root_and_reciprocal_round_as_ieee_on_every_float_on_card(
        cuda_device, tmp_path):
    # sqrt_rn and rcp_rn are nvcc's correctly rounded sequences with selects
    # in place of the branch to its slow path: equal to sqrtf on all 2^32
    # floats, and to 1.f / x on +inf, NaN and [1e-12, 2^126), every value the
    # kernel takes a reciprocal of (d = sqrt(s) where s >= 1e-24).
    src = tmp_path / "check.cu"
    src.write_text(_SQRT_RCP_CHECK)
    exe = tmp_path / "check"
    subprocess.run([kernels.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-I", str(kernels.CSRC_DIR), "-o", str(exe), str(src)], check=True)
    err, bad_sqrt, bad_rcp = subprocess.run(
        [str(exe)], check=True, capture_output=True, text=True).stdout.split()
    assert (int(err), int(bad_sqrt), int(bad_rcp)) == (0, 0, 0)


def _step_inputs(device, n, seed):
    pts = torch.as_tensor(_cloud(seed, n), device=device)
    points_t, valid, _ = vote.pack_points(pts)
    return pts, points_t, valid


@pytest.mark.cuda
@pytest.mark.parametrize("n,groups", [(1024, 128), (256, 4), (128, 5), (1024, 127)])
def test_sphere_mega_kernel_equals_plain_on_card(cuda_device, n, groups):
    # 128 x 5 and 1,024 x 127 leave a partial last block.
    pts, points_t, valid = _step_inputs(cuda_device, n, 90 + groups)
    gen = torch.Generator(device=cuda_device).manual_seed(groups)
    coords2 = sphere_ransac._slot_planes(pts, gen, n)
    shifts = torch.as_tensor(sphere_ransac.mega_group_shifts(groups, n), dtype=torch.int32,
                             device=cuda_device)
    before = kernels.SPHERE_MEGA.launches
    counts, params_t = sphere_ransac.megakernel_call(shifts, coords2, points_t, valid, 1.0)
    pcounts, pparams = sphere_ransac.megakernel_call_plain(shifts, coords2, points_t, valid, 1.0)
    assert kernels.SPHERE_MEGA.launches == before + 1
    assert torch.equal(counts, pcounts) and torch.equal(params_t, pparams)


@pytest.mark.cuda
@pytest.mark.parametrize("n,groups,drop", [(1024, 128, 0), (200, 3, 0), (1000, 3, 5),
                                           (1500, 2, 7), (2100, 1, 2000)])
def test_sphere_planar_vote_kernel_equals_plain_on_card(cuda_device, n, groups, drop):
    # Dropping the last `drop` samples leaves a partial block (100
    # hypotheses, fewer than one block, at n = 2,100), and n = 1,500 and
    # 2,100 are not multiples of the 1,024-point tile or of the 8 warps.
    pts, points_t, valid = _step_inputs(cuda_device, n, 95 + groups)
    gen = torch.Generator(device=cuda_device).manual_seed(groups)
    sxyz = sphere_ransac.planar_sphere_samples(gen, pts, groups)
    sxyz = sxyz[:, : sxyz.shape[1] - drop].contiguous()
    before = kernels.SPHERE_PLANAR_VOTE.launches
    counts, params_t = sphere_ransac.sphere_fit_and_vote_planar(sxyz, points_t, valid, 1.0)
    pcounts, pparams = sphere_ransac.sphere_fit_and_vote_planar_plain(sxyz, points_t, valid, 1.0)
    assert kernels.SPHERE_PLANAR_VOTE.launches == before + 1
    assert torch.equal(counts, pcounts) and torch.equal(params_t, pparams)
    assert int(counts.max()) > n // 2


@pytest.mark.cuda
def test_fast_sweep_launches_once_per_step_on_card(cuda_device):
    pts, points_t, valid = _step_inputs(cuda_device, 1024, 99)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    before = kernels.SPHERE_MEGA.launches
    count, params = sphere_ransac.fast_sphere_ransac_sweep(pts, points_t, valid, gen, 16, 5, 1.0)
    assert kernels.SPHERE_MEGA.launches == before + 5
    assert int(count) > 700
    assert float((params.cpu() - torch.tensor([5.0, -2.0, 11.0, 25.0])).abs().max()) < 0.5


def _phantom_data(rng, n):
    """``(frames, q)`` (f64) of n observations of the phantom model (m_x =
    0.143, m_y = 0.139, a random plane and calibration, pose angles in [0,
    pi), pixels in 640 x 480 with 0.5 px noise)."""
    r3 = _euler(rng.uniform(0, np.pi, 3))
    t3 = rng.uniform(-100, 100, 3)
    wy, wx = rng.uniform(-1, 1, 2)
    normal = np.array([-np.sin(wy), np.cos(wy) * np.sin(wx), np.cos(wy) * np.cos(wx)])
    q = rng.uniform(size=(n, 2)) * np.array([640.0, 480.0])
    r2 = _euler(rng.uniform(0, np.pi, (n, 3)))
    mapped = np.einsum("nij,nj->ni", r2, q[:, 0:1] * (0.143 * r3[:, 0])
                       + q[:, 1:2] * (0.139 * r3[:, 1]) + t3)
    free = rng.uniform(-100, 100, (n, 3))
    t2 = free - ((mapped + free) @ normal + rng.uniform(-100, 100))[:, None] * normal
    q = q + 0.5 * rng.normal(size=q.shape)
    return Frame(torch.as_tensor(r2), torch.as_tensor(t2)), torch.as_tensor(q)


def _phantom_planes(seed, b, n=64):
    """Slot planes ``[31, 14, b]`` (f64) of plane-phantom minimal samples: 31
    random observations each of :func:`_phantom_data`."""
    rng = np.random.default_rng(seed)
    feats = us_fast._slot_features_phantom(_phantom_data(rng, n))     # [n, 14] f64
    idx = np.stack([rng.permutation(n)[:31] for _ in range(b)])
    return feats[torch.as_tensor(idx)].permute(1, 2, 0)                # [31, 14, b]


def _phantom_systems(seed, b, n=64):
    """``bands [b, 31, 32]`` of :func:`_phantom_planes`' systems, built from
    the f64 slot features as the fit builds them."""
    return phantom_qr.pack_systems(us_fast.phantom_systems(_phantom_planes(seed, b, n)))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [4352, 1000, 1, 3, 4351, 65536])
def test_phantom_qr_kernel_equals_plain_on_card(cuda_device, b):
    # B = 1, 3 and 4,351 leave lane groups without a hypothesis, which still
    # take part in every shuffle.
    bands = _phantom_systems(100 + b, b).to(cuda_device)
    before = kernels.PHANTOM_QR.launches
    got = phantom_qr.phantom_subspace(bands)
    plain = phantom_qr.phantom_subspace_plain(bands)
    assert kernels.PHANTOM_QR.launches == before + 1
    assert got.shape == (4, 31, b) and bool(torch.isfinite(got).all())
    assert torch.equal(got, plain)
    assert float((torch.sum(got.double() ** 2, dim=1) - 1.0).abs().max()) < 1e-5


@pytest.mark.cuda
def test_phantom_qr_kernel_degenerate_samples_on_card(cuda_device):
    # Rank-deficient systems: one observation in all 31 rows, the u R2 block
    # of one pose, half the rows duplicated.  A rank-1 system's inverse
    # iteration may overflow; the kernel then gives the plain version's
    # non-finite entries, where the plain version has them.
    bands = _phantom_systems(7, 24)
    a = bands[:, :, :31]
    a[:8] = a[:8, :, :1].clone()
    a[8:16, 0:9] = a[8:16, 0:9, :1].clone()
    a[16:24, :, 16:] = a[16:24, :, 15:16].clone()
    bands = bands.to(cuda_device)
    got = phantom_qr.phantom_subspace(bands)
    plain = phantom_qr.phantom_subspace_plain(bands)
    assert torch.equal(torch.isnan(got), torch.isnan(plain))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(plain))
    assert bool(torch.isfinite(got[:, :, 8:]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,num_hyp", [("PHANTOM_QR", 4352), ("PHANTOM_QR", 65536),
                                            ("SPHERE_MEGA", 131072), ("SPHERE_LM", 4096),
                                            ("SPHERE_PLANAR_VOTE", 131072),
                                            ("SPHERE_VOTE", 65536), ("SPHERE_VOTE", 1 << 20),
                                            ("PLANE_VOTE", 65536), ("PLANE_VOTE", 1 << 20),
                                            ("FUSED_SWEEP_LINE3D", 1 << 22),
                                            ("FUSED_SWEEP_SPHERE3D", 1 << 22),
                                            ("dense_linear6", 1 << 21),
                                            ("absolute_orientation", 1 << 20),
                                            ("pivot", 1 << 20), ("ray3d", 1 << 20),
                                            ("crosswire", 1 << 20), ("crosswire fit", 1 << 20),
                                            ("pointer", 1 << 20), ("pointer fit", 1 << 20)])
def test_redesigned_kernels_report_their_launch_shape_on_card(cuda_device, kernel, num_hyp):
    if kernel.split()[0] in kernels.FUSED_SWEEPS:
        query = "fit_shape" if kernel.endswith("fit") else "shape"
        shape = kernels.FUSED_SWEEPS[kernel.split()[0]].shape(num_hyp, query)
    else:
        shape = getattr(kernels, kernel).shape(num_hyp)
    assert shape["spill_bytes"] == 0 and 0 < shape["registers"] <= 255
    assert shape["blocks_per_sm"] >= 1 and shape["threads"] % 32 == 0
    assert (shape["blocks"] - 1) * shape["hyp_per_block"] < num_hyp
    assert shape["blocks"] * shape["hyp_per_block"] >= num_hyp and shape["waves"] > 0


def _ritz_on_card(a):
    """B6's subspace of the systems ``a[31, 31, B]`` on the card, then
    ``phantom_ritz``'s kernel and its plain version on the same inputs."""
    v = phantom_qr.phantom_subspace(phantom_qr.pack_systems(a))
    before = kernels.PHANTOM_RITZ.launches
    got = us_fast.phantom_ritz(a, v)
    assert kernels.PHANTOM_RITZ.launches == before + 1
    return got, us_fast.phantom_ritz_plain(a, v)


def _assert_bit_equal(got, plain):
    (gp, gv), (pp, pv) = got, plain
    assert gp.dtype == pp.dtype and gp.shape == pp.shape and torch.equal(gv, pv)
    assert torch.equal(torch.isnan(gp), torch.isnan(pp))
    assert torch.equal(torch.nan_to_num(gp), torch.nan_to_num(pp))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("seed", range(8))
def test_phantom_ritz_kernel_equals_plain_on_card(cuda_device, dtype, seed):
    # A chunk of the cell's shape: n = 64, 4,352 hypotheses.
    a = us_fast.phantom_systems(_phantom_planes(300 + seed, 4352)).to(cuda_device, dtype)
    got, plain = _ritz_on_card(a)
    _assert_bit_equal(got, plain)
    assert got[0].shape == (4352, 41) and float(got[1].float().mean()) > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 33, 4351, 65536])
def test_phantom_ritz_kernel_ragged_and_large_on_card(cuda_device, b):
    # Partial blocks (1, 33 and 4,351 hypotheses) and the whole sweep at once.
    a = us_fast.phantom_systems(_phantom_planes(400 + b, b)).to(cuda_device)
    got, plain = _ritz_on_card(a)
    _assert_bit_equal(got, plain)


@pytest.mark.cuda
def test_phantom_ritz_kernel_gates_degenerate_samples_like_plain_on_card(cuda_device):
    # The samples of test_phantom_fit_rejects_duplicate_samples_on_card and of
    # the CPU's duplicate and translation-only case: one observation in every
    # slot, and one rotation with distinct translations.
    planes = _phantom_planes(9, 64).to(cuda_device)
    planes[:, :, :16] = planes[0:1, :, :16].clone()
    planes[:, 0:9, 16:32] = planes[0:1, 0:9, 16:32].clone()
    got, plain = _ritz_on_card(us_fast.phantom_systems(planes))
    _assert_bit_equal(got, plain)
    assert not bool(got[1][:32].any()) and bool(got[1][32:].all())


@pytest.mark.cuda
def test_phantom_structured_sweep_kernel_route_equals_plain_route_on_card(cuda_device,
                                                                       monkeypatch):
    from lsqrrecipes_tpu_torch.estimators import get

    est = get("us_plane_phantom")(1.0)
    data = tree_map(lambda t: t.to(cuda_device), _phantom_data(np.random.default_rng(11), 64))
    groups = 256
    chunks = -(-groups * 64 // us_fast._chunk_size(groups * 64, 64, 31))
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(5)).to(cuda_device)
    kernels.reset_launch_counts()
    counts, params = us_fast.structured_sweep("plane_phantom", est, data, None, groups, perm)
    assert kernels.PHANTOM_RITZ.launches == kernels.PHANTOM_QR.launches == chunks > 1
    monkeypatch.setattr(us_fast, "phantom_ritz", us_fast.phantom_ritz_plain)
    pcounts, pparams = us_fast.structured_sweep("plane_phantom", est, data, None, groups, perm)
    assert kernels.PHANTOM_RITZ.launches == chunks
    assert torch.equal(counts, pcounts) and int(counts.max()) > 31
    assert torch.equal(torch.isnan(params), torch.isnan(pparams))
    assert torch.equal(torch.nan_to_num(params), torch.nan_to_num(pparams))


@pytest.mark.cuda
@pytest.mark.parametrize("num_hyp", [4352, 65536])
def test_phantom_ritz_reports_its_launch_shape_on_card(cuda_device, num_hyp):
    # A thread per hypothesis, 32 per block, no spill: its float64 instance's
    # 40-byte stack frame is cos's argument reduction (ptxas: 0 bytes spill
    # stores), as in the crosswire residual's kernel.
    shape = kernels.PHANTOM_RITZ.shape(num_hyp)
    assert shape["threads"] == shape["hyp_per_block"] == 32
    assert shape["spill_bytes"] <= 40 and 0 < shape["registers"] <= 255
    assert shape["blocks"] == -(-num_hyp // 32) and shape["blocks_per_sm"] >= 8


@pytest.mark.cuda
def test_phantom_fit_rejects_duplicate_samples_on_card(cuda_device):
    rng = np.random.default_rng(8)
    planes = torch.as_tensor(rng.normal(size=(31, 14, 64)) * 50.0, device=cuda_device)
    planes[:] = planes[0:1].clone()                      # one observation in every slot
    before = kernels.PHANTOM_QR.launches, kernels.PHANTOM_RITZ.launches
    _, valid = us_fast._plane_phantom_fit_slots(planes, 31)
    assert (kernels.PHANTOM_QR.launches, kernels.PHANTOM_RITZ.launches) == (
        before[0] + 1, before[1] + 1)
    assert not bool(valid.any())


# ------------------------------------------- the host layers on the card


@pytest.mark.cuda
def test_samplers_on_a_cuda_generator_draw_on_the_card(cuda_device):
    from lsqrrecipes_tpu_torch.ransac import sampling

    def gen():
        return torch.Generator(device=cuda_device).manual_seed(3)

    for idx in (sampling.sample_k_subsets(gen(), 64, 4, 256),
                sampling.sample_k_with_replacement(gen(), 64, 4, 256),
                sampling.sample_k_subsets_chunked(gen(), 64, 4, 300, chunk=128),
                fs.draw_slot_perms(64, 2, gen()),
                sampling.sample_k_subsets(None, 64, 4, 8)):
        assert idx.is_cuda and idx.dtype == torch.int64
    # An explicit device moves the same draws there.
    assert torch.equal(sampling.sample_k_subsets(gen(), 64, 4, 256).cpu(),
                       sampling.sample_k_subsets(gen(), 64, 4, 256, device="cpu"))


@pytest.mark.cuda
def test_host_layers_default_to_the_card(cuda_device, tmp_path):
    from lsqrrecipes_tpu_torch import io, synthetic
    from lsqrrecipes_tpu_torch.examples.common import write_reference_format_data
    from lsqrrecipes_tpu_torch.utils import RandomNumberGenerator
    from lsqrrecipes_tpu_torch.viz import InventorScene

    rng, again = RandomNumberGenerator(4), RandomNumberGenerator(4, "cuda")
    u = rng.uniform(-1, 1, (100,))
    assert u.is_cuda and u.dtype == torch.float64 and torch.equal(u, again.uniform(-1, 1, (100,)))
    assert rng.key().device.type == "cuda"
    noisy, clean, truth = synthetic.make_crosswire_data(
        torch.Generator(device=cuda_device).manual_seed(1), n=64)
    assert noisy[0].r.is_cuda and clean[1].is_cuda and truth["t1"].is_cuda
    data_dir = write_reference_format_data(tmp_path, seed=2, n=40)
    path = data_dir / "pivotCalibrationDataWithOutliers.txt"
    frames, host = io.load_tracked_frames(path), io.load_tracked_frames(path, device="cpu")
    assert frames.r.is_cuda and frames.t.is_cuda
    torch.testing.assert_close(frames.r.cpu(), host.r, rtol=0, atol=1e-15)
    cw, pts = io.load_crosswire_phantom(data_dir / "crossWirePhantomTransformations.txt",
                                        data_dir / "crossWirePhantom2DPoints.txt")
    assert cw.r.is_cuda and isinstance(pts, np.ndarray)
    pts3 = torch.as_tensor(np.random.default_rng(0).normal(size=(5, 3)), device=cuda_device)
    scenes = [InventorScene().add_points(p).add_sphere(p[0], p[0, 0]) for p in (pts3, pts3.cpu())]
    for s, name in zip(scenes, ("card.iv", "host.iv")):
        s.write(tmp_path / name)
    assert (tmp_path / "card.iv").read_text() == (tmp_path / "host.iv").read_text()


@pytest.mark.cuda
def test_cli_bench_launches_the_sphere_sweep_twice_on_card(cuda_device, capsys):
    import json

    from lsqrrecipes_tpu_torch.cli import main

    kernels.reset_launch_counts()
    assert main(["bench", "--hypotheses", "65536", "--n", "256", "--device", "cuda"]) == 0
    assert kernels.launch_counts()["fused_sweep_sphere3d"] == 2
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["center_error"] < 1.0 and payload["inlier_fraction"] >= 0.75


@pytest.mark.cuda
def test_sphere_example_launches_the_sphere_vote_on_card(cuda_device, tmp_path, monkeypatch):
    from lsqrrecipes_tpu_torch.examples import sphere_estimation

    monkeypatch.chdir(tmp_path)
    kernels.reset_launch_counts()
    assert sphere_estimation.main(["--device", "cuda"]) == 0
    assert kernels.launch_counts()["sphere_vote"] >= 1
    assert (tmp_path / "RANSACSphereEstimation.iv").exists()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sphere", "plane", "line3d", "line2d", "absolute_orientation"])
def test_far_refit_in_float64_on_card_equals_cpu(cuda_device, kind):
    """A float32 cloud 1e4 from the origin: the card's float64 statistics
    equal the CPU's within 1e-12 relative, and its float64 params (the
    refit before the cast) within half a float32 ulp, 3e-8, of each block's
    scale (a direction or quaternion up to sign).  The params cannot be held
    closer: moments 1e4 from the origin keep about nine digits after
    ``outer - s s^T / n``, and the same refit on the CPU with the rows
    permuted moves Horn's t by 1.1e-8 of its scale and the plane normal by
    2e-9."""
    from test_torch_far_refits import SIGNED, far_data, make_est, shift, to_torch

    from lsqrrecipes_tpu_torch.tree import tree_leaves

    est = make_est(kind)
    leaves, mask = far_data(kind, 19, outliers=True)
    f32 = [x.astype(np.float32) for x in shift(kind, leaves, 1e4)]
    m_card, m_host = torch.as_tensor(mask, device=cuda_device), torch.as_tensor(mask)
    if est.has_stats:
        card = est.lsq_stats(to_torch(kind, f32, device=cuda_device), m_card)
        host = est.lsq_stats(to_torch(kind, f32), m_host)
        for a, b in zip(tree_leaves(card)[:-1], tree_leaves(host)[:-1]):
            assert a.is_cuda and a.dtype == torch.float64
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-12, atol=0)
        assert tree_leaves(card)[-1].dtype == torch.float32    # the data's dtype tag
    got, gvalid = est.lsq_fit(to_torch(kind, f32, torch.float64, cuda_device), m_card)
    want, wvalid = est.lsq_fit(to_torch(kind, f32, torch.float64), m_host)
    assert got.is_cuda and got.dtype == torch.float64 and bool(gvalid) and bool(wvalid)
    got, want = got.cpu().numpy(), want.numpy()
    k = SIGNED[kind]
    if k and np.dot(got[:k], want[:k]) < 0:
        got[:k] = -got[:k]
    for block in (slice(0, k), slice(k, None)) if k else (slice(None),):
        scale = np.abs(want[block]).max()
        np.testing.assert_allclose(got[block], want[block], rtol=0, atol=3e-8 * scale)


# ----------------------------------------------------- crosswire residual


def _crosswire_cell_data(seed, n=1024):
    """The crosswire cell's data model on the CPU, float64: n tracked images
    with pixel noise 0.5, the last 20% of the poses shoved 30-80 mm per
    axis; the consensus mask leaves those out.  ``(data, mask, x)`` with
    ``x`` the analytic fit on the mask moved by 0.01 per parameter."""
    from lsqrrecipes_tpu_torch.estimators.us_calibration import (
        ANALYTIC, CrosswireUSCalibrationEstimator)
    from lsqrrecipes_tpu_torch.synthetic import make_crosswire_data

    g = torch.Generator().manual_seed(seed)
    (frames, q), _, _ = make_crosswire_data(g, n=n, sigma=0.5, device="cpu")
    n_out = n // 5
    shift = (30.0 + 50.0 * torch.rand((n_out, 3), generator=g, dtype=torch.float64)) * torch.sign(
        torch.randn((n_out, 3), generator=g, dtype=torch.float64))
    t = frames.t.clone()
    t[n - n_out:] += shift
    data = (Frame(frames.r, t), q)
    mask = torch.arange(n) < n - n_out
    x = CrosswireUSCalibrationEstimator(3.0, ANALYTIC).lsq_fit(data, mask)[0][:11]
    return data, mask, x + 0.01 * torch.randn(11, generator=g, dtype=torch.float64)


def _stack_problems(problems):
    datas = [p[0] for p in problems]
    data = (Frame(torch.stack([d[0].r for d in datas]), torch.stack([d[0].t for d in datas])),
            torch.stack([d[1] for d in datas]))
    return data, torch.stack([p[1] for p in problems]), torch.stack([p[2] for p in problems])


def test_crosswire_kernel_wrapper_refuses_what_the_kernel_cannot_take():
    from lsqrrecipes_tpu_torch.estimators import us_calibration as usc

    data, _, x = _crosswire_cell_data(40, n=16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        usc._crosswire_cuda(x, data, jacobian=True)
    with pytest.raises(ValueError, match="leading axes"):
        usc._crosswire_cuda(torch.stack([x, x]), _stack_problems([(data, x, x)] * 3)[0], False)
    with pytest.raises(ValueError, match="leading axes"):
        usc._crosswire_cuda(torch.stack([x, x]), data, jacobian=True)
    with pytest.raises(ValueError, match="x\\[..., 11\\]"):
        usc._crosswire_cuda(x[:8], data, jacobian=False)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4])
def test_crosswire_residual_kernel_matches_plain_on_card(cuda_device, b):
    """The cell's shape, n = 1,024 with 20% masked: the kernel's masked
    residual and Jacobian within 1e-13 of each output's scale of the plain
    version's on the CPU in float64, equal bit for bit to the plain
    version's on the card (the same operations in the same order, and the
    card's sin and cos), and two calls equal bit for bit; one launch a
    call, B problems included."""
    from lsqrrecipes_tpu_torch.estimators import us_calibration as usc

    problems = [_crosswire_cell_data(41 + i) for i in range(b)]
    data, mask, x = problems[0] if b == 1 else _stack_problems(problems)
    card = tree_map(lambda t: t.to(cuda_device), (data, mask, x))
    m = torch.repeat_interleave(mask, 3, dim=-1).to(torch.float64)
    for fn, plain, mm in ((usc._crosswire_residual, usc._crosswire_residual_plain, m),
                          (usc._crosswire_jacobian, usc._crosswire_jacobian_plain, m[..., None])):
        before = kernels.US_CROSSWIRE.launches
        got, again = fn(card[2], card[0]), fn(card[2], card[0])
        assert kernels.US_CROSSWIRE.launches == before + 2
        assert got.is_cuda and got.dtype == torch.float64 and torch.equal(got, again)
        assert torch.equal(got, plain(card[2], card[0]))
        want = plain(x, data) * mm
        assert got.shape == want.shape
        got = got.cpu() * mm
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-13 * scale


@pytest.mark.cuda
def test_crosswire_iterative_fit_on_card_equals_cpu(cuda_device):
    """One crosswire ITERATIVE ``lsq_fit`` on the card: its params within
    1e-10 of the CPU fit's (relative to max(|p|, 1)), and the kernel
    launched once for the LM's first cost and three times a step."""
    from lsqrrecipes_tpu_torch.estimators.us_calibration import CrosswireUSCalibrationEstimator
    from lsqrrecipes_tpu_torch.utils import profiling

    data, mask, _ = _crosswire_cell_data(45)
    est = CrosswireUSCalibrationEstimator(3.0)
    want, wvalid = est.lsq_fit(data, mask)
    card = tree_map(lambda t: t.to(cuda_device), (data, mask))
    before = kernels.US_CROSSWIRE.launches
    profiling.reset()
    was = profiling.set_tracing(True)
    try:
        got, gvalid = est.lsq_fit(*card)
        torch.cuda.synchronize()
        recs = profiling.records()
    finally:
        profiling.set_tracing(was)
        profiling.reset()
    (steps,) = [r for r in recs if r.name == "lm.steps"]
    assert kernels.US_CROSSWIRE.launches - before == 1 + 3 * steps.value
    assert bool(gvalid) and bool(wvalid) and got.is_cuda
    got = got.cpu()
    assert float(((got - want).abs() / want.abs().clamp_min(1.0)).max()) <= 1e-10


@pytest.mark.cuda
def test_crosswire_residual_kernel_takes_float32_on_card(cuda_device):
    """A float32 input launches the float instantiation, within 1e-5 of
    each output's scale of the float64 plain version."""
    from lsqrrecipes_tpu_torch.estimators import us_calibration as usc

    data, _, x = _crosswire_cell_data(46)
    card = tree_map(lambda t: t.to(cuda_device, torch.float32), (data, x))
    before = kernels.US_CROSSWIRE.launches
    r, j = usc._crosswire_residual(card[1], card[0]), usc._crosswire_jacobian(card[1], card[0])
    assert kernels.US_CROSSWIRE.launches == before + 2
    assert r.dtype == j.dtype == torch.float32
    for got, want in ((r, usc._crosswire_residual_plain(x, data)),
                      (j, usc._crosswire_jacobian_plain(x, data))):
        scale = float(want.abs().max())
        assert float((got.cpu().double() - want).abs().max()) <= 1e-5 * scale
    with pytest.raises(ValueError, match="one dtype"):
        usc._crosswire_jacobian(card[1].double(), card[0])
    with pytest.raises(ValueError, match="must be float32 or float64, got torch.float16"):
        usc._crosswire_residual(card[1].half(), tree_map(lambda t: t.half(), card[0]))
    with pytest.raises(ValueError, match="must be float32, got torch.float64"):
        kernels.check_inputs(x=card[1].double())      # every other kernel: float32 alone
