"""The port's kernel build/loader and its CUDA kernels.

The loader tests run on the CPU with fakes in place of ``nvcc`` and the
built library.  The ``cuda``-marked tests need a card and skip without one;
this file imports neither JAX nor the JAX package, so on a machine with the
card and no JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

from lsqrrecipes_tpu_torch import kernels
from lsqrrecipes_tpu_torch.ops import fused_sweep as fs
from lsqrrecipes_tpu_torch.ops import vote

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
        assert "Replaces lsqrrecipes_tpu/ops/" in text
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
    assert finished == ["fused_sweep_sphere3d", "sphere_vote"]


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
    kc, kp, ki = fs.sphere3d_sweep(coords, p, nf, groups, cols, 1.0)
    pc, pp, pi = fs.sphere3d_sweep_plain(coords, p, nf, groups, cols, 1.0)
    assert kernels.FUSED_SWEEP_SPHERE3D.launches == before + 1
    assert abs(int(kc) - int(pc)) <= 1
    if int(ki) == int(pi):
        assert torch.equal(kp, pp)
