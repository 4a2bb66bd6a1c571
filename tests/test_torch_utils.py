"""``lsqrrecipes_tpu_torch.utils`` and the samplers' device rule.

``RandomNumberGenerator`` is seeded per device and does not reproduce JAX's
threefry draws, so it is checked on its own terms: reproducibility, ranges,
shapes and dtype.  The profiler window must trace on the CPU, the
program's leaves among its ranges (the CUDA activity and the kernel names
are the card's to check).  The
samplers run where their generator is when no device is given, and
``sample_k_subsets_chunked`` draws one seed per chunk.
"""

import json
import os

import pytest
import torch

from lsqrrecipes_tpu_torch.linalg import LMConfig, lm_core
from lsqrrecipes_tpu_torch.ops import fused_sweep as fs
from lsqrrecipes_tpu_torch.ransac import sampling
from lsqrrecipes_tpu_torch.utils import RandomNumberGenerator, profiling
from lsqrrecipes_tpu_torch.utils.profiling import trace


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")


def test_rng_reproducible_per_seed():
    a, b, c = (RandomNumberGenerator(s, "cpu") for s in (5, 5, 6))
    draws = [(r.uniform(-2, 3, (4, 3)), r.normal(0.5, 1.0, (6,))) for r in (a, b, c)]
    assert torch.equal(draws[0][0], draws[1][0]) and torch.equal(draws[0][1], draws[1][1])
    assert not torch.equal(draws[0][0], draws[2][0])


@pytest.mark.parametrize("shape", [(), 5, (3, 4)], ids=["scalar", "int", "tuple"])
def test_rng_ranges_shapes_dtype(shape):
    rng = RandomNumberGenerator(1, "cpu")
    want = () if shape == () else ((shape,) if isinstance(shape, int) else shape)
    u = rng.uniform(-100, 100, shape)
    z = rng.normal(2.0, -1.0, shape)
    assert u.shape == want and z.shape == want
    assert u.dtype == z.dtype == torch.float64 and u.device.type == "cpu"
    big_u = rng.uniform(20, 60, (20000,))
    assert float(big_u.min()) >= 20.0 and float(big_u.max()) < 60.0
    big_z = rng.normal(2.0, -1.0, (20000,))
    assert abs(float(big_z.mean()) + 1.0) < 0.1 and abs(float(big_z.std()) - 2.0) < 0.1


def test_rng_key_is_a_fresh_generator():
    rng = RandomNumberGenerator(2, "cpu")
    k1, k2 = rng.key(), rng.key()
    assert isinstance(k1, torch.Generator) and k1.device.type == "cpu"
    assert not torch.equal(torch.rand(4, generator=k1), torch.rand(4, generator=k2))
    again = RandomNumberGenerator(2, "cpu").key()
    assert torch.equal(torch.rand(4, generator=again),
                       torch.rand(4, generator=RandomNumberGenerator(2, "cpu").key()))


def test_rng_defaults_to_cuda():
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RandomNumberGenerator(0)


def test_trace_writes_a_chrome_trace(tmp_path):
    """The window turns program tracing on, so the program's spans are
    ranges of the written trace, and leaves it as it found it: off, with an
    empty log."""
    log_dir = str(tmp_path / "trace")
    target = torch.tensor([1.0, 2.0], dtype=torch.float64)
    with trace(log_dir) as where:
        torch.randn(64, 64) @ torch.randn(64, 64)
        lm_core(lambda x: (torch.eye(2, dtype=x.dtype), x - target),
                lambda x: 0.5 * torch.sum((x - target) ** 2),
                torch.zeros(2, dtype=torch.float64), LMConfig(max_iters=2))
    assert where == log_dir
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert len(events) > 0
    assert {"lsqr.lm", "lsqr.lm.step", "lsqr.lm.normal", "lsqr.lm.solve"} <= {
        e.get("name") for e in events}
    assert profiling.set_tracing(False) is False and profiling.records() == []


def test_chunked_sampler_ragged_distinct_reproducible():
    n, k, num, chunk = 30, 4, 10, 4
    idx = sampling.sample_k_subsets_chunked(torch.Generator().manual_seed(8), n, k, num, chunk)
    assert idx.shape == (num, k) and idx.dtype == torch.int64 and idx.device.type == "cpu"
    assert int(idx.min()) >= 0 and int(idx.max()) < n
    assert all(len(set(row)) == k for row in idx.tolist())
    again = sampling.sample_k_subsets_chunked(torch.Generator().manual_seed(8), n, k, num, chunk)
    assert torch.equal(idx, again)
    # One seed per chunk, drawn first; then each chunk from its own generator.
    gen = torch.Generator().manual_seed(8)
    seeds = torch.randint(0, 2**62, (3,), generator=gen).tolist()
    rows = [sampling.sample_k_subsets(torch.Generator().manual_seed(s), n, k, m)
            for s, m in zip(seeds, (4, 4, 2))]
    assert torch.equal(idx, torch.cat(rows))


@pytest.mark.parametrize("which", ["subsets", "with_replacement", "slot_perms"])
def test_samplers_follow_the_generator_device(which):
    """A CPU generator and no device gives CPU indices equal, bit for bit,
    to the draws the samplers made before ``device`` defaulted to None."""
    def draw(gen, **kw):
        if which == "subsets":
            return sampling.sample_k_subsets(gen, 40, 4, 64, **kw)
        if which == "with_replacement":
            return sampling.sample_k_with_replacement(gen, 40, 4, 64, **kw)
        return fs.draw_slot_perms(40, 2, gen, **kw)

    got = draw(torch.Generator().manual_seed(4))
    old = torch.Generator().manual_seed(4)
    if which == "subsets":
        want = torch.topk(torch.rand((64, 40), generator=old), 4, dim=1).indices
    elif which == "with_replacement":
        want = torch.randint(0, 40, (64, 4), generator=old)
    else:
        want = torch.stack([torch.randperm(40, generator=old) for _ in range(8)])
    assert got.device.type == "cpu" and torch.equal(got, want)
    assert torch.equal(got, draw(torch.Generator().manual_seed(4), device="cpu"))


def test_samplers_without_generator_default_to_cuda():
    _no_cuda()
    for call in (lambda: sampling.sample_k_subsets(None, 10, 3, 4),
                 lambda: sampling.sample_k_with_replacement(None, 10, 3, 4),
                 lambda: sampling.sample_k_subsets_chunked(None, 10, 3, 4),
                 lambda: fs.draw_slot_perms(10, 1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
