"""Checkpoint and resume of long sweeps: ``lsqrrecipes_tpu_torch.ransac.
checkpoint`` (the counterpart of ``tests/test_checkpoint.py`` and of phase 2
of ``tests/multiprocess_worker.py``).

The two packages' random streams differ (a threefry key there, a
``torch.Generator`` state here), so these tests hold the port to the JAX
package's contract and, on the indices the port draws, to its vote: an
interrupted sweep resumed from its ``.npz`` equals the uninterrupted one in
``evaluated``, ``best_count``, mask and params; both equal the JAX
package's ``hypothesize_and_vote`` on each round's indices, folded round by
round with the first round of the highest count winning; the carried
stream after r rounds does not depend on the batch size; in a two-process
gloo group only rank 0 writes and both processes resume to the
uninterrupted result; and a checkpoint written by the JAX package is
refused.  The worker function lives at module level and this module
imports JAX only inside the tests that need it.
"""

import datetime
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from lsqrrecipes_tpu_torch.estimators import Line2DEstimator, SphereEstimator
from lsqrrecipes_tpu_torch.ransac import engine
from lsqrrecipes_tpu_torch.ransac.checkpoint import (
    distributed_barrier,
    distributed_process_index,
    load_state,
    resumable_sweep,
    save_state,
)

JOIN_TIMEOUT_S = 120


def line_points(seed=0, n=100):
    """``tests/test_ransac.py``'s outlier line model: 80% on a line, 20% uniform."""
    rng = np.random.default_rng(seed)
    n_out = n // 5
    t = rng.uniform(-40.0, 40.0, (n - n_out, 1))
    inl = np.array([-2.0, 5.0]) + t * np.array([0.8, 0.6]) + 0.3 * rng.normal(size=(n - n_out, 2))
    return torch.as_tensor(np.concatenate([inl, rng.uniform(-40.0, 40.0, (n_out, 2))]))


def sphere_points(seed=1, n=256):
    """The bench's sphere model in float32, whose votes go through the
    sphere vote kernel's path (its plain version here)."""
    rng = np.random.default_rng(seed)
    n_in = n * 4 // 5
    d = rng.normal(size=(n_in, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inl = np.array([5.0, -2.0, 11.0]) + 25.0 * d + 0.3 * rng.normal(size=(n_in, 3))
    return torch.as_tensor(np.concatenate([inl, rng.uniform(-40.0, 40.0, (n - n_in, 3))]),
                           dtype=torch.float32)


CASES = {
    "line2d": (lambda: Line2DEstimator(1.5), line_points, 2048, 512),
    "sphere": (lambda: SphereEstimator(1.0, 3), sphere_points, 4096, 1024),
}


def assert_same_sweep(got, want):
    assert got.evaluated == want.evaluated
    assert got.best_count == want.best_count
    assert torch.equal(got.rng_state, want.rng_state)
    assert torch.equal(got.best_mask, want.best_mask)
    assert torch.equal(got.best_params, want.best_params)


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_resume_equivalence(tmp_path, case):
    make_est, make_data, total, batch = CASES[case]
    est, pts = make_est(), make_data()
    gen = torch.Generator().manual_seed(7)
    full = resumable_sweep(est, pts, gen, total_hypotheses=total, batch_size=batch)

    ckpt = str(tmp_path / "sweep.npz")
    resumable_sweep(est, pts, gen, total_hypotheses=2 * batch, batch_size=batch,
                    checkpoint_path=ckpt)                   # interrupted after 2 rounds
    assert load_state(ckpt).evaluated == 2 * batch
    resumed = resumable_sweep(est, pts, gen, total_hypotheses=total, batch_size=batch,
                              checkpoint_path=ckpt)
    assert_same_sweep(resumed, full)
    assert full.evaluated == total and full.best_count > pts.shape[0] // 2
    assert torch.equal(full.best_mask, est.agree(full.best_params, pts))
    params, ok = engine.consensus_refit(est, pts, resumed.best_mask)
    assert bool(ok) and bool(torch.isfinite(params).all())


def jax_fold(case, pts, rounds):
    """The JAX package's ``hypothesize_and_vote`` on each round's indices,
    folded as its ``resumable_sweep`` folds rounds: the first round with the
    highest count keeps its count, mask and params."""
    import jax.numpy as jnp

    from lsqrrecipes_tpu import estimators as jestimators
    from lsqrrecipes_tpu.ransac import engine as jengine

    est = {"line2d": lambda: jestimators.Line2DEstimator(1.5),
           "sphere": lambda: jestimators.SphereEstimator(1.0, 3)}[case]()
    best = (-1, None, None)
    for idx in rounds:
        count, mask, params = jengine.hypothesize_and_vote(est, jnp.asarray(pts.numpy()),
                                                           jnp.asarray(idx.numpy()))
        if int(count) > best[0]:
            best = (int(count), np.asarray(mask), np.asarray(params))
    return best


@pytest.mark.parametrize("resumed", [False, True], ids=["uninterrupted", "resumed"])
@pytest.mark.parametrize("case", list(CASES))
def test_sweep_result_matches_the_jax_package_on_its_indices(monkeypatch, tmp_path, case,
                                                            resumed):
    """The streams differ, so the ``[b, k]`` indices the port draws each
    round are recorded and the JAX package's vote is folded over them: the
    port's best count and mask are equal to that fold, its params within the
    JAX parity tests' tolerance (1e-10 in f64, 1e-5 in f32)."""
    make_est, make_data, total, batch = CASES[case]
    est, pts = make_est(), make_data()
    rounds, sample = [], engine._sample
    monkeypatch.setattr(engine, "_sample",
                        lambda *args, **kw: rounds.append(sample(*args, **kw)) or rounds[-1])
    gen = torch.Generator().manual_seed(7)
    if resumed:
        ckpt = str(tmp_path / "sweep.npz")
        resumable_sweep(est, pts, gen, total_hypotheses=2 * batch, batch_size=batch,
                        checkpoint_path=ckpt)
        state = resumable_sweep(est, pts, gen, total_hypotheses=total, batch_size=batch,
                                checkpoint_path=ckpt)
    else:
        state = resumable_sweep(est, pts, gen, total_hypotheses=total, batch_size=batch)
    assert [tuple(idx.shape) for idx in rounds] == [(batch, est.k)] * (total // batch)
    count, mask, params = jax_fold(case, pts, rounds)
    assert state.best_count == count
    np.testing.assert_array_equal(state.best_mask.numpy(), mask)
    tol = 1e-10 if pts.dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(state.best_params.numpy(), params, rtol=tol, atol=tol)


def test_state_roundtrip(tmp_path):
    est, pts = Line2DEstimator(1.5), line_points(1)
    state = resumable_sweep(est, pts, torch.Generator().manual_seed(3), total_hypotheses=512)
    path = str(tmp_path / "s.npz")
    save_state(path, state)
    loaded = load_state(path)
    assert_same_sweep(loaded, state)
    assert loaded.rng_state.dtype == torch.uint8 and loaded.best_params.dtype == torch.float64
    assert load_state(str(tmp_path / "absent.npz")) is None
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]   # the temporary file was renamed


def test_stream_does_not_depend_on_the_batch_size():
    """After r rounds the carried generator stands where r rounds leave it,
    whatever each round drew; a seed and a generator seeded alike are one
    stream, and the caller's generator is not advanced."""
    est, pts = Line2DEstimator(1.5), line_points(2)
    gen = torch.Generator().manual_seed(11)
    before = gen.get_state()
    small = resumable_sweep(est, pts, gen, total_hypotheses=2 * 128, batch_size=128)
    large = resumable_sweep(est, pts, gen, total_hypotheses=2 * 512, batch_size=512)
    assert torch.equal(small.rng_state, large.rng_state)
    assert torch.equal(gen.get_state(), before)
    from_seed = resumable_sweep(est, pts, 11, total_hypotheses=2 * 512, batch_size=512)
    assert torch.equal(from_seed.rng_state, large.rng_state)
    assert from_seed.best_count == large.best_count
    three = resumable_sweep(est, pts, gen, total_hypotheses=3 * 128, batch_size=128)
    assert not torch.equal(three.rng_state, small.rng_state)


def test_load_state_refuses_a_jax_checkpoint(tmp_path):
    import jax

    from lsqrrecipes_tpu.ransac import checkpoint as jcheckpoint

    path = str(tmp_path / "jax.npz")
    jcheckpoint.save_state(path, jcheckpoint.new_state(jax.random.PRNGKey(0), 100, 4))
    with pytest.raises(ValueError, match="JAX PRNG key"):
        load_state(path)
    with pytest.raises(ValueError, match="JAX PRNG key"):
        resumable_sweep(Line2DEstimator(1.5), line_points(), 0, 512, checkpoint_path=path)


def test_no_group_means_one_writer_and_no_barrier():
    assert not torch.distributed.is_initialized()
    assert distributed_process_index() == 0
    distributed_barrier()


def _two_rank_worker(rank, world, store, ckpt, out_dir):
    """Phase 2 of ``tests/multiprocess_worker.py``: both processes run the
    same sweep; a checkpointed run is cut after one round, only rank 0 may
    write, the barrier lets rank 1 read the file, and both resume."""
    from lsqrrecipes_tpu_torch.parallel import initialize_distributed
    from lsqrrecipes_tpu_torch.ransac import checkpoint

    writes = []
    save = checkpoint.save_state
    checkpoint.save_state = lambda path, state: (writes.append(state.evaluated), save(path, state))
    torch.set_num_threads(1)
    initialize_distributed(f"file://{store}", world, rank, device_type="cpu",
                           timeout=datetime.timedelta(seconds=60))
    assert distributed_process_index() == rank
    est, pts = Line2DEstimator(0.5), line_points(3, 512)
    full = resumable_sweep(est, pts, 11, total_hypotheses=1024, batch_size=256)
    resumable_sweep(est, pts, 11, total_hypotheses=256, batch_size=256, checkpoint_path=ckpt)
    distributed_barrier()
    first = load_state(ckpt).evaluated
    distributed_barrier()               # every read is done before rank 0 writes again
    resumed = resumable_sweep(est, pts, 11, total_hypotheses=1024, batch_size=256,
                              checkpoint_path=ckpt)
    distributed_barrier()
    out = {"writes": writes, "first": first, "full": full, "resumed": resumed}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def test_two_processes_one_writer_both_resume(tmp_path):
    ckpt = str(tmp_path / "sweep_state.npz")
    ctx = mp.start_processes(_two_rank_worker, args=(2, str(tmp_path / "store"), ckpt,
                                                     str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                raise TimeoutError(f"2 ranks did not finish within {JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    outs = []
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    assert outs[0]["writes"] == [256, 256, 512, 768, 1024, 1024] and outs[1]["writes"] == []
    for out in outs:
        assert out["first"] == 256
        assert_same_sweep(out["resumed"], out["full"])
        assert_same_sweep(out["resumed"], outs[0]["resumed"])
    assert load_state(ckpt).evaluated == 1024
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
