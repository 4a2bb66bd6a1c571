"""Checkpoint and resume of long RANSAC sweeps (counterpart of
``lsqrrecipes_tpu/ransac/checkpoint.py``).

A sweep runs in rounds of at most ``batch_size`` gathered hypotheses.  Its
state is the random stream's position, the hypotheses evaluated so far and
the best model: its count, consensus mask and minimal-fit parameters.  The
state round-trips through a plain ``.npz`` (the stream as the ``uint8``
state of a CPU ``torch.Generator``), so a sweep resumes across processes and
hosts and replays the uninterrupted one exactly.

The stream mirrors ``jax.random.split``: each round draws one seed from the
carried CPU generator, then samples its ``[b, k]`` indices from a fresh
generator with that seed on the data's device.  The carried state after r
rounds therefore does not depend on the batch size.

In a multi-process run every process runs the same sweep; only rank 0 of
the ``torch.distributed`` group (the only process, without a group) writes
the checkpoint, and every process reads it on resume (a shared file
system).  :func:`distributed_barrier` lets the processes wait for a write.
"""

import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from lsqrrecipes_tpu_torch.device import as_tensor
from lsqrrecipes_tpu_torch.tree import n_obs, tree_leaves


class SweepState(NamedTuple):
    rng_state: torch.Tensor     # uint8: the carried CPU generator's state
    evaluated: int              # hypotheses evaluated so far
    best_count: int
    best_mask: torch.Tensor     # [n] bool
    best_params: torch.Tensor   # the winning minimal-fit parameters


def distributed_process_index() -> int:
    """This process's rank in the ``torch.distributed`` group, 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def distributed_barrier() -> None:
    """Wait for every process of the group; nothing without a group."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _carried(generator) -> torch.Generator:
    """A CPU generator at ``generator``'s state (an int seeds one); the
    caller's generator is not advanced."""
    out = torch.Generator(device="cpu")
    if isinstance(generator, int):
        return out.manual_seed(generator)
    out.set_state(generator.get_state())
    return out


def new_state(generator, n, nparams, device=None, dtype=torch.float64):
    """The state before the first round: ``generator`` is a CPU
    ``torch.Generator`` (copied) or an int seed."""
    return SweepState(
        rng_state=_carried(generator).get_state(),
        evaluated=0,
        best_count=-1,
        best_mask=torch.zeros((n,), dtype=torch.bool, device=device),
        best_params=torch.zeros((nparams,), dtype=dtype, device=device),
    )


def save_state(path, state: SweepState):
    """Write ``state`` to ``path`` atomically: a temporary file of this
    process's own, then ``os.replace``, so even two writers never consume
    each other's temporary file."""
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            rng_state=state.rng_state.cpu().numpy(),
            evaluated=state.evaluated,
            best_count=state.best_count,
            best_mask=state.best_mask.cpu().numpy(),
            best_params=state.best_params.cpu().numpy(),
        )
    os.replace(tmp, path)


def load_state(path, device=None) -> Optional[SweepState]:
    """The state saved at ``path`` (tensors on ``device``, default the CPU),
    or None if there is no file.  A checkpoint written by the JAX package
    holds a threefry key, which no ``torch.Generator`` state can stand for:
    it is refused."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if "rng_state" not in z.files:
            raise ValueError(
                f"{path} holds no torch.Generator state"
                + (" (it holds a JAX PRNG key: a checkpoint of the JAX package's sweep, "
                   "which this package cannot resume)" if "key" in z.files else "")
            )
        return SweepState(
            rng_state=torch.as_tensor(z["rng_state"]),
            evaluated=int(z["evaluated"]),
            best_count=int(z["best_count"]),
            best_mask=torch.as_tensor(z["best_mask"], device=device),
            best_params=torch.as_tensor(z["best_params"], device=device),
        )


def resumable_sweep(
    est,
    data,
    generator,
    total_hypotheses: int,
    batch_size: int = 65536,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 1,
    *,
    device=None,
):
    """Run a fixed-total hypothesis sweep in rounds, checkpointing between.

    ``generator``: a CPU ``torch.Generator`` (its state is copied, not
    advanced) or an int seed.  Returns the final :class:`SweepState`; its
    ``best_mask`` is the consensus for
    :func:`lsqrrecipes_tpu_torch.ransac.engine.consensus_refit`.  If
    ``checkpoint_path`` exists, the sweep resumes from it and draws the
    same hypotheses the uninterrupted sweep would have drawn.
    """
    from lsqrrecipes_tpu_torch.ransac.engine import _sample, hypothesize_and_vote

    data = as_tensor(data, device)
    leaf = tree_leaves(data)[0]
    dev = leaf.device
    writer = distributed_process_index() == 0
    n = n_obs(data)
    state = load_state(checkpoint_path, dev) if checkpoint_path else None
    if state is None:
        state = new_state(generator, n, est.nparams, dev, leaf.dtype)
    carried = torch.Generator(device="cpu")
    carried.set_state(state.rng_state)

    rounds = 0
    while state.evaluated < total_hypotheses:
        seed = int(torch.randint(0, 1 << 62, (), generator=carried))
        b = min(batch_size, total_hypotheses - state.evaluated)
        idx = _sample(torch.Generator(device=dev).manual_seed(seed), n, est.k, b, "auto", dev)
        count, mask, params = hypothesize_and_vote(est, data, idx)
        if int(count) > state.best_count:
            state = state._replace(best_count=int(count), best_mask=mask, best_params=params)
        state = state._replace(rng_state=carried.get_state(), evaluated=state.evaluated + b)
        rounds += 1
        if writer and checkpoint_path and rounds % checkpoint_every == 0:
            save_state(checkpoint_path, state)
    if writer and checkpoint_path:
        save_state(checkpoint_path, state)
    return state
