"""Process-group initialisation and named device meshes (counterpart of
``lsqrrecipes_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the world,
row-major: the process of rank ``r`` sits at ``(r // d_size, r % d_size)`` of
a ``(hypotheses, data)`` mesh.  The backend follows the device type and is
never switched: NCCL for ``"cuda"``, gloo for ``"cpu"``.
"""

import datetime
import math
import os
import warnings
from typing import Optional, Sequence

import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

# torchrun's environment (``env://``): the variables init_process_group reads.
_ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
    timeout: Optional[datetime.timedelta] = None,
):
    """Join (or form) the process group of a multi-process run.

    With explicit arguments (``coordinator_address`` an init method such as
    ``tcp://host:port`` or ``file:///path``, or a bare ``host:port``; the
    world size and this process's rank) any failure RAISES: a misconfigured
    job must not go on as a single process.  With none, the group is formed
    from ``torchrun``'s environment (``env://``) where it is set; otherwise
    this warns and the caller goes on in a single process.  Does nothing
    when a group exists already.
    """
    if dist.is_initialized():
        return
    if device_type not in BACKENDS:
        raise ValueError(f"no backend for device type {device_type!r}")
    backend = BACKENDS[device_type]
    if coordinator_address is None and num_processes is None and process_id is None:
        missing = [v for v in _ENV_VARS if v not in os.environ]
        if missing:
            warnings.warn(
                "no process group requested and no torchrun environment "
                f"({', '.join(missing)} unset); continuing in a single process",
                RuntimeWarning,
                stacklevel=2,
            )
            return
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("pass coordinator_address, num_processes and process_id together")
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=coordinator_address, timeout=timeout,
                            world_size=int(num_processes), rank=int(process_id))


def default_mesh(
    axis_names: Sequence[str] = ("hypotheses", "data"),
    shape: Optional[Sequence[int]] = None,
    device_type: str = "cuda",
):
    """A mesh over every process of the group with named RANSAC axes.

    By default every process goes to ``hypotheses`` (the embarrassingly
    parallel direction); ``shape=(h, d)`` splits the world between
    hypothesis and observation parallelism, and the vote counts and refit
    statistics are then Sum-reduced over ``data``.  Raises when no process
    group is initialised.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed first")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} does not name axes {tuple(axis_names)}")
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} does not cover the {world} processes")
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    """The number of processes along ``axis`` (1 when the mesh has no such axis)."""
    if axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This process's coordinate along ``axis`` (0 when the mesh has no such axis)."""
    if axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def axis_group(mesh, axis: str):
    """The process group of the processes that share every coordinate but
    ``axis``'s."""
    return mesh.get_group(mesh.mesh_dim_names.index(axis))
