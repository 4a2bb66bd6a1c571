"""Device resolution for the port's entry points.

Rule: numpy (or other non-tensor) input goes to ``"cuda"`` unless the caller
passes ``device="cpu"``; a tensor stays on its own device.  When CUDA is
asked for and is not available this raises — it never falls back to the CPU
silently.
"""

import contextlib

import numpy as np
import torch

from lsqrrecipes_tpu_torch.tree import tree_leaves, tree_map

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None, like=None) -> torch.device:
    """The device an entry point runs on.

    ``like``: the caller's data; a tensor fixes the device unless ``device``
    is given explicitly.  Raises ``RuntimeError`` for a CUDA device when
    CUDA is unavailable.
    """
    if device is None:
        device = like.device if isinstance(like, torch.Tensor) else DEFAULT_DEVICE
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or CPU tensors) to run "
            "the plain PyTorch versions on the host"
        )
    return dev


def as_tensor(data, device=None, dtype=None):
    """``data`` as a tensor on the resolved device (numpy dtype kept unless
    ``dtype`` is given).  A tuple or ``NamedTuple`` of leaves
    (:mod:`lsqrrecipes_tpu_torch.tree`) maps leaf by leaf onto the device
    its first leaf resolves to."""
    if isinstance(data, tuple):
        dev = resolve_device(device, tree_leaves(data)[0])
        return tree_map(lambda leaf: as_tensor(leaf, dev, dtype), data)
    dev = resolve_device(device, data)
    if isinstance(data, torch.Tensor):
        return data.to(device=dev, dtype=dtype or data.dtype)
    arr = np.asarray(data)
    if not arr.flags.writeable:      # e.g. a view of a JAX array
        arr = arr.copy()
    return torch.as_tensor(arr, device=dev, dtype=dtype)


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matrix products inside the block run in full float32 on
    CUDA, whatever the caller set: TF32 keeps about three decimal digits,
    which would move inlier-band edges."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def generator_device(generator, device) -> torch.device:
    """Where random draws are made: on the generator's own device when one
    is given (a CPU generator may drive CUDA work), else on ``device``."""
    return generator.device if generator is not None else torch.device(device)


def draw_devices(generator, device=None):
    """``(draw device, output device)`` of a sampler: ``device=None`` means
    the generator's device, or CUDA (:func:`resolve_device`, which raises
    without it) when there is no generator."""
    if device is None:
        device = generator.device if generator is not None else resolve_device()
    dev = torch.device(device)
    return generator_device(generator, dev), dev
