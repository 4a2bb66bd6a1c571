"""lsqrrecipes_tpu_torch — the PyTorch/CUDA port of ``lsqrrecipes_tpu``.

Module paths and public names mirror the JAX package, so each function has
an obvious counterpart there.  Differences of idiom:

  * plain functions on tensors with explicit dtypes: there is no global x64
    switch, float64 is requested where the JAX package relies on
    ``jax_enable_x64``;
  * an explicit ``device``: entry points put numpy input on ``"cuda"``
    unless the caller asks for ``"cpu"``, keep tensor input on its own
    device, and raise when CUDA is missing instead of falling back;
  * a ``torch.Generator`` wherever the JAX package takes a ``key``;
  * every Pallas kernel on the ported path is a hand-written CUDA kernel
    (``csrc/``) behind a wrapper that launches it on CUDA tensors and runs
    its plain PyTorch version only on CPU tensors.

The package imports ``torch`` and numpy, never ``jax`` and never the JAX
package.
"""

from lsqrrecipes_tpu_torch.config import EPS, SPHERE_EPS

__version__ = "0.1.0"

__all__ = ["EPS", "SPHERE_EPS", "__version__"]
