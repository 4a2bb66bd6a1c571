"""Symmetric eigensystem helpers (counterpart of
``lsqrrecipes_tpu/linalg/eig.py``).

``torch.linalg.eigh`` returns eigenvalues in ascending order, as
``jnp.linalg.eigh`` and ``vnl_symmetric_eigensystem`` do, in the input's
dtype.  The sign of an eigenvector is not fixed in either package.
"""

import torch


def eigvec_smallest(a):
    """Unit eigenvector of the smallest eigenvalue of symmetric ``a[..., n, n]``."""
    _, v = torch.linalg.eigh(a)
    return v[..., :, 0]


def eigvec_largest(a):
    """Unit eigenvector of the largest eigenvalue of symmetric ``a[..., n, n]``."""
    _, v = torch.linalg.eigh(a)
    return v[..., :, -1]
