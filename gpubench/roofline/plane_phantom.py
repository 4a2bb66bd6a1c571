"""The problem's work in the plane phantom's subspace kernel (B6,
``csrc/phantom_qr.cu``), frozen.

Per hypothesis, 62,327 f32 operations, counted from the kernel's loops over
the 31 live rows (``chip_smoke.phantom_qr_ops``): the Householder QR of the
31 x 31 system (step j, of m = 31 - j rows, takes 2m for its norm and 6 for
the pivot, then 4m + 1 for each of the 31 - j columns it updates), the
diagonal clamp (3 a pivot), and two steps of block inverse iteration on
four vectors (each a forward and a backward triangular solve, a
normalisation and Gram-Schmidt).  Bytes per hypothesis: the f32 system
packed as ``[31, 32]`` (the pad row included) read once, and the ``[4,
31]`` f32 subspace written.  The number of images does not enter: each
hypothesis is its own 31 x 31 system.
"""

OPS_PER_HYPOTHESIS = 62327
BYTES_PER_HYPOTHESIS = 31 * 32 * 4 + 4 * 31 * 4


def work(hypotheses, points):
    """``(operations, bytes)`` of B6 over ``hypotheses`` systems (``points``,
    the images, does not enter)."""
    return hypotheses * OPS_PER_HYPOTHESIS, hypotheses * BYTES_PER_HYPOTHESIS
