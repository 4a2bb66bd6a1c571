"""The problem's work in a crosswire calibration sweep, frozen.

Per hypothesis-point cell, 40 f32 operations: the three residual
components, each five multiplies, five adds and a subtraction, their
squared norm (three multiplies, two adds), a compare and a count.  Per
hypothesis, 3,905: the 12 x 12 minimal system of four images (84), its
equilibrated Householder solve (3,464) and the scaled columns made
orthonormal by five polar steps with their gates (357).  Each observation
is read once: a pose (twelve float32) and a pixel (two).
"""

OPS_PER_CELL = 40
OPS_PER_HYPOTHESIS = 3905
BYTES_PER_POINT = 56


def work(hypotheses, points):
    """``(operations, bytes)`` of a sweep of ``hypotheses`` over ``points``."""
    return (hypotheses * points * OPS_PER_CELL + hypotheses * OPS_PER_HYPOTHESIS,
            points * BYTES_PER_POINT)
