"""The problem's work in a 3D sphere sweep, frozen.

Per hypothesis-point cell, 11 f32 operations: the band test of one point
against one sphere as four multiply-adds (two each), an absolute value, a
compare and a count.  Per hypothesis, 115: the four-point Cramer
circumsphere and its band rows.  Each observation is read once, three
float32 coordinates.
"""

OPS_PER_CELL = 11
OPS_PER_HYPOTHESIS = 115
BYTES_PER_POINT = 12


def work(hypotheses, points):
    """``(operations, bytes)`` of a sweep of ``hypotheses`` over ``points``."""
    return (hypotheses * points * OPS_PER_CELL + hypotheses * OPS_PER_HYPOTHESIS,
            points * BYTES_PER_POINT)
