"""Global numeric constants (counterpart of ``lsqrrecipes_tpu/config.py``).

The reference library is double-precision C++ with one global epsilon for
every rank/degeneracy decision (``common/Epsilon.h:19``).  PyTorch has no
global precision switch: functions that need float64 ask for it.
"""

# common/Epsilon.h:19 — DBL_EPSILON, used to zero out singular values before
# rank decisions everywhere in the reference.
EPS: float = 2.220446049250313e-16

# parametersEstimators/SphereParametersEstimator.hxx:11 — singularity gate on
# the determinant of the minimal-sample linear system.
SPHERE_EPS: float = 1e-9

# common/Frame.cxx:7-12 — constants used by the rotation-representation code
# and the gimbal-zone guards of every Euler extraction.
SMALL_ANGLE: float = 0.008726535498373935  # 0.5 degrees in radians
HALF_PI: float = 1.5707963267948966192313216916398
