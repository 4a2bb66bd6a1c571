#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``lsqrrecipes_tpu_torch/csrc/`` (into
``build/kernels/``), holds each kernel against its plain PyTorch version on
the card, then drives the ported paths through the entry points a user
calls, at full size.  The sphere runs on the bench's data model (80%
inliers on a radius-25 sphere at (5, -2, 11) with sigma 0.3, 20% uniform
outliers in [-40, 40]^3); planes and lines on the chip gate's
(``scripts/chip_check.py``: 80% inliers with N(0, 0.2) noise on the plane
through (2, -1, 4) spanned by (1, 0, 0.5) and (0, 1, -0.2), the 3D line
through (1, 2, -3) along (0.6, -0.64, 0.48), the 2D line through (-2, 5)
along (0.8, 0.6), 20% uniform outliers in [-40, 40]^d); all made by
``numpy.random.default_rng(seed)``, delta 1.0:

  1. device: card name and power limit;
  2. build: every kernel, one ``nvcc`` per source, all in parallel; the
     sphere3d, line3d and four rigid kernels' and the crosswire and pointer
     vote and fit kernels' registers, spills, blocks per SM and waves at the
     main path's shapes;
  3. kernel ``sphere_vote`` vs its plain version (B = 65,536 x n = 1,024;
     equal counts) and vs an f64 literal ``agree`` oracle, its registers,
     blocks per SM and waves; then on the cloud 1e4 from the origin
     (``FAR_OFFSET``): equal counts, the best within 1 of the f64 ``agree``
     maximum;
  4. kernel ``fused_sweep_sphere3d`` vs its plain version (n = 1,024 and
     1,000; 64 groups; groups_per_step 1 and 4; a vote_subsample run): equal
     counts and winner indices, bit-equal params; and so on the cloud 1e4
     from the origin, its best within 1 of the f64 maximum over the same
     samples (``minimal_fit`` + ``agree``);
  5. ``ransac_fused_sweep`` at n = 1,024 with 2^22 hypotheses (one launch),
     then ``fused_sweep_sphere3d`` vs its plain version at that shape, as in
     phase 4, its launch shape and its time on 1 column (the fit, staging
     and publishing without the vote);
  6. ``ransac`` at n = 1,024 with 65,536 gathered hypotheses;
  7. ``ransac_fused_sweep`` at n = 8,192 with 2^20 hypotheses, which falls
     back to the structured sweep and the vote kernel, then the vote kernel
     vs its plain version at B = 2^20 x n = 8,192 (equal counts), with its
     launch shape and the SM clock and power while it runs;
  8. kernels ``fused_sweep_plane3d``, ``fused_sweep_line3d`` and
     ``fused_sweep_line2d`` vs their plain versions on phase 4's cases
     (line3d: equal counts and winner indices, bit-equal params), and line3d
     on a cloud 1e4 from the origin, its best count within 1 of the float64
     ``agree`` maximum;
  9. per family, ``ransac_fused_sweep`` at n = 1,024 with 2^22 hypotheses
     (one launch), the ground truth recovered, then the kernel vs its plain
     version at that shape (line3d as in phase 8, with its launch shape);
 10. ``ransac`` with a plane at 65,536 gathered hypotheses (the engine's
     ``agree`` vote, no kernel) and ``ransac_adaptive`` with a 2D line (fused
     line2d rounds);
 11. kernel ``plane_vote`` through ``plane_vote_counts`` (B = 65,536 x
     n = 1,024 for d = 3 and 2, B = 2^20 x n = 8,192 for d = 3) vs its plain
     version (equal counts) and an f64 literal ``agree`` oracle, with its
     launch shape (and at 2^20 the SM clock and power while it runs);
 12. kernels ``fused_sweep_pivot``, ``fused_sweep_absolute_orientation``,
     ``fused_sweep_ray3d`` and ``fused_sweep_dense_linear6`` vs their plain
     versions on phase 4's cases (pivot at n = 512 and 480), whose votes
     are FMA chains rounded alike: equal counts and winner indices,
     bit-equal params;
 13. per rigid family, ``ransac_fused_sweep`` through its estimator at the
     JAX family record's width (one launch), the ground truth recovered,
     then the kernel vs its plain version at that shape, as in phase 12,
     with its launch shape and its time on 1 column;
 14. ``ransac`` with pivot calibration at 65,536 gathered hypotheses (the
     tree gather and the batched f64 9x6 SVD, no kernel);
 15. kernels ``fused_sweep_crosswire`` and ``fused_sweep_pointer`` vs their
     plain versions on phase 4's cases, a padding-column case and a case of
     22 ragged chunks (``US_CHUNK_SMALL``): equal count, equal winner index,
     bit-equal rows;
 16. per ultrasound family, ``ransac_fused_sweep`` (delta 3.0, ITERATIVE
     Levenberg-Marquardt refit) at the JAX family record's width, n = 1,024
     and 1,024 groups (one launch), the ground truth recovered, the refit's
     iterations and time, then the kernel vs its plain version at that shape,
     each family's fit and vote kernels' device ms by the profiler and their
     launch shapes; for crosswire, the refit's residual and Jacobian kernel
     (``us_crosswire_residual``) against its plain version on the card, bit
     for bit, at the refit's start on one and four problems, and its times;
 17. ``ransac_structured`` on both ultrasound estimators through the
     ``us_fast`` hook at 16,384 hypotheses, and ``ransac`` on crosswire at
     16,384 gathered hypotheses (the batched f64 12x12 SVD minimal fit); no
     sweep kernel on either, the crosswire refits' residual kernel only;
 18. kernel ``sphere_lm`` through ``sphere_lm_batch`` at the bench's LM
     shape (4,096 problems x 256 points, 30 iterations, gtol 1e-6) against
     its plain version and the float64 LM, with the iterations and the LM
     iterations/s, the kernel's time, its slowest problem's iterations and
     its launch shape;
 19. kernel ``sphere_mega`` through ``fast_sphere_ransac_sweep`` at the
     bench's scan shape (n = 1,024, 128 groups, 100 steps: 13.1M
     hypotheses) on phase 5's cloud, the ground truth recovered by the
     GEOMETRIC refit of the winner's consensus, then the kernel against its
     plain version on one step at that shape (counts and params bit-equal;
     the plain version emulates the kernel's FMAs exactly), that step's
     counts on every 32nd hypothesis against f64 ``minimal_fit`` + ``agree``
     (within 2 where both fit, equal maxima), its registers, blocks per SM
     and waves, and a 256-point, 4-group step against ``minimal_fit`` +
     ``agree`` on its hypothesis set; then one step on the cloud 1e4 from
     the origin: bit-equal to the plain version, the best within 1 of the
     f64 maximum over the same samples;
 20. kernel ``sphere_planar_vote`` through ``planar_sphere_samples`` +
     ``sphere_fit_and_vote_planar`` at B = 131,072 (128 groups x n =
     1,024) against its plain version and ``minimal_fit`` + ``vote_counts``,
     and so on the cloud 1e4 from the origin, its best within 1 of the f64
     maximum, with the kernel's time and launch shape;
 21. the drivers that add no kernel: ``ransac_fused_sweep`` with the
     GEOMETRIC (Levenberg-Marquardt) refit at n = 1,024 and 2^22 hypotheses,
     the ground truth, the refit's iterations and time; ``ransac_batched``
     on the JAX chip gate's fleet (4 datasets of 512 points, centres (5 + i,
     -2, 11), 4 groups: the sphere vote kernel), equal to per-dataset
     ``ransac_structured``; ``sphere3d_planar_sweep`` in float64 at n =
     1,024 and 8 groups, its double-single counts equal to its f64 ones;
 22. the plane phantom (k = 31) at the JAX bench's shape: ``ransac_structured``
     with the ITERATIVE refit at 65,536 hypotheses (1,024 groups x n = 64),
     kernel ``phantom_qr`` (B6) launched once per 4,352-hypothesis chunk, the
     ground truth recovered and no shoved pose in the consensus, the refit's
     LM iterations and time, a profile with B6's share;
     ``ransac_fused_sweep``, which falls back to the same sweep; B6 against
     its plain version, bit for bit, at the chunk, at the whole sweep and on
     duplicate-row samples (which the fit must reject), its registers, blocks
     per SM and waves at both shapes, and the plain version's and one f32
     ``torch.linalg.svd``'s times at both; the JAX chip check's
     f64 gate on 4,096 hypotheses of its data model (poses on the plane,
     1 px noise) and of phase 22's: equal maxima, and the sweep's counts
     within 2 of f64 ``minimal_fit`` + ``agree`` on every sample with a
     unique null direction (sigma_30 / sigma_31 >= 4); ``ransac`` at 16,384
     gathered hypotheses (the batched f64 31x31 SVD, no kernel);
 23. the sufficient-statistics LM (``linalg.stats_lm``, no kernel) at the
     bench's pointer shape (4,096 problems x 256 observations, 50
     iterations, gtol 1e-6) through ``pointer_stats`` + ``feature_lm_planar``:
     its wall (median of 10, each run's mean t3_x tracking a shift of p),
     iterations and LM iterations/s; ``lsq_fit_stats_batched`` on 64
     problems x 64 observations with strided and offset-block masks for the
     three ultrasound kinds, card float64 against CPU float64 (max|dparam|
     < 1e-5, every problem valid); and the crosswire refit of phase 16's
     consensus by ``lsq_fit_stats_batched`` and by the full-LM ``lsq_fit``,
     both timed;
 24. the sharded drivers (``parallel``) on a one-process NCCL group (NCCL
     gives each process a card of its own; the multi-process semantics are
     held on the CPU by gloo in the tests) and a ``(1, 1)`` mesh:
     ``sharded_fused_sweep`` for the ten families at phases 5's, 9's, 13's
     and 16's shapes with explicit permutations (B1, B3), equal in count and
     params to ``fused_sweep``; ``sharded_us_sweep("plane_phantom")`` at
     phase 22's 65,536 hypotheses (B6 once per chunk), equal to
     ``structured_sweep`` on the same permutation; ``sharded_ransac`` on
     phase 5's sphere at 65,536 hypotheses (B2), equal to
     ``hypothesize_and_vote`` + ``lsq_fit`` on the same indices;
     ``sharded_lsq_fit`` on phase 10's plane consensus and
     ``sharded_us_feature_lm`` on phase 16's pointer consensus, equal to
     their unsharded counterparts; each driver's wall beside its
     single-device counterpart's;
 25. ``resumable_sweep`` on the bench's sphere, n = 1,024, 4 rounds of
     65,536 gathered hypotheses (B2 per round), cut after 2 rounds and
     resumed from its ``.npz``: equal to the uninterrupted sweep in
     ``evaluated``, best count, mask, params and generator state (phases
     23-25 under 90 s);
 26. the host layers: ``cli.main(["info"])`` (the card's name, all eleven
     estimators); ``cli.main(["bench", ...])`` at phase 5's 2^22 hypotheses
     on n = 1,024 (exactly two sphere3d launches, warm and timed, the
     centre within 1.0, inlier fraction >= 0.75; then the bench's call on
     its cloud, median wall of 10 and a profile), and once more inside
     ``utils.profiling.trace``, whose Chrome trace must name
     ``sphere3d_kernel``; the three ``synthetic`` generators on a CUDA
     generator at n = 1,024, each clean set's ANALYTIC fit within the JAX
     tests' limits; every example through ``main(["--device", "cuda",
     ...])`` in a temporary directory, the three data-reading ones on
     reference-format files with 20% outliers, their ``.iv`` and XML
     artifacts checked as ``tests/test_examples.py`` checks them, the
     showcase launching B1 sphere3d, B3 pivot and B3 absolute_orientation
     and ``sphere_estimation`` B2 (under 60 s);
 27. far refits: ``ransac_fused_sweep`` on the data models and shapes of
     phases 5 (the sphere at 2^22 hypotheses, ALGEBRAIC and GEOMETRIC), 9
     (plane3d, line3d, line2d) and 13 (absolute_orientation), from a
     generator of its own, at the origin and ``FAR_OFFSET`` from it with
     the same hypotheses: the far best count within 2 of the origin's, the
     far params within one float32 ulp of the float64 refit of the same
     consensus on the card (GEOMETRIC: the float64 LM, within
     ``FAR_GEOMETRIC_TOL``), the truth recovered at the phase's own limits
     with the offset taken back out, and each refit's median wall of 10
     ``consensus_refit`` calls at both offsets (under 30 s).

The rigid families' data (phases 12-14): pivot frames about t_D = (10, -5,
2), t_W = (100, 50, -30) with N(0, 0.05) noise and 20% outlier poses
(``tests/test_fused_sweep.py:145-167``); point pairs under the rotation of
q = (0.9, 0.2, -0.3, 0.1) and t = (12, -7, 30) with N(0, 0.1) noise, 20%
replaced (``scripts/chip_check.py:125-135``); rays from [-60, 60]^3 towards
(3, -4, 20) with N(0, 0.05) jitter, 20% random directions, minimum angular
deviation 0.05 (``chip_check.py:138-148``); rows ``[a | b]`` of x = (1.5,
-2, 0.5, 3, -1, 2.5) with N(0, 0.05) noise, 20% with b shifted by U(5, 50)
(``tests/test_fused_sweep.py:327-336``).

The ultrasound data (phases 15-17) is the JAX chip gate's
(``scripts/chip_check.py:151-194``): scales m_x = 0.143, m_y = 0.139, R3 =
Euler-ZYX(1.1, 0.4, -0.7), t3 = (20, -15, 40), the crosswire target t1 =
(30, 76, -58); pixels uniform in 640 x 480 with 0.5 px noise, pose angles
uniform in [0, pi), the pointer's t2 uniform in [-100, 100]^3; 20% of t2
(crosswire) or p (pointer) shifted by 30-80 per axis; float64.  Recovery
limits are the JAX tests' (``tests/test_us_calibration.py:34-36``):
translations within 1.0, rotation within 1 degree, scales within 1.0.

The LM problems of phase 18 are the bench's (``bench.py:656-664``): centres
uniform in [-50, 50]^3, radius 25, N(0, 0.3) noise, start at centre + 1 and
radius 23.

The plane phantom (phase 22) is the JAX package's ``make_plane_phantom_data``
(``lsqrrecipes_tpu/synthetic.py:68-96``) at the bench's shape
(``bench.py:457-477``): scales m_x = 0.143, m_y = 0.139, R3 of Euler angles
uniform in [0, pi), t3 uniform in [-100, 100]^3, the plane's (w1_y, w1_x)
uniform in [-1, 1] and t1_z in [-100, 100]; n = 64 poses with angles uniform
in [0, pi), pixels uniform in 640 x 480 with N(0, 0.5) noise, each free
translation in [-100, 100]^3 projected onto the plane constraint; the last
10% of the poses shoved 20-60 along the plane normal with a random sign;
delta 1.0, float64.  Limits are the JAX tests'
(``tests/test_us_calibration.py:7-8, 153``): translations within 3.0,
rotation and plane normal within 5 degrees, scales within 1.0.

Each main-path phase sets the launch counts to 0 just before it and fails if
a kernel of that path did not launch.  Any failed check raises, so the exit
code is nonzero.  The line before the last is the kernels' JSON record
(times in ms from CUDA events around back-to-back launches queued behind a
spin kernel, bounds from this run's shapes); the last line
is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits nonzero and prints no result.
"""

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

TRUE_CENTER = np.array([5.0, -2.0, 11.0])
TRUE_RADIUS = 25.0
DELTA = 1.0

# Peak rates of the H100 SXM (NVIDIA data sheet, dense, without sparsity):
# f32 FLOP/s at the non-tensor-core rate (both kernels run on the FP32
# pipes) and memory bytes/s.  Any other card has no row and stops the run.
H100_SXM = "NVIDIA H100 80GB HBM3"
PEAKS = (67e12, 3.35e12)

# f32 operations per cell of each kernel's inner loop (an FMA counts 2):
# sweep: B7's cell, 4 FMA + abs + compare + count (MEGA_OPS_PER_CELL); vote:
# |p|^2 - 2 c.p as 3 FMA (3 multiplies + 3 adds), + |c|^2, two compares, add.
SWEEP_OPS_PER_CELL = 11
SWEEP_OPS_PER_HYP = 115      # Cramer fit and band rows, once per hypothesis
VOTE_OPS_PER_CELL = 10
# The point sweeps (csrc/fused_sweep_points.cu), (per cell, per hypothesis):
# plane3d 1 multiply + 4 FMA + compare + add, line2d 1 multiply + 3 FMA +
# compare + add, line3d 7 FMA + compare + add; the fits and band rows once
# per hypothesis (line3d: the fit's 13 and the vote rows' 18, a - c, -2a,
# -u.a and delta^2 - |a|^2; its 8 per point of centring are negligible).
POINT_SWEEP_OPS = {"plane3d": (11, 34), "line3d": (16, 31), "line2d": (9, 15)}
# The sweeps whose plain versions round FMAs through fma_f32 in float64 take
# seconds a call at the main path's shapes: their plain time is one call.
PLAIN_ONCE = ("sphere3d", "line3d", "crosswire", "pointer", "pivot", "absolute_orientation",
              "ray3d", "dense_linear6")
# plane_vote: d multiplies + d - 1 adds, subtract, multiply, compare, add.
PLANE_VOTE_OPS_PER_CELL = {2: 7, 3: 9}

DEVICE = "cuda"
# Shapes of the phases (the full-size run; see the module docstring).
N_VOTE, B_VOTE = 1024, 65536
SWEEP_CASES = (  # (n, total_groups, groups_per_step, vote_subsample)
    (1024, 64, 1, 0), (1024, 64, 4, 0), (1024, 63, 4, 0),
    (1000, 64, 1, 0), (1000, 64, 4, 0), (1024, 64, 1, 512),
)
N_MAIN, H_FUSED, H_GATHER = 1024, 1 << 22, 65536
N_LARGE, H_LARGE = 8192, 1 << 20
PLANE_VOTE_SHAPES = ((65536, 1024, 3), (65536, 1024, 2), (1 << 20, 8192, 3))  # (B, n, d)
WALL_REPS = 10  # host-clock repeats per main-path driver (the host is shared)
HOLD_CYCLES = 40_000_000  # ~20 ms of spin before a timed run of launches

# The point families: ground truth of the chip gate's data model and the
# recovery limits held on the main path (angle of the normal / direction up
# to sign, distance of the true anchor from the fitted plane or line).
E1 = np.array([1.0, 0.0, 0.5]) / np.sqrt(1.25)
E2 = np.array([0.0, 1.0, -0.2]) / np.linalg.norm([0.0, 1.0, -0.2])
LINE3D_U = np.array([0.6, -0.64, 0.48]) / np.linalg.norm([0.6, -0.64, 0.48])
PLANE_N = np.cross(E1, E2) / np.linalg.norm(np.cross(E1, E2))
FAMILIES = {
    # family: (estimator name, true anchor, true unit normal (plane, 2D line)
    # or direction (3D line))
    "plane3d": ("plane", np.array([2.0, -1.0, 4.0]), PLANE_N),
    "line3d": ("line", np.array([1.0, 2.0, -3.0]), LINE3D_U),
    "line2d": ("line2d", np.array([-2.0, 5.0]), np.array([-0.6, 0.8])),
}
MAX_ANGLE, MAX_ANCHOR = 0.01, 0.1   # radians; data units
# Point sweeps held to equal counts and winner indices against their plain
# versions (phases 8, 9); the others within one count, as before.
EXACT_POINT_SWEEPS = ("line3d",)
# Phases 3, 4, 8, 19 and 20 also vote on a cloud this far from the origin on
# every axis (phase 8 a line3d cloud, the others the bench's sphere), where
# the votes' |p|^2 - 2a.p expansion would cancel badly about the origin.
FAR_OFFSET = 1e4

# The rigid families (csrc/fused_sweep_rigid.cu): estimator registry name,
# data size n and groups of the main path (the JAX family record,
# docs/FAMILY_PERF.json), and f32 operations (per cell, per hypothesis)
# counted from each family's vote and fit, the function's work whatever the
# kernel fuses (its FMAs count two): pivot 3 x (3 mul + 2 add + add +
# sub) + 3 mul + 2 add + compare + count per cell, the sums, Schur matrix,
# Cramer solve and back-substitution per hypothesis; absolute_orientation
# the same per cell, two frames and R, t per hypothesis; ray3d 3 sub +
# (3 mul + 2 add) x 2 + 2 mul + 2 sub + 2 compares + and + count per cell;
# dense_linear6 6 mul + 5 add + sub + abs + compare + count per cell, the
# 6x6 normal equations (21 x 11 + 6 x 11), Cholesky and substitutions per
# hypothesis.
RIGID = {
    "pivot": ("pivot_calibration", 480, 2048, (28, 152)),
    "absolute_orientation": ("absolute_orientation", 1024, 1024, (28, 196)),
    "ray3d": ("ray_intersection", 1024, 1024, (21, 72)),
    "dense_linear6": ("dense_linear", 1024, 2048, (15, 478)),
}
RIGID_CASE_SIZES = {"pivot": {1024: 512, 1000: 480}}   # phase 4's n, cut to pivot's
PIVOT_TD, PIVOT_TW = np.array([10.0, -5.0, 2.0]), np.array([100.0, 50.0, -30.0])
ABSOR_Q, ABSOR_T = np.array([0.9, 0.2, -0.3, 0.1]), np.array([12.0, -7.0, 30.0])
RAY_TARGET, RAY_MIN_ANGLE = np.array([3.0, -4.0, 20.0]), 0.05
DENSE_X = np.array([1.5, -2.0, 0.5, 3.0, -1.0, 2.5])
# Recovery limits of the JAX tests: pivot t_D and t_W, rotation entries and
# t, the ray target, x.
RIGID_LIMITS = {"pivot": (0.1, 0.1), "absolute_orientation": (0.01, 0.2),
                "ray3d": (0.2,), "dense_linear6": (0.05,)}
# The ultrasound families (csrc/fused_sweep_us.cu): estimator registry name,
# n and groups of the main path (the JAX family record,
# docs/FAMILY_PERF.json), and f32 operations per vote cell: crosswire
# 3 x (5 mul + 5 add/sub + sub) + 3 mul + 2 add + compare + count (the
# kernel's 3 x (add + 5 FMA) + multiply + 2 FMA count the same), pointer
# 3 x (2 FMA + sub) + multiply + 2 FMA + compare + count.  The fits'
# operations come from us_fit_ops.
US = {"crosswire": ("us_crosswire", 1024, 1024, 40),
      "pointer": ("us_pointer", 1024, 1024, 22)}
US_DELTA = 3.0
US_CHUNK_SMALL = 3000   # phase 15's chunked case: 65,536 hypotheses in 22 ragged chunks
US_MX, US_MY = 0.143, 0.139
US_R3_ANGLES = (1.1, 0.4, -0.7)
US_T3, US_T1 = np.array([20.0, -15.0, 40.0]), np.array([30.0, 76.0, -58.0])
US_LIMITS = (1.0, 1.0, 1.0)      # translation, rotation (degrees), scale
H_US_STRUCT = H_US_GATHER = 16384
US_PHASES_BUDGET_S = 300.0      # phases 15-17 together
# Phases 18-21: the bench's LM batch and its float64 oracle
# (scripts/chip_check.py:500-511), the scan sweep, the planar batch, the
# fleet (scripts/chip_check.py:409-465) and the generic engine's batch.
LM_B, LM_M, LM_ITERS, LM_GTOL = 4096, 256, 30, 1e-6
LM_F64 = {"max_iters": 60, "ftol": 0.0, "xtol": 0.0, "gtol": 1e-9}
SCAN_GROUPS, SCAN_STEPS = 128, 100
MEGA_SMALL = (256, 4)            # n, groups of the estimator check
FLEET_D, FLEET_N, FLEET_GROUPS = 4, 512, 4
GENERIC_GROUPS = 8
SPHERE_PHASES_BUDGET_S = 60.0    # phases 18-21 together
# f32 operations counted from the kernels: sphere_lm 40 per observation and
# evaluation, once at the start and once per iteration (the one pass that
# forms the cost and the 13 sums: 3 subtractions, s as 3 multiplies and 2
# adds, sqrt, the reciprocal, d - r, s rd - r as 2, (d - r)^2 added as 2,
# u as 3, the 12 products and sums of S_uu and S_uf, the 4 sums of u and f;
# the two-pass kernel took 38 per observation and iteration for the sums
# and 12 for the trial cost, 50, and 12 at the start); sphere_mega 4
# multiply-adds (2 each) + abs + compare + count per cell and the fit and
# band rows (SWEEP_OPS_PER_HYP) per hypothesis; sphere_planar_vote 3
# multiply-adds (2 each) + 2 compares + count per cell (the unfused vote: 3
# multiplies + 6 adds + 2 compares + and + count, 13), ~111 per fit.
LM_OPS_PER_OBS_EVAL = 40
MEGA_OPS_PER_CELL = 11
PLANAR_OPS = (9, 111)
# Phase 22, the plane phantom (k = 31) at the JAX bench's shape
# (bench.py:457-484): n = 64, 10% of the poses shoved 20-60 along the plane
# normal, delta 1.0, 1,024 groups (65,536 hypotheses); the f64 gate of the
# JAX chip check (scripts/chip_check.py:353-406) on 64 groups; the gathered
# driver at 16,384 hypotheses; the JAX tests' limits
# (tests/test_us_calibration.py:7-8, 153): translations within 3.0, rotation
# and plane normal within 5 degrees, scales within 1.0.
PHANTOM_N, PHANTOM_GROUPS, PHANTOM_GATE_GROUPS = 64, 1024, 64
PHANTOM_DELTA, H_PHANTOM_GATHER = 1.0, 16384
PHANTOM_LIMITS = (3.0, 5.0, 1.0)   # translation, rotation (degrees), scale
PHANTOM_DUPLICATES = 512           # duplicate-row samples held against the plain version
PHANTOM_GAP = 4.0                  # sigma_30 / sigma_31 of a sample with a unique null direction
PHANTOM_BUDGET_S = 150.0           # phase 22
# Phase 23, the sufficient-statistics LM at the bench's pointer shape
# (bench.py:734-830): 4,096 problems x 256 observations with their own poses,
# 0.5 px noise, the start truth + (1, 0.02 rad, 0.005), 50 iterations, gtol
# 1e-6; the JAX chip check's card-vs-CPU case (scripts/chip_check.py:630-690)
# at 64 problems x 64 observations with gtol 1e-9, for the three kinds.
STATS_LM_B, STATS_LM_N = 4096, 256
STATS_LM_CONFIG = {"max_iters": 50, "ftol": 0.0, "xtol": 0.0, "gtol": 1e-6}
STATS_CHECK_B, STATS_CHECK_N = 64, 64
STATS_CHECK_CONFIG = {"max_iters": 50, "ftol": 0.0, "xtol": 0.0, "gtol": 1e-9}
STATS_CHECK_TOL = 1e-5
# Phase 25: the resumable sweep on the bench's sphere, n = 1,024, in rounds of
# 65,536 gathered hypotheses, cut after 2 of its 4 rounds.
RESUME_N, RESUME_BATCH, RESUME_ROUNDS, RESUME_CUT = 1024, 65536, 4, 2
SHARDED_PHASES_BUDGET_S = 90.0     # phases 23-25 together
# Phase 26: the host layers.  The CLI's bench at phase 5's width; the three
# synthetic generators at n = 1,024 (their ANALYTIC fits held to the JAX
# tests' limits, tests/test_us_calibration.py:34-36, 153: translations 1.0
# (phantom 3.0), rotation 1 degree (5), scales 1.0); every example, the
# data-reading three on reference-format files with 20% outliers, their
# estimates held to the truth of those files (examples/common.py).  Every
# kernel launch of the CLI's first bench and of the examples is checked
# against its plain version on the same card tensors, on a budget of its own.
HOST_N = 1024
HOST_LIMITS = {"crosswire": (1.0, 1.0, 1.0), "pointer": (1.0, 1.0, 1.0),
               "plane_phantom": (3.0, 5.0, 1.0)}
EXAMPLE_KERNELS = {"fused_sweep_showcase": ("fused_sweep_sphere3d", "fused_sweep_pivot",
                                            "fused_sweep_absolute_orientation"),
                   "sphere_estimation": ("sphere_vote",),
                   "crosswire_us_calibration": ("us_crosswire_residual",)}
# Kernels whose launches phase 26's recorder keeps (the refits' crosswire
# residual kernel is held to its plain version in phase 16).
RECORDED_KERNELS = ("fused_sweep_", "sphere_vote")
HOST_PHASE_BUDGET_S = 60.0         # phase 26, without the plain versions
HOST_COMPARE_BUDGET_S = 120.0      # phase 26's plain versions
# Phase 27: the consensus refits of phases 5, 9 and 13 FAR_OFFSET from the
# origin; the refits accumulate in float64, so the far params are the float64
# refit of the same consensus cast to float32.  The GEOMETRIC refit is the
# float32 LM from that start, held to the float64 LM in data units.
FAR_COUNT_SLACK = 2
FAR_GEOMETRIC_TOL = 2e-3
FAR_REFIT_BUDGET_S = 30.0
REPLACES = {
    "fused_sweep_sphere3d": "lsqrrecipes_tpu/ops/fused_sweep.py:1090",
    "sphere_vote": "lsqrrecipes_tpu/ops/vote.py:76",
    "fused_sweep_plane3d": "lsqrrecipes_tpu/ops/fused_sweep.py:239",
    "fused_sweep_line3d": "lsqrrecipes_tpu/ops/fused_sweep.py:294",
    "fused_sweep_line2d": "lsqrrecipes_tpu/ops/fused_sweep.py:267",
    "plane_vote": "lsqrrecipes_tpu/ops/vote.py:127",
    "fused_sweep_pivot": "lsqrrecipes_tpu/ops/fused_sweep.py:334",
    "fused_sweep_absolute_orientation": "lsqrrecipes_tpu/ops/fused_sweep.py:467",
    "fused_sweep_ray3d": "lsqrrecipes_tpu/ops/fused_sweep.py:588",
    "fused_sweep_dense_linear6": "lsqrrecipes_tpu/ops/fused_sweep.py:688",
    "fused_sweep_crosswire": "lsqrrecipes_tpu/ops/fused_sweep.py:765",
    "fused_sweep_pointer": "lsqrrecipes_tpu/ops/fused_sweep.py:921",
    "sphere_lm": "lsqrrecipes_tpu/ops/sphere_lm.py:50",
    "sphere_mega": "lsqrrecipes_tpu/ops/sphere_ransac.py:225",
    "sphere_planar_vote": "lsqrrecipes_tpu/ops/sphere_ransac.py:80",
    "phantom_qr": "lsqrrecipes_tpu/ops/phantom_qr.py:46",
    "us_crosswire_residual": "none: jax.jacfwd of lsqrrecipes_tpu/estimators/us_calibration.py"
                             "::_crosswire_residual, fused by XLA under jit",
}


def bench_cloud(rng, n):
    """The bench's data model, float32 ``[n, 3]``."""
    n_in = n * 4 // 5
    d = rng.normal(size=(n_in, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inliers = TRUE_CENTER + TRUE_RADIUS * d + 0.3 * rng.normal(size=(n_in, 3))
    outliers = rng.uniform(-40.0, 40.0, size=(n - n_in, 3))
    return np.concatenate([inliers, outliers]).astype(np.float32)


def lm_problems(rng, b, m):
    """The bench's LM problems (see the module docstring), float32
    ``points[b, m, 3]`` and ``x0[b, 4]``."""
    centers = rng.uniform(-50.0, 50.0, (b, 3))
    d = rng.normal(size=(b, m, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = centers[:, None, :] + 25.0 * d + 0.3 * rng.normal(size=(b, m, 3))
    x0 = np.concatenate([centers + 1.0, np.full((b, 1), 23.0)], axis=1)
    return pts.astype(np.float32), x0.astype(np.float32)


def fleet_data(rng, num, n):
    """The JAX chip gate's fleet: dataset i has 80% of its points on the
    radius-25 sphere at (5 + i, -2, 11) with N(0, 0.3) noise, 20% uniform in
    [-40, 40]^3, float32 ``[num, n, 3]``."""
    out = []
    for i in range(num):
        n_in = n * 4 // 5
        d = rng.normal(size=(n_in, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        inl = np.array([5.0 + i, -2.0, 11.0]) + 25.0 * d + 0.3 * rng.normal(size=(n_in, 3))
        out.append(np.concatenate([inl, rng.uniform(-40.0, 40.0, (n - n_in, 3))]))
    return np.stack(out).astype(np.float32)


def family_cloud(rng, family, n):
    """The chip gate's data model for a point family, float32 ``[n, d]``."""
    _, anchor, axis = FAMILIES[family]
    n_in = n - n // 5
    if family == "plane3d":
        uv = rng.uniform(-30.0, 30.0, size=(n_in, 2))
        inl = anchor + uv[:, :1] * E1 + uv[:, 1:] * E2
    elif family == "line3d":
        inl = anchor + rng.uniform(-40.0, 40.0, size=(n_in, 1)) * axis
    else:
        inl = anchor + rng.uniform(-40.0, 40.0, size=(n_in, 1)) * np.array([0.8, 0.6])
    inl = inl + 0.2 * rng.normal(size=inl.shape)
    out = rng.uniform(-40.0, 40.0, size=(n - n_in, inl.shape[1]))
    return np.concatenate([inl, out]).astype(np.float32)


def rotation_np(q):
    """Unit quaternions ``[..., 4]`` (s first) -> rotation matrices ``[..., 3, 3]``."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    s, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - s * z), 2 * (x * z + s * y)], -1),
        np.stack([2 * (x * y + s * z), 1 - 2 * (x * x + z * z), 2 * (y * z - s * x)], -1),
        np.stack([2 * (x * z - s * y), 2 * (y * z + s * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def rigid_data(rng, family, n, geometry):
    """A rigid family's data model (see the module docstring), float32 numpy
    leaves in the port's types: a ``Frame``, a ``(first, second)`` pair, a
    ``Ray3D`` or ``[n, 7]`` rows."""
    n_in = n - n // 5
    if family == "pivot":
        r = rotation_np(rng.normal(size=(n, 4)))
        t = PIVOT_TW - r[:n_in] @ PIVOT_TD + 0.05 * rng.normal(size=(n_in, 3))
        t = np.concatenate([t, rng.uniform(-200.0, 200.0, (n - n_in, 3))])
        data = geometry.Frame(r, t)
    elif family == "absolute_orientation":
        first = rng.uniform(-100.0, 100.0, (n, 3))
        second = first @ rotation_np(ABSOR_Q).T + ABSOR_T + 0.1 * rng.normal(size=(n, 3))
        second[n_in:] = rng.uniform(-100.0, 100.0, (n - n_in, 3))
        data = (first, second)
    elif family == "ray3d":
        p = rng.uniform(-60.0, 60.0, (n, 3))
        d = RAY_TARGET - p + 0.05 * rng.normal(size=(n, 3))
        d[n_in:] = rng.normal(size=(n - n_in, 3))
        data = geometry.Ray3D(p, d / np.linalg.norm(d, axis=1, keepdims=True))
    else:
        a = rng.uniform(-10.0, 10.0, (n, 6))
        b = a @ DENSE_X + 0.05 * rng.normal(size=n)
        b[n_in:] += rng.uniform(5.0, 50.0, n - n_in)
        data = np.concatenate([a, b[:, None]], axis=1)
    if isinstance(data, tuple):
        leaves = [x.astype(np.float32) for x in data]
        return type(data)(*leaves) if hasattr(data, "_fields") else tuple(leaves)
    return data.astype(np.float32)


def rigid_errors(family, params):
    """Recovery errors of a rigid family's refit against its ground truth, in
    the order of ``RIGID_LIMITS``."""
    if family == "pivot":
        return (float(np.abs(params[:3] - PIVOT_TD).max()),
                float(np.abs(params[3:] - PIVOT_TW).max()))
    if family == "absolute_orientation":
        return (float(np.abs(rotation_np(params[:4]) - rotation_np(ABSOR_Q)).max()),
                float(np.abs(params[4:] - ABSOR_T).max()))
    if family == "ray3d":
        return (float(np.abs(params - RAY_TARGET).max()),)
    return (float(np.abs(params - DENSE_X).max()),)


def recovery_errors(family, params):
    """(angle of the fitted normal/direction to the truth up to sign,
    distance of the true anchor from the fitted plane or line)."""
    _, anchor, axis = FAMILIES[family]
    d = len(anchor)
    n, a = params[:d], params[d:]
    angle = float(np.arccos(min(1.0, abs(np.dot(n, axis)) / np.linalg.norm(n))))
    v = anchor - a
    if family == "line3d":
        dist = float(np.linalg.norm(v - np.dot(v, n) * n))
    else:
        dist = float(abs(np.dot(v, n)))
    return angle, dist


def euler_np(wz, wy, wx):
    """``Rz(wz) Ry(wy) Rx(wx)`` ``[..., 3, 3]``."""
    cz, sz, cy, sy, cx, sx = np.cos(wz), np.sin(wz), np.cos(wy), np.sin(wy), np.cos(wx), np.sin(wx)
    return np.stack([
        np.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx], -1),
        np.stack([sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx], -1),
        np.stack([-sy, cy * sx, cy * cx], -1),
    ], -2)


def us_data(rng, family, n, geometry, exact=False, outliers=True):
    """An ultrasound family's data model (see the module docstring), float64
    numpy leaves: ``(Frame, q)`` or ``(Frame, q, p)``.  ``exact``: no noise,
    no outliers and t3 = 0, so that all-zero padding columns would lie in
    the band of the planted calibration; ``outliers=False``: no outliers."""
    r3 = euler_np(*US_R3_ANGLES)
    t3 = np.zeros(3) if exact else US_T3
    q = rng.uniform(size=(n, 2)) * np.array([640.0, 480.0])
    w2 = rng.uniform(0.0, np.pi, (n, 3))
    r2 = euler_np(w2[:, 2], w2[:, 1], w2[:, 0])
    mapped = np.einsum("nij,nj->ni", r2,
                       q[:, 0:1] * (US_MX * r3[:, 0]) + q[:, 1:2] * (US_MY * r3[:, 1]) + t3)
    n_out = 0 if exact or not outliers else n // 5
    shift = (30.0 + 50.0 * rng.uniform(size=(n_out, 3))) * np.sign(rng.normal(size=(n_out, 3)))
    if family == "crosswire":
        t2 = US_T1 - mapped
        t2[n - n_out:] += shift
        rest = ()
    else:
        t2 = rng.uniform(-100.0, 100.0, (n, 3))
        p = mapped + t2
        p[n - n_out:] += shift
        rest = (p,)
    if not exact:
        q = q + 0.5 * rng.normal(size=q.shape)
    return (geometry.Frame(r2, t2), q, *rest)


def us_errors(family, params):
    """(max translation error, rotation error in degrees, max scale error)
    of an ultrasound refit against the planted calibration."""
    x = np.asarray(params, np.float64)
    trans = [x[0:3] - US_T1] if family == "crosswire" else []
    if family == "crosswire":
        x = x[3:]
    trans.append(x[0:3] - US_T3)
    r_fit, r_true = euler_np(*x[3:6]), euler_np(*US_R3_ANGLES)
    cos = (np.trace(r_fit.T @ r_true) - 1.0) / 2.0
    angle = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    return (float(np.abs(np.concatenate(trans)).max()), angle,
            float(np.abs(x[6:8] - [US_MX, US_MY]).max()))


def qr_solve_ops(r, c):
    """f32 operations of the kernels' equilibrated Householder solve of an
    ``r x c`` system, counted from its loops."""
    ops = c * (3 * r + 2)                 # column sums of squares, 1/sqrt, scaling
    for k in range(c):
        m = r - k                         # rows at and below the pivot
        ops += 2 * m + 6                  # sigma, sqrt, gate, alpha, vk, 1/(alpha vk)
        ops += (c - k) * (4 * m)          # each later column and the rhs
    for i in range(c):
        ops += 2 * (c - 1 - i) + 3        # back substitution
    return ops + c                        # undo the scaling


def us_fit_ops(family):
    """f32 operations of one ultrasound minimal fit: the system (crosswire
    4 x 3 rows of 6 products and a negation, pointer 3 x 3 rows of 6
    products and a subtraction), the QR solve, the column norms, gates and
    1/sqrt, the cross product, five polar steps (27 cofactor operations, 5
    for det, 4 for the gate and 1/det, 27 for the update) and the scaled
    columns."""
    build = 4 * 3 * 7 if family == "crosswire" else 3 * 3 * 7
    rows, cols = (12, 12) if family == "crosswire" else (9, 9)
    return build + qr_solve_ops(rows, cols) + (10 + 3 + 6 + 6 + 9 + 5 * 63 + 2 + 6)


def phantom_data(rng, n, geometry, sigma=0.5, shove=True):
    """The JAX package's ``make_plane_phantom_data`` model (see the module
    docstring), float64 numpy ``((Frame, q), truth, n_out)``: N(0, sigma)
    pixel noise and, with ``shove``, the last n // 10 poses shoved 20-60
    along the plane normal with a random sign."""
    w3 = rng.uniform(0.0, np.pi, 3)
    r3 = euler_np(w3[2], w3[1], w3[0])
    t3 = rng.uniform(-100.0, 100.0, 3)
    wy1, wx1 = rng.uniform(-1.0, 1.0, 2)
    normal = np.array([-np.sin(wy1), np.cos(wy1) * np.sin(wx1), np.cos(wy1) * np.cos(wx1)])
    t1_z = rng.uniform(-100.0, 100.0)
    q = rng.uniform(size=(n, 2)) * np.array([640.0, 480.0])
    w2 = rng.uniform(0.0, np.pi, (n, 3))
    r2 = euler_np(w2[:, 2], w2[:, 1], w2[:, 0])
    mapped = np.einsum("nij,nj->ni", r2,
                       q[:, 0:1] * (US_MX * r3[:, 0]) + q[:, 1:2] * (US_MY * r3[:, 1]) + t3)
    free = rng.uniform(-100.0, 100.0, (n, 3))
    t2 = free - ((mapped + free) @ normal + t1_z)[:, None] * normal
    q = q + sigma * rng.normal(size=q.shape)
    n_out = n // 10 if shove else 0
    shift = (20.0 + 40.0 * rng.uniform(size=(n_out, 1))) * np.sign(rng.normal(size=(n_out, 1)))
    if n_out:
        t2[n - n_out:] += shift * normal
    truth = {"normal": normal, "t1_z": t1_z, "t3": t3, "r3": r3}
    return (geometry.Frame(r2, t2), q), truth, n_out


def phantom_errors(params, truth):
    """(max translation error, max rotation error in degrees (R3 and the
    plane normal), max scale error) of a plane-phantom fit; the normal and
    t1_z up to their common sign."""
    x = np.asarray(params, np.float64)
    normal = np.array([-np.sin(x[0]), np.cos(x[0]) * np.sin(x[1]), np.cos(x[0]) * np.cos(x[1])])
    sign = 1.0 if normal @ truth["normal"] >= 0 else -1.0
    n_angle = np.degrees(np.arccos(np.clip(sign * normal @ truth["normal"], -1.0, 1.0)))
    cos = (np.trace(euler_np(*x[6:9]).T @ truth["r3"]) - 1.0) / 2.0
    r_angle = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
    trans = max(abs(sign * x[2] - truth["t1_z"]), float(np.abs(x[3:6] - truth["t3"]).max()))
    return trans, float(max(n_angle, r_angle)), float(np.abs(x[9:11] - [US_MX, US_MY]).max())


def phantom_qr_ops():
    """f32 operations of one hypothesis of the phantom subspace kernel,
    counted from its loops over the 31 live rows: Householder step j (m = 31
    - j rows) takes 2m for sigma and 6 for the pivot, then 4m + 1 for each of
    the 31 - j columns it updates; the diagonal clamp 3 per pivot; each of the
    two iterations solves four vectors (forward step c: 2c + 2, backward:
    2c + 2 + 2), normalises them (2 x 31 + 3) and runs Gram-Schmidt (six
    projections of 4 x 31, four more normalisations)."""
    ops = 0
    for j in range(31):
        m = 31 - j
        ops += 2 * m + 6 + (31 - j) * (4 * m + 1)
    ops += 3 * 31
    solve = sum(2 * c + 2 for c in range(31)) + sum(2 * c + 4 for c in range(31))
    norm = 2 * 31 + 3
    return ops + 2 * (4 * solve + 4 * norm + 6 * 4 * 31 + 4 * norm)


def launch_shape(kernel, num_hyp, query="shape"):
    """A redesigned kernel's registers, spills, block shape, blocks per SM
    and waves at ``num_hyp`` hypotheses, as text (``query``: see
    ``Kernel.shape``)."""
    s = kernel.shape(num_hyp, query)
    return (f"{s['registers']} registers, {s['spill_bytes']} spill bytes, {s['blocks']} blocks "
            f"of {s['threads']} threads ({s['hyp_per_block']} hypotheses each), "
            f"{s['blocks_per_sm']} blocks per SM, {s['waves']:.3f} waves")


def max_or(t, default):
    """``int(t.max())``, or ``default`` for an empty tensor."""
    return int(t.max()) if t.numel() else default


def far_cloud(seed, phase, n):
    """The bench's sphere, ``FAR_OFFSET`` from the origin on every axis,
    from a generator of its own (``[seed, phase]``), float32 ``[n, 3]``."""
    return bench_cloud(np.random.default_rng([seed, phase]), n) + np.float32(FAR_OFFSET)


def f64_best(est, samples, pts, chunk=16384):
    """The float64 ``minimal_fit`` + ``agree`` maximum over the sphere
    ``samples`` ``[B, 4, 3]`` on ``pts``, ``chunk`` hypotheses at a time."""
    best = 0
    for b0 in range(0, samples.shape[0], chunk):
        params, valid = est.minimal_fit(samples[b0 : b0 + chunk].double())
        best = max(best, max_or(est.agree(params, pts.double()).sum(-1) * valid, 0))
    return best


def plain_reps(family):
    """``(reps, warmup)`` for timing a sweep's plain version."""
    return (1, 0) if family in PLAIN_ONCE else (2, 1)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks(name):
    if name != H100_SXM:
        raise AssertionError(f"no peak rates known for {name!r}")
    return PEAKS


def bound(ops, nbytes, rates):
    """Least time (ms) for ``ops`` f32 operations and ``nbytes`` of memory
    traffic at ``rates``, and which of the two sets it."""
    t_ops, t_bytes = ops / rates[0], nbytes / rates[1]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def compare_sweep(fs, family, est, coords, p, n_fit, num_groups, vote_cols, voters, label,
                  delta=DELTA, exact=False, kernel=None):
    """One launch of the family's sweep kernel against its plain version on
    the same inputs: best count within 1, the kernel's winner re-achieving
    its count under ``agree`` within 1, and, where the winner indices match,
    the parameters equal bit for bit (``exact``: equal counts and indices
    as well).  Returns the largest absolute error.  ``voters`` is the data
    (a tensor or a tree of tensors) the kernel voted on; a family's kernel
    rows are converted as ``fused_sweep`` does.  ``kernel``: the result of
    a launch already made on these inputs, checked in place of a new one;
    with ``est`` None the re-achieve check is left out."""
    if kernel is None:
        kernel = fs.sweep_cuda(family, coords, p, n_fit, num_groups, vote_cols, delta)
    kc, kp, ki = kernel
    pc, pp_, pi = fs.sweep_plain(family, coords, p, n_fit, num_groups, vote_cols, delta)
    kc, pc, ki, pi = int(kc), int(pc), int(ki), int(pi)
    from lsqrrecipes_tpu_torch.tree import tree_leaves

    post = fs._POSTPROCESS.get(family, lambda rows: rows)
    regain = (kc if est is None
              else int(est.agree(post(kp).to(tree_leaves(voters)[0].dtype), voters).sum()))
    d_count = abs(kc - pc)
    params_err = float((kp - pp_).abs().max()) if ki == pi else None
    print(f"{label}: count kernel={kc} plain={pc}"
          + (f" agree={regain}" if est is not None else "")
          + f"; index kernel={ki} plain={pi}"
          + (f"; params max|d|={params_err:.3g}" if params_err is not None else ""))
    check(d_count <= 1, f"{label}: fused sweep count disagrees with its plain version")
    check(abs(regain - kc) <= 1, f"{label}: fused sweep winner does not re-achieve its count")
    check(ki < num_groups * n_fit, f"{label}: fused sweep winner index out of range")
    check(params_err in (None, 0.0), f"{label}: same winner, different params")
    check(not exact or (d_count == 0 and ki == pi),
          f"{label}: kernel and plain version pick different winners")
    return max(d_count, params_err or 0.0)


def compare_crosswire_residual(torch, data, mask, x, timer, rates, smi):
    """[16] The crosswire residual and Jacobian kernel against its plain
    version on the card, on phase 16's data at the refit's start ``x[11]``
    and on 4 problems around it: each masked output equal bit for bit in
    float64, two calls too; then the CUDA-event times of both modes at one
    problem and the plain Jacobian's.  Returns ``(err, ms, plain_ms,
    bound_ms, bound_by)`` of the Jacobian mode, whose bound is its bytes
    (its float64 arithmetic, about 150 operations an image, is far below
    them)."""
    from lsqrrecipes_tpu_torch import kernels
    from lsqrrecipes_tpu_torch.estimators import us_calibration as usc
    from lsqrrecipes_tpu_torch.tree import tree_map

    m = mask.repeat_interleave(3).to(x.dtype)
    x4 = x + 1e-3 * torch.arange(4, dtype=x.dtype, device=x.device)[:, None]
    data4 = tree_map(lambda t: t.expand(4, *t.shape).contiguous(), data)
    err = 0.0
    for xb, db in ((x, data), (x4, data4)):
        for fn, plain, mm in ((usc._crosswire_residual, usc._crosswire_residual_plain, m),
                              (usc._crosswire_jacobian, usc._crosswire_jacobian_plain,
                               m[:, None])):
            got, again, want = fn(xb, db), fn(xb, db), plain(xb, db)
            check(torch.equal(got, again), f"[16] {fn.__name__}: two calls differ")
            got, want = got * mm, want * mm
            e = float((got - want).abs().max() / want.abs().max())
            print(f"    {fn.__name__} B={xb[..., 0].numel()}: {tuple(got.shape)}, largest "
                  f"difference from the plain version {e:.3e} of its scale")
            check(torch.equal(got, want), f"[16] {fn.__name__} off its plain version by {e:.3e}")
            err = max(err, e)
    ms = timer.ms(lambda: usc._crosswire_jacobian(x, data), reps=50)
    res_ms = timer.ms(lambda: usc._crosswire_residual(x, data), reps=50)
    plain_ms = timer.ms(lambda: usc._crosswire_jacobian_plain(x, data), reps=20)
    n = data[1].shape[0]
    bound_ms, by = bound(0, (11 + 14 * n + 33 * n) * x.element_size(), rates)
    print(f"    us_crosswire_residual ms at n={n}: Jacobian {ms:.4f}, residual {res_ms:.4f}, plain "
          f"Jacobian {plain_ms:.4f}, bound {bound_ms:.5f} ({by}); "
          f"{launch_shape(kernels.US_CROSSWIRE, n)} [{smi}]")
    return err, ms, plain_ms, bound_ms, by


class Timer:
    """CUDA-event timing of a callable: mean ms over ``reps`` after warm-up."""

    def __init__(self, torch):
        self.torch = torch

    def ms(self, fn, reps=10, warmup=2):
        """A spin kernel holds the stream while the launches are enqueued, so
        the events time the device's back-to-back run of ``fn`` and not the
        host's loop: a wrapper's Python work per call can outlast a kernel of
        a few tens of microseconds."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def wall_ms(self, fn, reps):
        """Median host-clock ms of ``fn`` ending in a synchronize."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))


def clocks_during(torch, fn, seconds=1.0):
    """Mean SM clock (MHz) and board power (W) that ``nvidia-smi`` samples
    every 100 ms while ``fn`` runs back to back for ``seconds``."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, text=True,
    )
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=60)
    rows = []
    for line in out.splitlines()[2:]:      # the first samples may predate the load
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:
            continue
    if not rows:
        return float("nan"), float("nan")
    return float(np.mean([r[0] for r in rows])), float(np.mean([r[1] for r in rows]))


def breakdown(torch, fn, label, top=6):
    """One profiled call of ``fn``: wall ms, summed device time of its
    kernels, the device's idle share of the wall, and the top kernels.
    Only device-side events count: an operator's own row repeats the time
    of the kernels it launched."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = evt.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    idle = 1.0 - busy / wall if wall > 0 else float("nan")
    print(f"    profile {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {idle:.3f}")
    for ms, count, key in rows[:top]:
        print(f"      {ms:9.4f} ms  x{count:<4d} {key[:90]}")
    return busy, rows


def device_ms(torch, fn, names, reps=10):
    """Mean device ms per launch of the kernels whose names contain each of
    ``names``, from one ``torch.profiler`` window of ``reps`` calls of ``fn``
    queued behind a spin kernel.  Each mean is over the launches the
    profiler recorded, which can be fewer than ``reps``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(HOLD_CYCLES)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        evts = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
        launches = sum(e.count for e in evts)
        out[name] = sum(e.self_device_time_total for e in evts) / 1e3 / max(1, launches)
    return out


def library_plane_vote(torch, params, points_t, valid, delta_sq, chunk=8192):
    """One-library-call yardstick for the plane vote: ``addmm`` with the
    offset as bias, then square, compare and sum, chunked over hypotheses.
    Not used by the port."""
    d = points_t.shape[0]
    live = valid[0] != 0
    out = []
    for b0 in range(0, params.shape[0], chunk):
        prm = params[b0 : b0 + chunk]
        s = torch.addmm(-prm[:, d:], prm[:, :d], points_t)
        out.append(((s * s < delta_sq) & live).sum(1))
    return torch.cat(out)


def library_vote(torch, params, pts, delta, chunk=8192):
    """One-library-call yardstick for the vote: ``addmm`` distance matrix +
    band test, chunked over hypotheses.  Not used by the port."""
    pp = (pts * pts).sum(1)
    out = []
    for b0 in range(0, params.shape[0], chunk):
        prm = params[b0 : b0 + chunk]
        c, r = prm[:, :3], prm[:, 3]
        cc = (c * c).sum(1, keepdim=True)
        d2 = torch.addmm(cc, c, pts.T, alpha=-2.0) + pp
        lo = torch.where(r >= delta, (r - delta) ** 2, -torch.inf)[:, None]
        out.append(((d2 < ((r + delta) ** 2)[:, None]) & (d2 > lo)).sum(1))
    return torch.cat(out)


def pointer_lm_problems(rng, b, n):
    """The bench's pointer LM problems (``bench.py:772-790``): the gate's
    calibration, per problem n poses with angles uniform in [0, pi) and
    translations uniform in [-100, 100]^3, pixels in 640 x 480 with 0.5 px
    noise -> float64 ``(r2 [b, n, 3, 3], t2, q, p)`` and the start ``[8]``."""
    r3 = euler_np(*US_R3_ANGLES)
    q = rng.uniform(size=(b, n, 2)) * np.array([640.0, 480.0])
    w2 = rng.uniform(0.0, np.pi, (b, n, 3))
    r2 = euler_np(w2[..., 2], w2[..., 1], w2[..., 0])
    t2 = 200.0 * (rng.uniform(size=(b, n, 3)) - 0.5)
    img = q[..., 0:1] * (US_MX * r3[:, 0]) + q[..., 1:2] * (US_MY * r3[:, 1]) + US_T3
    p = np.einsum("bnij,bnj->bni", r2, img) + t2
    q = q + 0.5 * rng.normal(size=q.shape)
    x0 = np.concatenate([US_T3 + 1.0, np.array(US_R3_ANGLES) + 0.02,
                         np.array([US_MX, US_MY]) + 0.005])
    return (r2, t2, q, p), x0


def stats_check_masks(n, b, k):
    """``check_lm_stats``'s masks (``scripts/chip_check.py:650-658``): strided
    ones and offset blocks, each holding the first k observations."""
    idx = np.arange(n)
    strided = [idx % max(2, i % 7) != 0 for i in range(b // 2)]
    blocks = [np.roll(idx < n // 2 + i % 8, (i * n) // (b // 2)) for i in range(b - b // 2)]
    return np.stack(strided + blocks) | (idx[None, :] < k)


def phase_stats_lm(torch, dev, rng, timer, smi, cross):
    """Phase 23: the sufficient-statistics LM.  ``cross`` = ``(estimator,
    data tensors, consensus mask)`` of phase 16's crosswire run."""
    from lsqrrecipes_tpu_torch import geometry, interop, kernels
    from lsqrrecipes_tpu_torch.estimators import get
    from lsqrrecipes_tpu_torch.linalg import LMConfig
    from lsqrrecipes_tpu_torch.linalg import stats_lm

    (r2, t2, q, p), x0 = pointer_lm_problems(rng, STATS_LM_B, STATS_LM_N)
    r2, t2, q, p = (torch.as_tensor(a, device=dev) for a in (r2, t2, q, p))
    x0s = torch.as_tensor(x0, device=dev).expand(STATS_LM_B, 8).contiguous()
    config = LMConfig(**STATS_LM_CONFIG)
    r2e1 = r2[..., :, 0]

    def solve(shift):
        # Shifting p by s R2 e1 moves the optimal t3_x by exactly s: the
        # mean t3_x of every run tracks it (proof the timed work ran).
        h = stats_lm.pointer_stats((geometry.Frame(r2, t2), q, p + shift * r2e1))
        return stats_lm.feature_lm_planar(stats_lm.pointer_w, h, x0s, config)

    kernels.reset_launch_counts()
    res = solve(0.0)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(sum(counts.values()) == 0, "the stats LM launched a kernel")
    check(bool(torch.isfinite(res.x).all()), "[23] the stats LM gave non-finite parameters")
    err = (res.x[:, 0:3] - torch.as_tensor(US_T3, device=dev)).abs().max()
    times, t3x, iters = [], [], []
    solve(0.25)
    for i in range(WALL_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = solve(0.25 * (i + 1))
        t3x.append(float(r.x[:, 0].mean()))
        iters.append(int(r.iterations.max()))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(times))
    drift = np.diff(np.array(t3x))
    print(f"[23] stats LM pointer B={STATS_LM_B} n={STATS_LM_N} ({STATS_LM_CONFIG}): launches "
          f"{sum(counts.values())}; max |t3 - truth| {float(err):.3g}, converged "
          f"{float(res.converged.float().mean()):.4f}; wall {wall:.3f} ms median of "
          f"{WALL_REPS} (pointer_stats + feature_lm_planar), at most {max(iters)} iterations, "
          f"{STATS_LM_B * max(iters) / wall * 1e3:.4g} LM iterations/s; mean t3_x steps "
          f"{drift.min():.6f}..{drift.max():.6f} (0.25) [{smi}]")
    check(bool(np.all(np.abs(drift - 0.25) < 1e-3)), "[23] the stats LM does not track the shift")
    check(float(err) < 1.0, "[23] the stats LM missed the planted t3")

    # The JAX chip check's case: card float64 against CPU float64.
    for kind, reg, delta in (("pointer", "us_pointer", US_DELTA),
                             ("crosswire", "us_crosswire", US_DELTA),
                             ("plane_phantom", "us_plane_phantom", PHANTOM_DELTA)):
        est = get(reg)(delta)
        if kind == "plane_phantom":
            data = phantom_data(rng, STATS_CHECK_N, geometry, sigma=1.0, shove=False)[0]
        else:
            data = us_data(rng, kind, STATS_CHECK_N, geometry, outliers=False)
        masks = torch.as_tensor(stats_check_masks(STATS_CHECK_N, STATS_CHECK_B, est.k))
        cpu = interop.data_to_torch(data, device="cpu")
        card = interop.data_to_torch(data, device=dev)
        # The phantom's null vector has no fixed sign: both sides start from
        # the CPU's analytic fits, so the comparison is of the LM alone.
        x0 = est._analytic(cpu, masks)[0][:, :11] if kind == "plane_phantom" else None
        cfg = LMConfig(**STATS_CHECK_CONFIG)
        p_card, v_card = est.lsq_fit_stats_batched(card, masks.to(dev), x0=None if x0 is None
                                                   else x0.to(dev), config=cfg)
        p_cpu, v_cpu = est.lsq_fit_stats_batched(cpu, masks, x0=x0, config=cfg)
        d = float((p_card.cpu() - p_cpu).abs().max())
        print(f"    lsq_fit_stats_batched {kind} B={STATS_CHECK_B} n={STATS_CHECK_N}: card f64 vs "
              f"CPU f64 max|dparam|={d:.3g} (<{STATS_CHECK_TOL:g}), valid card "
              f"{int(v_card.sum())}/{STATS_CHECK_B}, CPU {int(v_cpu.sum())}/{STATS_CHECK_B}")
        check(bool(v_card.all()) and bool(v_cpu.all()), f"[23] {kind}: a stats refit is invalid")
        check(d < STATS_CHECK_TOL, f"[23] {kind}: the card's stats refit departs from the CPU's")

    est, data, mask = cross
    p_stats, v_stats = est.lsq_fit_stats_batched(data, mask[None])
    p_full, v_full = est.lsq_fit(data, mask)
    stats_ms = timer.wall_ms(lambda: est.lsq_fit_stats_batched(data, mask[None]), reps=WALL_REPS)
    full_ms = timer.wall_ms(lambda: est.lsq_fit(data, mask), reps=WALL_REPS)
    print(f"    crosswire refit on phase 16's {int(mask.sum())} inliers: lsq_fit_stats_batched "
          f"{stats_ms:.3f} ms, full-LM lsq_fit {full_ms:.3f} ms (medians of {WALL_REPS}); "
          f"max|dparam| {float((p_stats[0] - p_full).abs().max()):.3g}, valid "
          f"{bool(v_stats[0])}/{bool(v_full)} [{smi}]")
    check(bool(v_stats[0]) and bool(v_full), "[23] a crosswire refit is invalid")


def phase_sharded(torch, dev, timer, smi, add_launches, fused_cases, phantom, sphere, plane,
                  pointer):
    """Phase 24: the sharded drivers on a one-process group (NCCL on the card:
    it gives each process a card of its own).  ``fused_cases``: ``(family,
    data tensors, groups, delta)`` of phases 5, 9, 13 and 16; ``phantom``:
    ``(estimator, data, groups, chunks)`` of phase 22; ``sphere``:
    ``(estimator, points)`` of phase 5; ``plane``: ``(estimator, points,
    mask)`` of phase 10; ``pointer``: ``(estimator, data, mask)`` of phase 16."""
    import tempfile

    import torch.distributed as dist

    from lsqrrecipes_tpu_torch import kernels
    from lsqrrecipes_tpu_torch.linalg import stats_lm
    from lsqrrecipes_tpu_torch.ops import fused_sweep as fs
    from lsqrrecipes_tpu_torch.parallel import (
        default_mesh,
        initialize_distributed,
        sharded_fused_sweep,
        sharded_lsq_fit,
        sharded_ransac,
        sharded_us_sweep,
    )
    from lsqrrecipes_tpu_torch.parallel.sharded import sharded_us_feature_lm
    from lsqrrecipes_tpu_torch.ransac import engine
    from lsqrrecipes_tpu_torch.ransac.sampling import sample_k_subsets
    from lsqrrecipes_tpu_torch.tree import n_obs

    seeds = iter(range(24_000, 25_000))

    def gen():
        return torch.Generator(device=dev).manual_seed(next(seeds))

    def launched(fn):
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        add_launches(counts)
        return out, counts

    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(f"file://{tmp}/store", 1, 0, device_type=dev.type)
        try:
            mesh = default_mesh(shape=(1, 1), device_type=dev.type)
            print(f"[24] one-process {dist.get_backend()} group, mesh {tuple(mesh.shape)} "
                  f"{tuple(mesh.mesh_dim_names)}")
            for family, data, groups, delta in fused_cases:
                name = f"fused_sweep_{family}"
                k_slots = fs._FAMILIES[family][0]
                n = n_obs(data)
                perms = fs.draw_slot_perms(fs.fit_size(n, k_slots), k_slots, gen(), dev)
                (count, params), counts = launched(lambda: sharded_fused_sweep(
                    family, data, None, groups, delta, mesh, perms=perms[None]))
                count1, params1 = fs.fused_sweep(family, data, None, groups, delta, perms=perms)
                same = int(count) == int(count1) and torch.equal(params, params1)
                wall = timer.wall_ms(lambda: sharded_fused_sweep(
                    family, data, None, groups, delta, mesh, perms=perms[None]), reps=WALL_REPS)
                wall1 = timer.wall_ms(lambda: fs.fused_sweep(family, data, None, groups, delta,
                                                             perms=perms), reps=WALL_REPS)
                print(f"    sharded_fused_sweep {family} n={n} groups={groups}: launches "
                      f"{counts[name]}, count {int(count)}, equal to fused_sweep {same}; wall "
                      f"{wall:.3f} ms vs {wall1:.3f} ms single-device (medians of {WALL_REPS}) "
                      f"[{smi}]")
                check(counts[name] > 0, f"sharded_fused_sweep did not launch {name}")
                check(same, f"[24] sharded_fused_sweep {family} differs from fused_sweep")

            ph_est, ph_data, ph_groups, ph_chunks = phantom
            perm = torch.randperm(n_obs(ph_data), generator=gen(), device=dev)
            (c_s, p_s), counts = launched(lambda: sharded_us_sweep(
                "plane_phantom", ph_est, ph_data, None, ph_groups, mesh, perm=perm))
            c_1, p_1 = ph_est.structured_sweep(ph_data, None, ph_groups, perm=perm)
            same = torch.equal(c_s, c_1) and torch.equal(p_s, p_1)
            wall = timer.wall_ms(lambda: sharded_us_sweep(
                "plane_phantom", ph_est, ph_data, None, ph_groups, mesh, perm=perm), reps=WALL_REPS)
            wall1 = timer.wall_ms(lambda: ph_est.structured_sweep(ph_data, None, ph_groups,
                                                                  perm=perm), reps=WALL_REPS)
            print(f"    sharded_us_sweep plane_phantom hypotheses={c_s.numel()}: launches "
                  f"{counts['phantom_qr']} (chunks {ph_chunks}), equal to structured_sweep "
                  f"{same}; wall {wall:.3f} ms vs {wall1:.3f} ms [{smi}]")
            check(counts["phantom_qr"] == ph_chunks, "sharded_us_sweep did not launch B6 per chunk")
            check(same, "[24] sharded_us_sweep differs from structured_sweep")

            sph_est, pts = sphere
            seed = next(seeds)
            res, counts = launched(lambda: sharded_ransac(
                sph_est, pts, torch.Generator(device=dev).manual_seed(seed), H_GATHER, mesh))
            idx = sample_k_subsets(torch.Generator(device=dev).manual_seed(seed), pts.shape[0],
                                   sph_est.k, H_GATHER, dev)
            count1, mask1, _ = engine.hypothesize_and_vote(sph_est, pts, idx)
            params1, valid1 = sph_est.lsq_fit(pts, mask1)
            same = (int(res.best_count) == int(count1) and torch.equal(res.consensus, mask1)
                    and torch.equal(res.params, params1) and bool(res.valid) == bool(valid1))
            wall = timer.wall_ms(lambda: sharded_ransac(
                sph_est, pts, torch.Generator(device=dev).manual_seed(seed), H_GATHER, mesh),
                reps=WALL_REPS)
            wall1 = timer.wall_ms(lambda: sph_est.lsq_fit(pts, engine.hypothesize_and_vote(
                sph_est, pts, sample_k_subsets(torch.Generator(device=dev).manual_seed(seed),
                                               pts.shape[0], sph_est.k, H_GATHER, dev))[1]),
                reps=WALL_REPS)
            print(f"    sharded_ransac sphere n={pts.shape[0]} hypotheses={H_GATHER}: launches "
                  f"{counts['sphere_vote']}, count {int(res.best_count)}, equal to "
                  f"hypothesize_and_vote + lsq_fit {same}; wall {wall:.3f} ms vs {wall1:.3f} ms "
                  f"[{smi}]")
            check(counts["sphere_vote"] > 0, "sharded_ransac did not launch sphere_vote")
            check(same and bool(res.valid), "[24] sharded_ransac differs from the engine's step")

            pl_est, pl_pts, pl_mask = plane
            pl_s, ok_s = sharded_lsq_fit(pl_est, pl_pts, pl_mask, mesh)
            pl_1, ok_1 = pl_est.lsq_fit(pl_pts, pl_mask)
            same = torch.equal(pl_s, pl_1) and bool(ok_s) == bool(ok_1)
            print(f"    sharded_lsq_fit plane3d on {int(pl_mask.sum())} inliers: equal to lsq_fit "
                  f"{same}")
            check(same and bool(ok_s), "[24] sharded_lsq_fit differs from lsq_fit")

            pt_est, pt_data, pt_mask = pointer
            x0 = pt_est._analytic(pt_data, pt_mask)[0][:8]
            lm_s = sharded_us_feature_lm("pointer", pt_data, x0, pt_mask, pt_est.lm_config,
                                         mesh=mesh)
            lm_1 = stats_lm.us_feature_lm("pointer", pt_data, x0, pt_mask, pt_est.lm_config)
            d = float((lm_s.x - lm_1.x).abs().max())
            scale = float(lm_1.x.abs().max())
            wall = timer.wall_ms(lambda: sharded_us_feature_lm(
                "pointer", pt_data, x0, pt_mask, pt_est.lm_config, mesh=mesh), reps=WALL_REPS)
            wall1 = timer.wall_ms(lambda: stats_lm.us_feature_lm(
                "pointer", pt_data, x0, pt_mask, pt_est.lm_config), reps=WALL_REPS)
            print(f"    sharded_us_feature_lm pointer on {int(pt_mask.sum())} inliers: "
                  f"{int(lm_s.iterations)} iterations, max|dx| vs us_feature_lm {d:.3g}; wall "
                  f"{wall:.3f} ms vs {wall1:.3f} ms [{smi}]")
            check(bool(lm_s.converged) and bool(lm_1.converged) and d <= 1e-9 * scale,
                  "[24] sharded_us_feature_lm differs from us_feature_lm")
        finally:
            dist.destroy_process_group()


def phase_resume(torch, dev, rng, seed, add_launches, est):
    """Phase 25: a sweep cut after ``RESUME_CUT`` rounds and resumed from its
    ``.npz`` equals the uninterrupted one."""
    import os
    import tempfile

    from lsqrrecipes_tpu_torch import kernels
    from lsqrrecipes_tpu_torch.ransac.checkpoint import load_state, resumable_sweep

    pts = torch.as_tensor(bench_cloud(rng, RESUME_N), device=dev)
    total = RESUME_ROUNDS * RESUME_BATCH
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    full = resumable_sweep(est, pts, seed, total, RESUME_BATCH)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    add_launches(counts)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "sweep.npz")
        resumable_sweep(est, pts, seed, RESUME_CUT * RESUME_BATCH, RESUME_BATCH,
                        checkpoint_path=ckpt)
        cut = load_state(ckpt).evaluated
        resumed = resumable_sweep(est, pts, seed, total, RESUME_BATCH, checkpoint_path=ckpt)
    same = (resumed.evaluated == full.evaluated == total and resumed.best_count == full.best_count
            and torch.equal(resumed.best_mask, full.best_mask)
            and torch.equal(resumed.best_params, full.best_params)
            and torch.equal(resumed.rng_state, full.rng_state))
    print(f"[25] resumable_sweep sphere n={RESUME_N} {RESUME_ROUNDS} x {RESUME_BATCH} hypotheses: "
          f"launches {counts['sphere_vote']}, best count {full.best_count}, {full_s:.3f} s; cut "
          f"at {cut}, resumed equal to uninterrupted {same}")
    check(counts["sphere_vote"] > 0, "resumable_sweep did not launch sphere_vote")
    check(cut == RESUME_CUT * RESUME_BATCH, "[25] the checkpoint holds the wrong round")
    check(same, "[25] the resumed sweep differs from the uninterrupted one")
    check(full.best_count > RESUME_N // 2, "[25] the sweep found no sphere")


def synthetic_errors(kind, params, truth):
    """(max translation error, rotation error in degrees, max scale error)
    of an ANALYTIC fit against a synthetic generator's truth."""
    x = params.double().cpu().numpy()
    t = {k: v.double().cpu().numpy() for k, v in truth.items()}
    if kind == "plane_phantom":
        return phantom_errors(x, {"normal": t["r1_row3"], "t1_z": float(t["t1_z"]),
                                  "t3": t["t3"], "r3": t["r3"]})
    trans = [x[0:3] - t["t1"]] if kind == "crosswire" else []
    if kind == "crosswire":
        x = x[3:]
    trans.append(x[0:3] - t["t3"])
    cos = (np.trace(euler_np(*x[3:6]).T @ t["r3"]) - 1.0) / 2.0
    angle = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    return (float(np.abs(np.concatenate(trans)).max()), angle,
            float(np.abs(x[6:8] - [US_MX, US_MY]).max()))


def run_captured(fn, *args):
    """``fn(*args)`` with its standard output captured -> (result, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


class LaunchRecorder:
    """While active, keeps every fused sweep and sphere vote launch made
    through the wrappers (``fused_sweep.sweep_cuda``,
    ``vote.sphere_vote_counts_cuda``): copies of its inputs and the
    kernel's result, for :meth:`compare` to hold against the plain
    versions once the path has run."""

    def __init__(self):
        from lsqrrecipes_tpu_torch.ops import fused_sweep, vote

        self.fs, self.vote = fused_sweep, vote
        self.sweeps, self.votes = [], []

    def __enter__(self):
        self.saved = (self.fs.sweep_cuda, self.vote.sphere_vote_counts_cuda)
        sweep_cuda, vote_cuda = self.saved

        def record_sweep(family, coords, p, n_fit, num_groups, vote_cols, delta):
            out = sweep_cuda(family, coords, p, n_fit, num_groups, vote_cols, delta)
            self.sweeps.append((family, coords.clone(), p.clone(), n_fit, num_groups,
                                vote_cols, delta, tuple(t.clone() for t in out)))
            return out

        def record_vote(params, points_t, valid, delta):
            out = vote_cuda(params, points_t, valid, delta)
            self.votes.append((params.clone(), points_t.clone(), valid.clone(), delta,
                               out.clone()))
            return out

        self.fs.sweep_cuda, self.vote.sphere_vote_counts_cuda = record_sweep, record_vote
        return self

    def __exit__(self, *exc):
        self.fs.sweep_cuda, self.vote.sphere_vote_counts_cuda = self.saved

    def recorded(self):
        """Launches kept, by kernel name."""
        counts = {}
        for rec in self.sweeps:
            counts[f"fused_sweep_{rec[0]}"] = counts.get(f"fused_sweep_{rec[0]}", 0) + 1
        if self.votes:
            counts["sphere_vote"] = len(self.votes)
        return counts

    def compare(self, label):
        """Every launch kept against its plain version on the same card
        tensors, as phases 3, 4, 12 and 13 hold them: sweeps by
        :func:`compare_sweep` (exact where those phases are), votes equal
        count for count.  Clears the record; returns the largest error by
        kernel name."""
        from lsqrrecipes_tpu_torch import kernels

        errs = {}
        for family, coords, p, n_fit, num_groups, vote_cols, delta, out in self.sweeps:
            name = f"fused_sweep_{family}"
            exact = (family == "sphere3d" or family in kernels.RIGID_FAMILIES
                     or family in EXACT_POINT_SWEEPS)
            err = compare_sweep(self.fs, family, None, coords, p, n_fit, num_groups, vote_cols,
                                None, f"    {label} {name} {num_groups * n_fit} hypotheses "
                                f"n_fit={n_fit}", delta=delta, exact=exact, kernel=out)
            errs[name] = max(errs.get(name, 0.0), err)
        for params, points_t, valid, delta, out in self.votes:
            plain = self.vote.sphere_vote_counts_plain(params, points_t, valid, delta)
            err = int((out.long() - plain.long()).abs().max()) if out.numel() else 0
            print(f"    {label} sphere_vote B={params.shape[0]} n={points_t.shape[1]}: "
                  f"max|kernel-plain|={err} (must be 0)")
            check(err == 0, f"[26] {label}: sphere_vote disagrees with its plain version")
            errs["sphere_vote"] = max(errs.get("sphere_vote", 0), err)
        self.sweeps, self.votes = [], []
        return errs


def far_refit_cases(seed, geometry):
    """Phase 27's clouds at the origin, float32 numpy, from a generator of
    its own: ``(label, family, data, hypotheses)`` on the data models and
    shapes of phases 5, 9 and 13."""
    rng = np.random.default_rng([seed, 27])
    sphere = bench_cloud(rng, N_MAIN)
    cases = [(f"sphere3d {mode}", "sphere3d", sphere, H_FUSED) for mode in ("ALGEBRAIC",
                                                                            "GEOMETRIC")]
    cases += [(f, f, family_cloud(rng, f, N_MAIN), H_FUSED) for f in FAMILIES]
    _, n13, groups13, _ = RIGID["absolute_orientation"]
    cases.append(("absolute_orientation", "absolute_orientation",
                  rigid_data(rng, "absolute_orientation", n13, geometry), groups13 * n13))
    return cases


def far_estimator(label):
    from lsqrrecipes_tpu_torch.estimators import ALGEBRAIC, GEOMETRIC, SphereEstimator, get

    if label.startswith("sphere3d"):
        return SphereEstimator(DELTA, 3, ALGEBRAIC if label.endswith("ALGEBRAIC") else GEOMETRIC)
    if label in FAMILIES:
        name = FAMILIES[label][0]
        return get(name)(DELTA) if label == "line2d" else get(name)(DELTA, 3)
    return get(RIGID[label][0])(DELTA)


def far_shift(data, s):
    """``data`` ``s`` from the origin on every axis (both sets of a pair),
    float32."""
    if isinstance(data, tuple):
        return tuple(x + np.float32(s) for x in data)
    return data + np.float32(s)


def far_refit_runs(torch, dev, seed, timer, reps=WALL_REPS):
    """Phase 27's runs: each case's ``ransac_fused_sweep`` at the origin and
    ``FAR_OFFSET`` from it from one generator seed (the same hypotheses),
    the float64 refit of the far consensus on the card (the estimator on
    the upcast points) and the median wall of ``reps`` ``consensus_refit``
    calls at each offset (``refit`` repeats the call).  Returns ``(rows,
    launch counts of the sweeps)``;
    the checks are the caller's, so that ``far_refits.py`` can run this on
    another checkout's package."""
    from lsqrrecipes_tpu_torch import geometry, interop, kernels
    from lsqrrecipes_tpu_torch.ransac import consensus_refit, ransac_fused_sweep
    from lsqrrecipes_tpu_torch.tree import tree_map

    rows, launches = [], {}
    for label, family, cloud, hyp in far_refit_cases(seed, geometry):
        est = far_estimator(label)
        row = {"label": label, "family": family}
        for key, s in (("origin", 0.0), ("far", FAR_OFFSET)):
            data = interop.data_to_torch(far_shift(cloud, s), device=dev)
            gen = torch.Generator(device=dev).manual_seed(seed + 27)
            kernels.reset_launch_counts()
            res = ransac_fused_sweep(est, data, gen, num_hypotheses=hyp, device=dev)
            torch.cuda.synchronize()
            for k, v in kernels.launch_counts().items():
                launches[k] = launches.get(k, 0) + v
            mask = res.consensus

            def refit(est=est, data=data, mask=mask):
                return consensus_refit(est, data, mask)

            row[key] = {"count": int(res.best_count), "valid": bool(res.valid),
                        "params": res.params.double().cpu().numpy(),
                        "refit_ms": timer.wall_ms(refit, reps=reps), "refit": refit}
        f64, _ = est.lsq_fit(tree_map(lambda x: x.double(), data), mask)
        row["f64"] = f64.cpu().numpy()
        rows.append(row)
    return rows, launches


def far_refit_errors(row):
    """A phase-27 row's figures: the far count less the origin's; the far
    refit's truth errors with the offset taken back out, in the order of
    the phase's limits, and those limits; and the far params' largest
    distance from the float64 refit, in float32 ulps of the cast refit
    (GEOMETRIC: in data units, against the float64 LM)."""
    s, family = FAR_OFFSET, row["family"]
    p, f64 = row["far"]["params"], row["f64"]
    if row["label"].endswith("GEOMETRIC"):
        dist = float(np.abs(p - f64).max())
    else:
        cast = f64.astype(np.float32)
        dist = float((np.abs(p - cast) / np.spacing(np.abs(cast))).max())
    if family == "sphere3d":
        errors = (float(np.abs(p[:3] - s - TRUE_CENTER).max()), abs(float(p[3]) - TRUE_RADIUS))
        limits = (0.1, 0.1)
    elif family in FAMILIES:
        d = len(FAMILIES[family][1])
        errors = recovery_errors(family, np.concatenate([p[:d], p[d:] - s]))
        limits = (MAX_ANGLE, MAX_ANCHOR)
    else:
        t = p[4:] - s + rotation_np(p[:4]) @ np.full(3, s)
        errors = rigid_errors(family, np.concatenate([p[:4], t]))
        limits = RIGID_LIMITS[family]
    return row["far"]["count"] - row["origin"]["count"], errors, limits, dist


def phase_far_refits(torch, dev, seed, add_launches, timer, smi):
    """Phase 27 (see the module docstring)."""
    t0 = time.perf_counter()
    rows, counts = far_refit_runs(torch, dev, seed, timer)
    add_launches(counts)
    print(f"[27] far refits, {FAR_OFFSET:g} from the origin: launches {counts}")
    for row in rows:
        label, (origin, far) = row["label"], (row["origin"], row["far"])
        d_count, errors, limits, dist = far_refit_errors(row)
        geometric = label.endswith("GEOMETRIC")
        print(f"    {label}: counts {origin['count']} / {far['count']}, valid {far['valid']}, "
              f"errors {[f'{e:.3e}' for e in errors]} (limits {list(limits)}), from the "
              f"float64 refit {dist:.3g}{'' if geometric else ' ulp'}; consensus_refit wall "
              f"{origin['refit_ms']:.3f} / {far['refit_ms']:.3f} ms median of {WALL_REPS} "
              f"[{smi}]")
        check(origin["valid"] and far["valid"], f"[27] {label}: result not valid")
        check(bool(np.isfinite(far["params"]).all()), f"[27] {label}: non-finite params")
        check(abs(d_count) <= FAR_COUNT_SLACK,
              f"[27] {label}: the far count is {d_count:+d} from the origin's")
        check(all(e < lim for e, lim in zip(errors, limits)),
              f"[27] {label}: ground truth not recovered far from the origin: {errors}")
        check(dist <= (FAR_GEOMETRIC_TOL if geometric else 1.0),
              f"[27] {label}: the params are {dist} from the float64 refit")
    for k in ("fused_sweep_sphere3d", "fused_sweep_plane3d", "fused_sweep_line3d",
              "fused_sweep_line2d", "fused_sweep_absolute_orientation"):
        check(counts.get(k, 0) > 0, f"[27] the far refits did not launch {k}")
    far_s = time.perf_counter() - t0
    print(f"    phase 27 took {far_s:.1f} s (budget {FAR_REFIT_BUDGET_S:.0f} s)")
    check(far_s < FAR_REFIT_BUDGET_S, "phase 27 overran its budget")


def phase_host_layers(torch, dev, seed, add_launches, name, timer, smi):
    """Phase 26: the CLI (``info``, ``bench`` at phase 5's width, once inside
    ``utils.profiling.trace``, and the bench's call timed and profiled), the
    synthetic generators on a CUDA generator and every example on the card,
    in a temporary directory.  Each kernel launch of the first bench and of
    the examples is held against its plain version on the same inputs, and
    the data-reading examples' estimates against the truth of their files.
    Returns the largest kernel-vs-plain error by kernel name."""
    import contextlib
    import importlib
    import os
    import tempfile

    from lsqrrecipes_tpu_torch import cli, kernels, synthetic
    from lsqrrecipes_tpu_torch.estimators import ANALYTIC, get
    from lsqrrecipes_tpu_torch.examples.common import (
        EXAMPLE_ARTIFACTS,
        READS_DATA,
        check_iv,
        check_xml,
        estimate_errors,
        reference_format_truth,
        write_reference_format_data,
    )
    from lsqrrecipes_tpu_torch.utils.profiling import trace

    recorder, plain_errs, compare_s = LaunchRecorder(), {}, 0.0

    def compare(label, counts):
        """Check that the recorder kept every launch counted, then hold
        them against the plain versions, off the phase's clock."""
        nonlocal compare_s
        launched = {k: v for k, v in counts.items() if v and k.startswith(RECORDED_KERNELS)}
        check(recorder.recorded() == launched,
              f"[26] {label}: launches {launched}, recorded {recorder.recorded()}")
        t0 = time.perf_counter()
        for k, e in recorder.compare(label).items():
            plain_errs[k] = max(plain_errs.get(k, 0), e)
        compare_s += time.perf_counter() - t0

    t_host = time.perf_counter()
    rc, out = run_captured(cli.main, ["info"])
    registry = [line for line in out.splitlines() if line.startswith("  ")]
    print(f"[26] cli info: rc {rc}, {len(registry)} estimators; "
          f"{out.splitlines()[1] if len(out.splitlines()) > 1 else ''}")
    check(rc == 0 and name in out and len(registry) == 11, "[26] cli info is incomplete")

    bench_args = ["bench", "--hypotheses", str(H_FUSED), "--n", str(N_MAIN)]
    kernels.reset_launch_counts()
    with recorder:
        rc, out = run_captured(cli.main, bench_args)
    counts = kernels.launch_counts()
    add_launches(counts)
    payload = json.loads(out.strip().splitlines()[-1])
    print(f"    cli bench --hypotheses {H_FUSED} --n {N_MAIN}: {json.dumps(payload)}; "
          f"fused_sweep_sphere3d launches {counts['fused_sweep_sphere3d']}")
    check(rc == 0, "[26] cli bench failed")
    check(counts["fused_sweep_sphere3d"] == 2, "[26] cli bench did not launch the sphere "
          "sweep exactly twice (warm and timed)")
    check(payload["center_error"] < 1.0 and payload["inlier_fraction"] >= 0.75,
          "[26] cli bench did not recover the sphere")
    compare("cli bench", counts)
    # The bench's timed call on its own cloud: median wall and one profile.
    from lsqrrecipes_tpu_torch.estimators import SphereEstimator
    from lsqrrecipes_tpu_torch.ransac import ransac_fused_sweep

    pts, _ = cli.bench_cloud(torch.Generator(device=dev).manual_seed(0), N_MAIN, dev)
    bench_est = SphereEstimator(delta=0.5, dim=3)

    def bench_call():
        return ransac_fused_sweep(bench_est, pts, torch.Generator(device=dev).manual_seed(7),
                                  num_hypotheses=H_FUSED)

    wall = timer.wall_ms(bench_call, reps=WALL_REPS)
    print(f"    the bench's call: wall {wall:.3f} ms median of {WALL_REPS}, "
          f"{H_FUSED / wall * 1e3:.4g} hypotheses/s [{smi}]")
    breakdown(torch, bench_call, "cli bench")
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_launch_counts()
        with trace(os.path.join(tmp, "trace")) as where:
            rc, out = run_captured(cli.main, bench_args)
        add_launches(kernels.launch_counts())
        with open(os.path.join(where, "trace.json")) as f:
            text = f.read()
        hits = text.count("sphere3d_kernel")
        print(f"    cli bench inside utils.profiling.trace: rc {rc}, trace {len(text)} bytes, "
              f"{hits} events name sphere3d_kernel; {json.loads(out.strip().splitlines()[-1])}")
        check(rc == 0 and hits > 0, "[26] the trace does not name the B1 sphere3d kernel")

    makes = {"crosswire": synthetic.make_crosswire_data, "pointer": synthetic.make_pointer_data,
             "plane_phantom": synthetic.make_plane_phantom_data}
    estimators = {"crosswire": "us_crosswire", "pointer": "us_pointer",
                  "plane_phantom": "us_plane_phantom"}
    for i, (kind, make) in enumerate(makes.items()):
        noisy, clean, truth = make(torch.Generator(device=dev).manual_seed(seed + i), n=HOST_N)
        check(all(leaf.is_cuda for leaf in (noisy[0].r, clean[1], *truth.values())),
              f"[26] make_{kind}_data left the card")
        params, valid = get(estimators[kind])(1.0, ls_type=ANALYTIC).lsq_fit(clean)
        errs = synthetic_errors(kind, params, truth)
        print(f"    make_{kind}_data n={HOST_N} on a CUDA generator, ANALYTIC fit of the "
              f"clean set: valid {bool(valid)}, errors (translation, degrees, scale) "
              f"{', '.join(f'{e:.3g}' for e in errs)}")
        check(bool(valid) and all(e < lim for e, lim in zip(errs, HOST_LIMITS[kind])),
              f"[26] the clean {kind} set does not recover its truth")

    truth = reference_format_truth(seed)
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        data_dir = str(write_reference_format_data(os.path.join(tmp, "data"), seed=seed))
        for example, (scenes, xmls) in EXAMPLE_ARTIFACTS.items():
            argv = ["--device", "cuda"] + (["--data-dir", data_dir] if example in READS_DATA
                                           else [])
            module = importlib.import_module(f"lsqrrecipes_tpu_torch.examples.{example}")
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            with recorder:
                rc, out = run_captured(module.main, argv)
                torch.cuda.synchronize()
            took = time.perf_counter() - t0
            counts = kernels.launch_counts()
            add_launches(counts)
            launched = {k: v for k, v in counts.items() if v}
            print(f"    example {example}: rc {rc}, {took:.2f} s, launches {launched}; "
                  f"{out.strip().splitlines()[-1]}")
            check(rc == 0 and ("RANSAC" in out or "ransac" in out)
                  and "nothing to do" not in out, f"[26] example {example} failed")
            for artifact in scenes:
                check(os.path.exists(artifact), f"[26] {example} did not write {artifact}")
                check_iv(artifact)
            for artifact in xmls:
                check(os.path.exists(artifact), f"[26] {example} did not write {artifact}")
                check_xml(artifact)
            for k in EXAMPLE_KERNELS.get(example, ()):
                check(counts[k] >= 1, f"[26] example {example} did not launch {k}")
            if example in READS_DATA:
                found = estimate_errors(example, out, truth, xml_path=xmls[0] if xmls else None)
                print(f"    {example} against the truth of its files: "
                      + ", ".join(f"{what} {err:.3g} (< {limit:g})"
                                  for what, err, limit in found))
                check(all(err < limit for _, err, limit in found),
                      f"[26] example {example} did not recover the truth of its files")
            compare(example, counts)
    host_s = time.perf_counter() - t_host - compare_s
    print(f"    phase 26 took {host_s:.1f} s (budget {HOST_PHASE_BUDGET_S:.0f} s), and its "
          f"plain versions {compare_s:.1f} s (budget {HOST_COMPARE_BUDGET_S:.0f} s)")
    check(host_s < HOST_PHASE_BUDGET_S, "phase 26 overran its budget")
    check(compare_s < HOST_COMPARE_BUDGET_S, "phase 26's plain versions overran their budget")
    return plain_errs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    from lsqrrecipes_tpu_torch import kernels
    from lsqrrecipes_tpu_torch.estimators import ALGEBRAIC, SphereEstimator, get
    from lsqrrecipes_tpu_torch.ops import fused_sweep as fs
    from lsqrrecipes_tpu_torch.ops import vote
    from lsqrrecipes_tpu_torch.estimators import sphere as sphere_est
    from lsqrrecipes_tpu_torch.ransac import (
        ransac,
        ransac_adaptive,
        ransac_fused_sweep,
        ransac_structured,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(args.seed)
    timer = Timer(torch)
    est = SphereEstimator(DELTA, 3, ALGEBRAIC)

    # 1. device -------------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"[1] device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    rates = peaks(name)

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"[2] build: {time.perf_counter() - t0:.1f} s ({len(kernels.ALL)} kernels from "
          f"{len({k.source for k in kernels.ALL})} sources, parallel nvcc)")
    for k in kernels.ALL:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {k.name}: {line.strip()}")
    for k in (kernels.FUSED_SWEEP_SPHERE3D, kernels.FUSED_SWEEP_LINE3D):
        print(f"    {k.name} at {H_FUSED}: {launch_shape(k, H_FUSED)}")
    for family in RIGID:
        k = kernels.FUSED_SWEEPS[family]
        hyp2 = RIGID[family][2] * fs.fit_size(RIGID[family][1], fs._FAMILIES[family][0])
        print(f"    {k.name} at {hyp2}: {launch_shape(k, hyp2)}")
    for family, (_, n_us, groups_us, _) in US.items():
        k, hyp_us = kernels.FUSED_SWEEPS[family], n_us * groups_us
        print(f"    {k.name} at {hyp_us}: vote {launch_shape(k, hyp_us)}; "
              f"fit {launch_shape(k, hyp_us, 'fit_shape')}")

    # 3. sphere_vote vs plain -----------------------------------------------
    n, b = N_VOTE, B_VOTE
    pts_np = bench_cloud(rng, n)
    pts = torch.as_tensor(pts_np, device=dev)
    near = np.concatenate([TRUE_CENTER + rng.normal(0, 2.0, (b // 2, 3)),
                           TRUE_RADIUS + rng.normal(0, 2.0, (b // 2, 1))], 1)
    wide = np.concatenate([rng.uniform(-20, 30, (b - b // 2, 3)),
                           rng.uniform(5, 45, (b - b // 2, 1))], 1)
    params = torch.as_tensor(np.concatenate([near, wide]).astype(np.float32), device=dev)
    points_t, valid, _ = vote.pack_points(pts)
    got = vote.sphere_vote_counts_cuda(params, points_t, valid, DELTA)
    plain = vote.sphere_vote_counts_plain(params, points_t, valid, DELTA)
    torch.cuda.synchronize()
    vote_err = int((got.long() - plain.long()).abs().max())
    sub = torch.arange(0, b, b // 4096, device=dev)
    p64, c64 = pts.double(), params[sub].double()
    dist = torch.cdist(c64[:, :3], p64, compute_mode="donot_use_mm_for_euclid_dist")
    oracle = ((dist - c64[:, 3:4]).abs() < DELTA).sum(1)
    flips = (got[sub].long() - oracle).abs()
    print(f"[3] sphere_vote B={b} n={n}: max|kernel-plain|={vote_err} (must be 0); "
          f"vs f64 agree on {len(sub)}: max|d|={int(flips.max())} (<=5), "
          f"total flips={int(flips.sum())}; mean count={float(got.float().mean()):.1f}")
    check(vote_err == 0, "sphere_vote disagrees with its plain version")
    check(int(flips.max()) <= 5, "sphere_vote disagrees with the f64 oracle")
    vote_ms = timer.ms(lambda: vote.sphere_vote_counts_cuda(params, points_t, valid, DELTA), reps=20)
    vote_plain_ms = timer.ms(lambda: vote.sphere_vote_counts_plain(params, points_t, valid, DELTA), reps=5)
    vote_lib_ms = timer.ms(lambda: library_vote(torch, params, pts, DELTA), reps=5)
    lib = library_vote(torch, params, pts, DELTA)
    print(f"    library yardstick max|d| vs kernel = {int((lib - got.long()).abs().max())}")
    vote_ops = b * n * VOTE_OPS_PER_CELL
    vote_bytes = b * 16 + 4 * points_t.shape[1] * 4 + b * 4
    vote_bound, vote_by = bound(vote_ops, vote_bytes, rates)
    print(f"    ms: kernel {vote_ms:.4f}, plain {vote_plain_ms:.4f}, library {vote_lib_ms:.4f}, "
          f"bound {vote_bound:.4f} ({vote_by}) [{smi}]")
    print(f"    sphere_vote at {b}: {launch_shape(kernels.SPHERE_VOTE, b)}")
    # The same hypotheses about the same sphere, FAR_OFFSET from the origin.
    far3 = torch.as_tensor(far_cloud(args.seed, 3, n), device=dev)
    params3 = params + torch.tensor([FAR_OFFSET] * 3 + [0.0], device=dev)
    pt3, valid3, _ = vote.pack_points(far3)
    got3 = vote.sphere_vote_counts_cuda(params3, pt3, valid3, DELTA)
    err3 = int((got3.long() - vote.sphere_vote_counts_plain(params3, pt3, valid3, DELTA).long())
               .abs().max())
    dist3 = torch.cdist(params3[:, :3].double(), far3.double(),
                        compute_mode="donot_use_mm_for_euclid_dist")
    max3 = int(((dist3 - params3[:, 3:4].double()).abs() < DELTA).sum(1).max())
    print(f"    the cloud {FAR_OFFSET:g} from the origin: max|kernel-plain|={err3} (must be 0); "
          f"best count {int(got3.max())}, float64 agree maximum {max3}")
    check(err3 == 0, "sphere_vote disagrees with its plain version far from the origin")
    check(abs(int(got3.max()) - max3) <= 1, "[3] sphere_vote far from the origin: the best "
          "count is not within 1 of the float64 maximum")
    vote_err = max(vote_err, err3)

    # 4. fused_sweep_sphere3d vs plain --------------------------------------
    sweep_err = 0
    for n_case, total_groups, gps, subsample in SWEEP_CASES:
        cloud = torch.as_tensor(bench_cloud(rng, n_case), device=dev)
        g4 = torch.Generator(device=dev).manual_seed(args.seed + n_case + gps)
        vote_perm = torch.randperm(n_case, generator=g4, device=dev)
        coords, p, n_fit, vote_cols = fs.sweep_inputs(
            "sphere3d", cloud, g4, subsample, vote_perm=vote_perm
        )
        num_groups = -(-total_groups // gps) * gps
        voters = cloud[vote_perm][:vote_cols] if subsample else cloud
        sweep_err = max(sweep_err, compare_sweep(
            fs, "sphere3d", est, coords, p, n_fit, num_groups, vote_cols, voters,
            f"[4] fused_sweep n={n_case} groups={total_groups} gps={gps} "
            f"subsample={subsample}", exact=True))
    far4 = torch.as_tensor(far_cloud(args.seed, 4, N_MAIN), device=dev)
    perms4 = fs.draw_slot_perms(N_MAIN, 4, torch.Generator(device=dev).manual_seed(args.seed),
                                device=dev)
    coords, p, n_fit, vote_cols = fs.sweep_inputs("sphere3d", far4, None, perms=perms4)
    groups4 = SWEEP_CASES[0][1]
    sweep_err = max(sweep_err, compare_sweep(
        fs, "sphere3d", est, coords, p, n_fit, groups4, vote_cols, far4,
        f"[4] fused_sweep n={N_MAIN} groups={groups4}, the cloud {FAR_OFFSET:g} from the origin",
        exact=True))
    far_count = int(fs.sweep_cuda("sphere3d", coords, p, n_fit, groups4, vote_cols, DELTA)[0])
    far_max = f64_best(est, fs.reference_samples("sphere3d", far4, perms4, groups4), far4)
    print(f"    best count {far_count}, float64 minimal_fit + agree maximum {far_max}")
    check(abs(far_count - far_max) <= 1, "[4] sphere3d far from the origin: the best count is "
          "not within 1 of the float64 maximum")

    # 5. main path: ransac_fused_sweep, one launch ---------------------------
    seeds = iter(range(args.seed + 100, args.seed + 10_000))

    def gen():
        return torch.Generator(device=dev).manual_seed(next(seeds))

    def check_result(result, label, n):
        params = result.params.double().cpu().numpy()
        c_err = float(np.abs(params[:3] - TRUE_CENTER).max())
        r_err = abs(float(params[3]) - TRUE_RADIUS)
        print(f"    {label}: valid={bool(result.valid)} center={params[:3].round(4).tolist()} "
              f"r={params[3]:.4f} inliers={int(result.best_count)} "
              f"fraction={float(result.inlier_fraction):.4f}")
        check(bool(result.valid), f"{label}: result not valid")
        check(c_err < 0.1 and r_err < 0.1, f"{label}: center {c_err} / radius {r_err} off")
        check(tuple(result.consensus.shape) == (n,), f"{label}: consensus shape")
        check(bool(np.isfinite(params).all()), f"{label}: non-finite params")

    launches = {}
    n5, h5 = N_MAIN, H_FUSED
    cloud5 = bench_cloud(rng, n5)
    kernels.reset_launch_counts()
    res5 = ransac_fused_sweep(est, cloud5, gen(), num_hypotheses=h5, device=DEVICE)
    torch.cuda.synchronize()
    counts5 = kernels.launch_counts()
    print(f"[5] ransac_fused_sweep n={n5} hypotheses={h5}: launches {counts5}")
    check_result(res5, "fused", n5)
    check(counts5["fused_sweep_sphere3d"] > 0, "main path did not launch fused_sweep_sphere3d")
    for k, v in counts5.items():
        launches[k] = launches.get(k, 0) + v
    wall5 = timer.wall_ms(lambda: ransac_fused_sweep(est, cloud5, gen(), num_hypotheses=h5, device=DEVICE),
                          reps=WALL_REPS)
    print(f"    wall {wall5:.3f} ms median of {WALL_REPS}, {h5 / wall5 * 1e3:.4g} hypotheses/s [{smi}]")
    breakdown(torch, lambda: ransac_fused_sweep(est, cloud5, gen(), num_hypotheses=h5, device=DEVICE),
              "fused")

    pts5 = torch.as_tensor(cloud5, device=dev)
    coords5, p5, nfit5, cols5 = fs.sweep_inputs("sphere3d", pts5, gen())
    groups5 = h5 // n5
    sweep_ms = timer.ms(lambda: fs.sphere3d_sweep_cuda(coords5, p5, nfit5, groups5, cols5, DELTA), reps=20)
    sweep_plain_ms = timer.ms(lambda: fs.sphere3d_sweep_plain(coords5, p5, nfit5, groups5, cols5, DELTA),
                              *plain_reps("sphere3d"))
    hyp5 = groups5 * nfit5
    sweep_ops = hyp5 * (cols5 * SWEEP_OPS_PER_CELL + SWEEP_OPS_PER_HYP)
    sweep_bytes = (coords5.numel() + p5.numel() + 5) * 4
    sweep_bound, sweep_by = bound(sweep_ops, sweep_bytes, rates)
    # The same launch on one column: the fit, the staging and the publishing.
    sweep_one_ms = timer.ms(lambda: fs.sphere3d_sweep_cuda(coords5, p5, nfit5, groups5, 1, DELTA),
                            reps=20)
    print(f"    kernel ms: sweep {sweep_ms:.4f} (on 1 column {sweep_one_ms:.4f}), plain "
          f"{sweep_plain_ms:.4f}, bound {sweep_bound:.4f} ({sweep_by}) [{smi}]")
    print(f"    fused_sweep_sphere3d at {hyp5}: "
          f"{launch_shape(kernels.FUSED_SWEEP_SPHERE3D, hyp5)}")
    sweep_err = max(sweep_err, compare_sweep(
        fs, "sphere3d", est, coords5, p5, nfit5, groups5, cols5, pts5,
        f"    fused_sweep at this shape ({groups5} groups)", exact=True))

    # 6. main path: ransac, gathered hypotheses -----------------------------
    h6 = H_GATHER
    kernels.reset_launch_counts()
    res6 = ransac(est, cloud5, gen(), num_hypotheses=h6, device=DEVICE)
    torch.cuda.synchronize()
    counts6 = kernels.launch_counts()
    print(f"[6] ransac n={n5} hypotheses={h6}: launches {counts6}")
    check_result(res6, "gather", n5)
    check(counts6["sphere_vote"] > 0, "main path did not launch sphere_vote")
    for k, v in counts6.items():
        launches[k] = launches.get(k, 0) + v
    wall6 = timer.wall_ms(lambda: ransac(est, cloud5, gen(), num_hypotheses=h6, device=DEVICE),
                          reps=WALL_REPS)
    print(f"    wall {wall6:.3f} ms median of {WALL_REPS}, {h6 / wall6 * 1e3:.4g} hypotheses/s [{smi}]")
    breakdown(torch, lambda: ransac(est, cloud5, gen(), num_hypotheses=h6, device=DEVICE), "gather")

    # 7. main path: large cloud, structured fallback -------------------------
    n7, h7 = N_LARGE, H_LARGE
    cloud7 = bench_cloud(rng, n7)
    kernels.reset_launch_counts()
    res7 = ransac_fused_sweep(est, cloud7, gen(), num_hypotheses=h7, device=DEVICE)
    torch.cuda.synchronize()
    counts7 = kernels.launch_counts()
    print(f"[7] ransac_fused_sweep n={n7} hypotheses={h7} (structured fallback): "
          f"launches {counts7}")
    check_result(res7, "large", n7)
    check(counts7["sphere_vote"] > 0, "large-cloud path did not launch sphere_vote")
    for k, v in counts7.items():
        launches[k] = launches.get(k, 0) + v
    wall7 = timer.wall_ms(lambda: ransac_fused_sweep(est, cloud7, gen(), num_hypotheses=h7, device=DEVICE),
                          reps=WALL_REPS)
    print(f"    wall {wall7:.3f} ms median of {WALL_REPS}, {h7 / wall7 * 1e3:.4g} hypotheses/s [{smi}]")
    breakdown(torch, lambda: ransac_fused_sweep(est, cloud7, gen(), num_hypotheses=h7, device=DEVICE),
              "large")

    pts7 = torch.as_tensor(cloud7, device=dev)
    params7 = torch.as_tensor(
        np.concatenate([TRUE_CENTER + rng.normal(0, 2.0, (h7, 3)),
                        TRUE_RADIUS + rng.normal(0, 2.0, (h7, 1))], 1).astype(np.float32),
        device=dev,
    )
    pt7, valid7, _ = vote.pack_points(pts7)
    got7 = vote.sphere_vote_counts_cuda(params7, pt7, valid7, DELTA)
    plain7 = vote.sphere_vote_counts_plain(params7, pt7, valid7, DELTA)
    err7 = int((got7.long() - plain7.long()).abs().max())
    frac7 = float((got7 != plain7).float().mean())
    print(f"    sphere_vote B={h7} n={n7}: max|kernel-plain|={err7} (must be 0), "
          f"hypotheses differing {frac7:.2e}")
    check(err7 == 0, "sphere_vote disagrees with its plain version at the large shape")
    ms7 = timer.ms(lambda: vote.sphere_vote_counts_cuda(params7, pt7, valid7, DELTA), reps=10)
    plain_ms7 = timer.ms(lambda: vote.sphere_vote_counts_plain(params7, pt7, valid7, DELTA),
                         reps=2, warmup=1)
    lib_ms7 = timer.ms(lambda: library_vote(torch, params7, pts7, DELTA), reps=2, warmup=1)
    ops7 = h7 * n7 * VOTE_OPS_PER_CELL
    bytes7 = h7 * 16 + 4 * pt7.shape[1] * 4 + h7 * 4
    bound7, by7 = bound(ops7, bytes7, rates)
    print(f"    ms kernel {ms7:.4f}, "
          f"plain {plain_ms7:.4f}, library {lib_ms7:.4f}, bound {bound7:.4f} ({by7}) [{smi}]")
    print(f"    sphere_vote at {h7}: {launch_shape(kernels.SPHERE_VOTE, h7)}")
    mhz7, watts7 = clocks_during(torch, lambda: vote.sphere_vote_counts_cuda(params7, pt7, valid7, DELTA))
    print(f"    while it runs: SM clock {mhz7:.0f} MHz, {watts7:.0f} W")

    def add_launches(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    def make_est(family):
        return get(FAMILIES[family][0])(DELTA) if family == "line2d" else \
            get(FAMILIES[family][0])(DELTA, 3)

    def check_family(result, family, label, n):
        params = result.params.double().cpu().numpy()
        angle, dist = recovery_errors(family, params)
        print(f"    {label}: valid={bool(result.valid)} params={params.round(4).tolist()} "
              f"inliers={int(result.best_count)} fraction={float(result.inlier_fraction):.4f} "
              f"angle={angle:.2e} rad anchor distance={dist:.2e}")
        check(bool(result.valid), f"{label}: result not valid")
        check(bool(np.isfinite(params).all()), f"{label}: non-finite params")
        check(tuple(result.consensus.shape) == (n,), f"{label}: consensus shape")
        check(angle < MAX_ANGLE, f"{label}: axis {angle} rad off (limit {MAX_ANGLE})")
        check(dist < MAX_ANCHOR, f"{label}: anchor {dist} off (limit {MAX_ANCHOR})")

    # 8. the point sweeps vs their plain versions ---------------------------
    family_err, family_times = {}, {}
    for family in FAMILIES:
        est_f = make_est(family)
        family_err[family] = 0
        for n_case, total_groups, gps, subsample in SWEEP_CASES:
            cloud = torch.as_tensor(family_cloud(rng, family, n_case), device=dev)
            g8 = torch.Generator(device=dev).manual_seed(args.seed + n_case + gps)
            vote_perm = torch.randperm(n_case, generator=g8, device=dev)
            coords, p, n_fit, vote_cols = fs.sweep_inputs(
                family, cloud, g8, subsample, vote_perm=vote_perm
            )
            num_groups = -(-total_groups // gps) * gps
            voters = cloud[vote_perm][:vote_cols] if subsample else cloud
            family_err[family] = max(family_err[family], compare_sweep(
                fs, family, est_f, coords, p, n_fit, num_groups, vote_cols, voters,
                f"[8] fused_sweep_{family} n={n_case} groups={total_groups} gps={gps} "
                f"subsample={subsample}", exact=family in EXACT_POINT_SWEEPS))
    far = family_cloud(np.random.default_rng([args.seed, 8]), "line3d", N_MAIN)  # rng's stream as before
    far = torch.as_tensor(far + np.float32(FAR_OFFSET), device=dev)
    perms8 = fs.draw_slot_perms(N_MAIN, 2, torch.Generator(device=dev).manual_seed(args.seed),
                                device=dev)
    coords, p, n_fit, vote_cols = fs.sweep_inputs("line3d", far, None, perms=perms8)
    groups8 = SWEEP_CASES[0][1]
    family_err["line3d"] = max(family_err["line3d"], compare_sweep(
        fs, "line3d", make_est("line3d"), coords, p, n_fit, groups8, vote_cols, far,
        f"[8] fused_sweep_line3d n={N_MAIN} groups={groups8}, the cloud {FAR_OFFSET:g} from "
        f"the origin", exact=True))
    far_count = int(fs.sweep_cuda("line3d", coords, p, n_fit, groups8, vote_cols, DELTA)[0])
    params8, valid8 = make_est("line3d").minimal_fit(
        fs.reference_samples("line3d", far, perms8, groups8).double())
    far_max = int(torch.where(valid8, make_est("line3d").agree(params8, far.double()).sum(-1),
                              0).max())
    print(f"    best count {far_count}, float64 agree maximum {far_max}")
    check(abs(far_count - far_max) <= 1, "[8] line3d far from the origin: the best count is "
          "not within 1 of the float64 maximum")

    # 9. main path per family: ransac_fused_sweep, one launch ---------------
    clouds9 = {}
    for family in FAMILIES:
        est_f = make_est(family)
        name_f = f"fused_sweep_{family}"
        cloud9 = clouds9[family] = family_cloud(rng, family, N_MAIN)
        kernels.reset_launch_counts()
        res9 = ransac_fused_sweep(est_f, cloud9, gen(), num_hypotheses=H_FUSED, device=DEVICE)
        torch.cuda.synchronize()
        counts9 = kernels.launch_counts()
        print(f"[9] ransac_fused_sweep {family} n={N_MAIN} hypotheses={H_FUSED}: launches {counts9}")
        check_family(res9, family, family, N_MAIN)
        check(counts9[name_f] > 0, f"main path did not launch {name_f}")
        add_launches(counts9)

        def run9(est_f=est_f, cloud9=cloud9):
            return ransac_fused_sweep(est_f, cloud9, gen(), num_hypotheses=H_FUSED, device=DEVICE)

        wall9 = timer.wall_ms(run9, reps=WALL_REPS)
        print(f"    wall {wall9:.3f} ms median of {WALL_REPS}, {H_FUSED / wall9 * 1e3:.4g} "
              f"hypotheses/s [{smi}]")
        breakdown(torch, run9, family)

        pts9 = torch.as_tensor(cloud9, device=dev)
        coords9, p9, nfit9, cols9 = fs.sweep_inputs(family, pts9, gen())
        groups9 = H_FUSED // N_MAIN
        ms9 = timer.ms(lambda: fs.sweep_cuda(family, coords9, p9, nfit9, groups9, cols9, DELTA),
                       reps=20)
        plain_ms9 = timer.ms(lambda: fs.sweep_plain(family, coords9, p9, nfit9, groups9, cols9,
                                                    DELTA), *plain_reps(family))
        per_cell, per_hyp = POINT_SWEEP_OPS[family]
        hyp9 = groups9 * nfit9
        bound9, by9 = bound(hyp9 * (cols9 * per_cell + per_hyp),
                            (coords9.numel() + p9.numel() + fs._FAMILIES[family][2] + 1) * 4,
                            rates)
        family_times[family] = (ms9, plain_ms9, bound9, by9)
        print(f"    kernel ms: {name_f} {ms9:.4f}, plain {plain_ms9:.4f}, "
              f"bound {bound9:.4f} ({by9}) [{smi}]")
        if family == "line3d":
            print(f"    {name_f} at {hyp9}: {launch_shape(kernels.FUSED_SWEEP_LINE3D, hyp9)}")
        family_err[family] = max(family_err[family], compare_sweep(
            fs, family, est_f, coords9, p9, nfit9, groups9, cols9, pts9,
            f"    fused_sweep_{family} at this shape ({groups9} groups)",
            exact=family in EXACT_POINT_SWEEPS))

    # 10. gathered planes (agree vote, no kernel) and adaptive 2D lines ------
    plane_est = make_est("plane3d")
    cloud10 = clouds9["plane3d"]
    kernels.reset_launch_counts()
    res10 = ransac(plane_est, cloud10, gen(), num_hypotheses=H_GATHER, device=DEVICE)
    torch.cuda.synchronize()
    counts10 = kernels.launch_counts()
    print(f"[10] ransac plane3d n={N_MAIN} hypotheses={H_GATHER}: launches {counts10}")
    check_family(res10, "plane3d", "gather plane", N_MAIN)
    check(sum(counts10.values()) == 0, "the plane gather path launched a kernel")

    def run10():
        return ransac(plane_est, cloud10, gen(), num_hypotheses=H_GATHER, device=DEVICE)

    wall10 = timer.wall_ms(run10, reps=WALL_REPS)
    print(f"    wall {wall10:.3f} ms median of {WALL_REPS}, {H_GATHER / wall10 * 1e3:.4g} "
          f"hypotheses/s [{smi}]")
    breakdown(torch, run10, "gather plane")

    line2d_est = make_est("line2d")
    cloud10b = clouds9["line2d"]
    kernels.reset_launch_counts()
    res10b = ransac_adaptive(line2d_est, cloud10b, gen(), device=DEVICE)
    torch.cuda.synchronize()
    counts10b = kernels.launch_counts()
    print(f"    ransac_adaptive line2d n={N_MAIN}: launches {counts10b}")
    check_family(res10b, "line2d", "adaptive line2d", N_MAIN)
    check(counts10b["fused_sweep_line2d"] > 0, "ransac_adaptive did not launch fused_sweep_line2d")
    add_launches(counts10b)
    wall10b = timer.wall_ms(lambda: ransac_adaptive(line2d_est, cloud10b, gen(), device=DEVICE),
                            reps=WALL_REPS)
    print(f"    wall {wall10b:.3f} ms median of {WALL_REPS} [{smi}]")

    # 11. plane_vote through its entry point --------------------------------
    plane_vote_err, plane_vote_times = 0, {}
    for b11, n11, d11 in PLANE_VOTE_SHAPES:
        family = "plane3d" if d11 == 3 else "line2d"
        pts11 = torch.as_tensor(family_cloud(rng, family, n11), device=dev)
        axis = FAMILIES[family][2]
        offset = float(np.dot(axis, FAMILIES[family][1]))
        near_n = axis + rng.normal(0, 0.02, (b11 // 2, d11))
        near_n /= np.linalg.norm(near_n, axis=1, keepdims=True)
        wide_n = rng.normal(size=(b11 - b11 // 2, d11))
        wide_n /= np.linalg.norm(wide_n, axis=1, keepdims=True)
        params11 = torch.as_tensor(np.concatenate([
            np.concatenate([near_n, offset + rng.normal(0, 1.0, (b11 // 2, 1))], 1),
            np.concatenate([wide_n, rng.uniform(-20, 20, (b11 - b11 // 2, 1))], 1),
        ]).astype(np.float32), device=dev)
        pt11, valid11, _ = vote.pack_points(pts11)
        dsq = DELTA * DELTA
        kernels.reset_launch_counts()
        got11 = vote.plane_vote_counts(params11, pt11, valid11, dsq)
        torch.cuda.synchronize()
        counts11 = kernels.launch_counts()
        check(counts11["plane_vote"] > 0, "plane_vote_counts did not launch plane_vote")
        add_launches(counts11)
        plain11 = vote.plane_vote_counts_plain(params11, pt11, valid11, dsq)
        err11 = int((got11.long() - plain11.long()).abs().max())
        sub = torch.arange(0, b11, b11 // 4096, device=dev)
        h64 = params11[sub].double()
        s64 = h64[:, :d11] @ pts11.double().T - h64[:, d11:]
        flips = (got11[sub].long() - (s64 * s64 < dsq).sum(1)).abs()
        print(f"[11] plane_vote B={b11} n={n11} d={d11}: launches {counts11['plane_vote']}; "
              f"max|kernel-plain|={err11} (must be 0); vs f64 agree on {len(sub)}: "
              f"max|d|={int(flips.max())} (<=5), total flips={int(flips.sum())}; "
              f"mean count={float(got11.float().mean()):.1f}")
        check(err11 == 0, "plane_vote disagrees with its plain version")
        check(int(flips.max()) <= 5, "plane_vote disagrees with the f64 oracle")
        plane_vote_err = max(plane_vote_err, err11)
        big = b11 * n11 > 1 << 30
        ms11 = timer.ms(lambda: vote.plane_vote_counts_cuda(params11, pt11, valid11, dsq),
                        reps=10 if big else 20)
        plain_ms11 = timer.ms(lambda: vote.plane_vote_counts_plain(params11, pt11, valid11, dsq),
                              reps=2 if big else 5, warmup=1)
        lib_ms11 = timer.ms(lambda: library_plane_vote(torch, params11, pt11, valid11, dsq),
                            reps=2 if big else 5, warmup=1)
        lib11 = library_plane_vote(torch, params11, pt11, valid11, dsq)
        bound11, by11 = bound(b11 * n11 * PLANE_VOTE_OPS_PER_CELL[d11],
                              (params11.numel() + (d11 + 1) * pt11.shape[1] + b11) * 4, rates)
        plane_vote_times[(b11, n11, d11)] = (ms11, plain_ms11, lib_ms11, bound11, by11)
        print(f"    library yardstick max|d| vs kernel = {int((lib11 - got11.long()).abs().max())}")
        print(f"    ms: kernel {ms11:.4f}, plain {plain_ms11:.4f}, library {lib_ms11:.4f}, "
              f"bound {bound11:.4f} ({by11}) [{smi}]")
        print(f"    plane_vote at {b11} (the d = 3 kernel's shape): "
              f"{launch_shape(kernels.PLANE_VOTE, b11)}")
        if big:
            mhz11, watts11 = clocks_during(
                torch, lambda: vote.plane_vote_counts_cuda(params11, pt11, valid11, dsq))
            print(f"    while it runs: SM clock {mhz11:.0f} MHz, {watts11:.0f} W")

    # 12. the rigid sweeps vs their plain versions -----------------------------
    from lsqrrecipes_tpu_torch import geometry, interop
    from lsqrrecipes_tpu_torch.tree import tree_map

    def rigid_est(family):
        make = get(RIGID[family][0])
        if family == "ray3d":
            return make(DELTA, RAY_MIN_ANGLE)
        return make(DELTA, 6) if family == "dense_linear6" else make(DELTA)

    def check_rigid(result, family, label, n):
        params = result.params.double().cpu().numpy()
        errors = rigid_errors(family, params)
        print(f"    {label}: valid={bool(result.valid)} params={params.round(4).tolist()} "
              f"inliers={int(result.best_count)} fraction={float(result.inlier_fraction):.4f} "
              f"errors={[f'{e:.2e}' for e in errors]} (limits {RIGID_LIMITS[family]})")
        check(bool(result.valid), f"{label}: result not valid")
        check(bool(np.isfinite(params).all()), f"{label}: non-finite params")
        check(tuple(result.consensus.shape) == (n,), f"{label}: consensus shape")
        check(all(e < lim for e, lim in zip(errors, RIGID_LIMITS[family])),
              f"{label}: ground truth not recovered: {errors}")

    for family in RIGID:
        est_f = rigid_est(family)
        delta_f = getattr(est_f, "fused_delta", DELTA)
        family_err[family] = 0
        for n_case, total_groups, gps, subsample in SWEEP_CASES:
            n_case = RIGID_CASE_SIZES.get(family, {}).get(n_case, n_case)
            subsample = subsample if subsample < n_case else n_case // 2
            data = interop.data_to_torch(rigid_data(rng, family, n_case, geometry), device=dev)
            g12 = torch.Generator(device=dev).manual_seed(args.seed + n_case + gps)
            vote_perm = torch.randperm(n_case, generator=g12, device=dev)
            coords, p, n_fit, vote_cols = fs.sweep_inputs(
                family, data, g12, subsample, vote_perm=vote_perm
            )
            num_groups = -(-total_groups // gps) * gps
            voters = tree_map(lambda x: x[vote_perm][:vote_cols], data) if subsample else data
            family_err[family] = max(family_err[family], compare_sweep(
                fs, family, est_f, coords, p, n_fit, num_groups, vote_cols, voters,
                f"[12] fused_sweep_{family} n={n_case} groups={total_groups} gps={gps} "
                f"subsample={subsample}", delta_f, exact=True))

    # 13. main path per rigid family: ransac_fused_sweep, one launch ---------
    rigid_data13 = {}
    for family, (_, n13, groups13, (per_cell, per_hyp)) in RIGID.items():
        est_f = rigid_est(family)
        delta_f = getattr(est_f, "fused_delta", DELTA)
        name_f = f"fused_sweep_{family}"
        data13 = rigid_data13[family] = rigid_data(rng, family, n13, geometry)
        kernels.reset_launch_counts()
        res13 = ransac_fused_sweep(est_f, data13, gen(), num_hypotheses=groups13 * n13,
                                   device=DEVICE)
        torch.cuda.synchronize()
        counts13 = kernels.launch_counts()
        hyp13 = groups13 * fs.fit_size(n13, fs._FAMILIES[family][0])
        print(f"[13] ransac_fused_sweep {family} n={n13} groups={groups13} "
              f"hypotheses={hyp13}: launches {counts13}")
        check_rigid(res13, family, family, n13)
        check(counts13[name_f] > 0, f"main path did not launch {name_f}")
        add_launches(counts13)

        def run13(est_f=est_f, data13=data13, groups13=groups13, n13=n13):
            return ransac_fused_sweep(est_f, data13, gen(), num_hypotheses=groups13 * n13,
                                      device=DEVICE)

        wall13 = timer.wall_ms(run13, reps=WALL_REPS)
        print(f"    wall {wall13:.3f} ms median of {WALL_REPS}, {hyp13 / wall13 * 1e3:.4g} "
              f"hypotheses/s [{smi}]")
        breakdown(torch, run13, family)

        data13_t = interop.data_to_torch(data13, device=dev)
        coords13, p13, nfit13, cols13 = fs.sweep_inputs(family, data13_t, gen())
        ms13 = timer.ms(lambda: fs.sweep_cuda(family, coords13, p13, nfit13, groups13, cols13,
                                              delta_f), reps=20)
        plain_ms13 = timer.ms(lambda: fs.sweep_plain(family, coords13, p13, nfit13, groups13,
                                                     cols13, delta_f), *plain_reps(family))
        # The least work: every evaluated hypothesis fitted once and voted on
        # the n observations (not on the padding columns).
        bound13, by13 = bound(hyp13 * (n13 * per_cell + per_hyp),
                              (coords13.numel() + p13.numel() + fs._FAMILIES[family][2] + 1) * 4,
                              rates)
        family_times[family] = (ms13, plain_ms13, bound13, by13)
        print(f"    kernel ms: {name_f} {ms13:.4f}, plain {plain_ms13:.4f}, "
              f"bound {bound13:.4f} ({by13}) [{smi}]")
        # The same launch on one column: the fit, the staging and the publishing.
        one13 = timer.ms(lambda: fs.sweep_cuda(family, coords13, p13, nfit13, groups13, 1,
                                               delta_f), reps=20)
        print(f"    {name_f} at {hyp13}: {launch_shape(kernels.FUSED_SWEEPS[family], hyp13)}; "
              f"on 1 column {one13:.4f} ms")
        family_err[family] = max(family_err[family], compare_sweep(
            fs, family, est_f, coords13, p13, nfit13, groups13, cols13, data13_t,
            f"    {name_f} at this shape ({groups13} groups)", delta_f, exact=True))

    # 14. gathered pivot calibration (tree gather, f64 9x6 SVD, no kernel) ----
    pivot_est = rigid_est("pivot")
    data14 = rigid_data(rng, "pivot", RIGID["pivot"][1], geometry)
    kernels.reset_launch_counts()
    res14 = ransac(pivot_est, data14, gen(), num_hypotheses=H_GATHER, device=DEVICE)
    torch.cuda.synchronize()
    counts14 = kernels.launch_counts()
    print(f"[14] ransac pivot n={RIGID['pivot'][1]} hypotheses={H_GATHER}: launches {counts14}")
    check_rigid(res14, "pivot", "gather pivot", RIGID["pivot"][1])
    check(sum(counts14.values()) == 0, "the pivot gather path launched a kernel")

    def run14():
        return ransac(pivot_est, data14, gen(), num_hypotheses=H_GATHER, device=DEVICE)

    wall14 = timer.wall_ms(run14, reps=WALL_REPS)
    print(f"    wall {wall14:.3f} ms median of {WALL_REPS}, {H_GATHER / wall14 * 1e3:.4g} "
          f"hypotheses/s [{smi}]")
    breakdown(torch, run14, "gather pivot")

    # 15. the ultrasound sweeps vs their plain versions ------------------------
    t_us = time.perf_counter()

    def check_us(result, family, label, n):
        params = result.params.double().cpu().numpy()
        errors = us_errors(family, params)
        print(f"    {label}: valid={bool(result.valid)} params={params[:11].round(4).tolist()} "
              f"inliers={int(result.best_count)} fraction={float(result.inlier_fraction):.4f} "
              f"errors={[f'{e:.2e}' for e in errors]} (limits {US_LIMITS})")
        check(bool(result.valid), f"{label}: result not valid")
        check(bool(np.isfinite(params).all()), f"{label}: non-finite params")
        check(tuple(result.consensus.shape) == (n,), f"{label}: consensus shape")
        check(all(e < lim for e, lim in zip(errors, US_LIMITS)),
              f"{label}: ground truth not recovered: {errors}")

    us_cases = [case + (False,) for case in SWEEP_CASES] + [(200, 6, 1, 0, True)]
    for family, (reg_name, _, _, _) in US.items():
        est_f = get(reg_name)(US_DELTA)
        family_err[family] = 0
        for n_case, total_groups, gps, subsample, exact in us_cases:
            data = interop.data_to_torch(us_data(rng, family, n_case, geometry, exact), device=dev)
            g15 = torch.Generator(device=dev).manual_seed(args.seed + n_case + gps)
            vote_perm = torch.randperm(n_case, generator=g15, device=dev)
            coords, p, n_fit, vote_cols = fs.sweep_inputs(
                family, data, g15, subsample, vote_perm=vote_perm
            )
            num_groups = -(-total_groups // gps) * gps
            voters = tree_map(lambda x: x[vote_perm][:vote_cols], data) if subsample else data
            family_err[family] = max(family_err[family], compare_sweep(
                fs, family, est_f, coords, p, n_fit, num_groups, vote_cols, voters,
                f"[15] fused_sweep_{family} n={n_case} groups={total_groups} gps={gps} "
                f"subsample={subsample}" + (" padding columns, exact data" if exact else ""),
                US_DELTA, exact=True))
            if exact:   # the planted calibration holds every observation, no more
                count = int(fs.sweep_cuda(family, coords, p, n_fit, num_groups, vote_cols,
                                          US_DELTA)[0])
                check(n_case - 1 <= count <= n_case,
                      f"[15] {family}: {count} votes on {n_case} exact observations")
        # The fit and vote kernels once per chunk, the best key across chunks.
        rng15 = np.random.default_rng([args.seed, 15])     # rng's stream as before
        data = interop.data_to_torch(us_data(rng15, family, 1024, geometry), device=dev)
        coords, p, n_fit, vote_cols = fs.sweep_inputs(
            family, data, torch.Generator(device=dev).manual_seed(args.seed + 15))
        chunk_before, fs.US_CHUNK = fs.US_CHUNK, US_CHUNK_SMALL
        try:
            family_err[family] = max(family_err[family], compare_sweep(
                fs, family, est_f, coords, p, n_fit, 64, vote_cols, data,
                f"[15] fused_sweep_{family} n=1024 groups=64 in chunks of {US_CHUNK_SMALL}",
                US_DELTA, exact=True))
        finally:
            fs.US_CHUNK = chunk_before

    # 16. main path per ultrasound family: ransac_fused_sweep, one launch ----
    from lsqrrecipes_tpu_torch.estimators import us_calibration
    from lsqrrecipes_tpu_torch.linalg import levenberg_marquardt

    us_data16, consensus16 = {}, {}
    for family, (reg_name, n16, groups16, per_cell) in US.items():
        est_f = get(reg_name)(US_DELTA)
        name_f = f"fused_sweep_{family}"
        data16 = us_data16[family] = us_data(rng, family, n16, geometry)
        kernels.reset_launch_counts()
        res16 = ransac_fused_sweep(est_f, data16, gen(), num_hypotheses=groups16 * n16,
                                   device=DEVICE)
        torch.cuda.synchronize()
        counts16 = kernels.launch_counts()
        hyp16 = groups16 * fs.fit_size(n16, fs._FAMILIES[family][0])
        print(f"[16] ransac_fused_sweep {family} n={n16} groups={groups16} "
              f"hypotheses={hyp16} ({est_f.ls_type}): launches {counts16}")
        check_us(res16, family, family, n16)
        check(counts16[name_f] > 0, f"main path did not launch {name_f}")
        consensus16[family] = res16.consensus
        add_launches(counts16)

        def run16(est_f=est_f, data16=data16, groups16=groups16, n16=n16):
            return ransac_fused_sweep(est_f, data16, gen(), num_hypotheses=groups16 * n16,
                                      device=DEVICE)

        wall16 = timer.wall_ms(run16, reps=WALL_REPS)
        print(f"    wall {wall16:.3f} ms median of {WALL_REPS}, {hyp16 / wall16 * 1e3:.4g} "
              f"hypotheses/s [{smi}]")
        breakdown(torch, run16, family)

        # The ITERATIVE refit on the winner's consensus: its LM iterations
        # and its time alone.
        data16_t = interop.data_to_torch(data16, device=dev)
        mask16 = res16.consensus
        x0, valid0 = est_f._analytic(data16_t, mask16)
        n_min = 11 if family == "crosswire" else 8
        residual, jacobian = ((us_calibration._crosswire_residual,
                               us_calibration._crosswire_jacobian) if family == "crosswire" else
                              (us_calibration._pointer_residual, us_calibration._pointer_jacobian))
        lm16 = levenberg_marquardt(residual, jacobian, x0[:n_min], data16_t,
                                   mask=mask16.repeat_interleave(3), config=est_f.lm_config)
        refit_ms = timer.wall_ms(lambda: est_f.lsq_fit(data16_t, mask16), reps=WALL_REPS)
        print(f"    ITERATIVE refit on {int(mask16.sum())} inliers: {int(lm16.iterations)} LM "
              f"iterations, converged={bool(lm16.converged)}, analytic start valid="
              f"{bool(valid0)}; lsq_fit wall {refit_ms:.3f} ms median of {WALL_REPS} [{smi}]")
        check(bool(lm16.converged) and bool(valid0), f"{family}: the LM refit did not converge")
        if family == "crosswire":
            crosswire_residual = compare_crosswire_residual(torch, data16_t, mask16, x0[:n_min],
                                                            timer, rates, smi)

        coords16, p16, nfit16, cols16 = fs.sweep_inputs(family, data16_t, gen())
        ms16 = timer.ms(lambda: fs.sweep_cuda(family, coords16, p16, nfit16, groups16, cols16,
                                              US_DELTA), reps=20)
        plain_ms16 = timer.ms(lambda: fs.sweep_plain(family, coords16, p16, nfit16, groups16,
                                                     cols16, US_DELTA), *plain_reps(family))
        # The least work: every evaluated hypothesis fitted once and voted on
        # the n observations.
        bound16, by16 = bound(hyp16 * (n16 * per_cell + us_fit_ops(family)),
                              (coords16.numel() + p16.numel() + fs._FAMILIES[family][2] + 1) * 4,
                              rates)
        family_times[family] = (ms16, plain_ms16, bound16, by16)
        print(f"    kernel ms: {name_f} {ms16:.4f}, plain {plain_ms16:.4f}, "
              f"bound {bound16:.4f} ({by16}; {us_fit_ops(family)} fit operations per "
              f"hypothesis) [{smi}]")
        fit_k, vote_k = f"{family}_fit_kernel", f"{family}_vote_kernel"
        parts = device_ms(torch, lambda: fs.sweep_cuda(family, coords16, p16, nfit16, groups16,
                                                       cols16, US_DELTA), (fit_k, vote_k))
        kernel16 = kernels.FUSED_SWEEPS[family]
        print(f"    {name_f} device ms by kernel (profiler, mean per launch): fit "
              f"{parts[fit_k]:.4f}, vote {parts[vote_k]:.4f}; "
              f"vote {launch_shape(kernel16, hyp16)}; "
              f"fit {launch_shape(kernel16, hyp16, 'fit_shape')} [{smi}]")
        check(parts[fit_k] > 0 and parts[vote_k] > 0,
              f"the profiler saw no {family} fit or vote kernel")
        family_err[family] = max(family_err[family], compare_sweep(
            fs, family, est_f, coords16, p16, nfit16, groups16, cols16, data16_t,
            f"    {name_f} at this shape ({groups16} groups)", US_DELTA, exact=True))

    # 17. structured sweeps through us_fast and gathered crosswire (no sweep kernel)
    def drive17(label, fn, family, n):
        kernels.reset_launch_counts()
        res = fn()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        print(f"[17] {label}: launches {counts}")
        check_us(res, family, label, n)
        # No sweep kernel; the ITERATIVE crosswire refit launches its residual kernel.
        refit = counts.pop("us_crosswire_residual")
        check(sum(counts.values()) == 0, f"{label} launched a sweep kernel")
        check((refit > 0) == (family == "crosswire"), f"{label}: {refit} residual launches")
        wall = timer.wall_ms(fn, reps=WALL_REPS)
        hyps = H_US_GATHER if "gather" in label else -(-H_US_STRUCT // n) * n
        print(f"    wall {wall:.3f} ms median of {WALL_REPS}, {hyps / wall * 1e3:.4g} "
              f"hypotheses/s [{smi}]")
        breakdown(torch, fn, label)

    for family, (reg_name, n17, _, _) in US.items():
        est_f = get(reg_name)(US_DELTA)
        drive17(f"ransac_structured {family} n={n17} hypotheses={H_US_STRUCT}",
                lambda est_f=est_f, family=family: ransac_structured(
                    est_f, us_data16[family], gen(), num_hypotheses=H_US_STRUCT, device=DEVICE),
                family, n17)
    cross_est = get(US["crosswire"][0])(US_DELTA)
    drive17(f"ransac gather crosswire n={US['crosswire'][1]} hypotheses={H_US_GATHER}",
            lambda: ransac(cross_est, us_data16["crosswire"], gen(), num_hypotheses=H_US_GATHER,
                           device=DEVICE),
            "crosswire", US["crosswire"][1])
    us_s = time.perf_counter() - t_us
    print(f"    phases 15-17 took {us_s:.1f} s (budget {US_PHASES_BUDGET_S:.0f} s)")
    check(us_s < US_PHASES_BUDGET_S, "phases 15-17 overran their budget")

    # 18. sphere_lm at the bench's LM shape ------------------------------------
    from lsqrrecipes_tpu_torch.linalg import LMConfig
    from lsqrrecipes_tpu_torch.ops import planar_points, sphere_lm
    from lsqrrecipes_tpu_torch.ops import sphere_ransac as sr
    from lsqrrecipes_tpu_torch.ransac import ransac_batched

    t_sphere = time.perf_counter()
    lm_pts, lm_x0 = (torch.as_tensor(a, device=dev) for a in lm_problems(rng, LM_B, LM_M))

    def run18():
        return sphere_lm.sphere_lm_batch(lm_pts, lm_x0, LM_ITERS, gtol=LM_GTOL)

    kernels.reset_launch_counts()
    lm_x, lm_cost, lm_it, lm_conv = run18()
    torch.cuda.synchronize()
    counts18 = kernels.launch_counts()
    check(counts18["sphere_lm"] > 0, "sphere_lm_batch did not launch sphere_lm")
    add_launches(counts18)
    plain_x, _, plain_it, plain_conv = sphere_lm.sphere_lm_batch_plain(
        lm_pts, lm_x0, LM_ITERS, gtol=LM_GTOL)
    ref18 = sphere_lm.sphere_lm_batch_f64(lm_pts, lm_x0, LMConfig(**LM_F64))
    lm_err = float((lm_x - plain_x).abs().max())
    lm_f64_err = float((lm_x.double() - ref18.x).abs().max())
    print(f"[18] sphere_lm B={LM_B} m={LM_M} max_iters={LM_ITERS}: launches "
          f"{counts18['sphere_lm']}; iterations mean {float(lm_it.float().mean()):.2f} max "
          f"{int(lm_it.max())} (plain {float(plain_it.float().mean()):.2f}); converged "
          f"{float(lm_conv.float().mean()):.4f}; max|kernel-plain|={lm_err:.3g} (<1e-3), "
          f"max|kernel-f64 LM|={lm_f64_err:.3g} (<5e-3)")
    check(bool(lm_conv.all()) and bool(plain_conv.all()), "sphere_lm: a problem did not converge")
    check(lm_err < 1e-3, "sphere_lm disagrees with its plain version")
    check(lm_f64_err < 5e-3, "sphere_lm disagrees with the float64 LM")
    lm_wall = timer.wall_ms(run18, reps=WALL_REPS)
    lm_ms = timer.ms(lambda: sphere_lm.sphere_lm_batch_cuda(lm_pts, lm_x0, LM_ITERS, gtol=LM_GTOL),
                     reps=10)
    lm_plain_ms = timer.ms(lambda: sphere_lm.sphere_lm_batch_plain(lm_pts, lm_x0, LM_ITERS,
                                                                   gtol=LM_GTOL),
                           reps=2, warmup=1)
    lm_bound, lm_by = bound(LM_M * LM_OPS_PER_OBS_EVAL * (int(lm_it.sum()) + LM_B),
                            (lm_pts.numel() + lm_x0.numel() + 8 * LM_B) * 4, rates)
    print(f"    wall {lm_wall:.3f} ms median of {WALL_REPS}, "
          f"{LM_B * LM_ITERS / lm_wall * 1e3:.4g} LM iterations/s (B x max_iters / wall); "
          f"kernel ms {lm_ms:.4f}, plain {lm_plain_ms:.4f}, bound {lm_bound:.4f} ({lm_by}) "
          f"[{smi}]")
    slowest = int(lm_it.max())
    print(f"    slowest problem {slowest} iterations ({lm_ms / (slowest + 1) * 1e3:.2f} us per "
          f"evaluation of it); {launch_shape(kernels.SPHERE_LM, LM_B)}")

    # 19. sphere_mega through the per-step sweep -------------------------------
    geo_est = SphereEstimator(DELTA)        # GEOMETRIC, the default
    pt19, valid19, _ = vote.pack_points(pts5)

    def run19():
        return sr.fast_sphere_ransac_sweep(pts5, pt19, valid19, gen(), SCAN_GROUPS, SCAN_STEPS,
                                           DELTA)

    kernels.reset_launch_counts()
    count19, params19 = run19()
    torch.cuda.synchronize()
    counts19 = kernels.launch_counts()
    hyp19 = SCAN_GROUPS * SCAN_STEPS * N_MAIN
    check(counts19["sphere_mega"] == SCAN_STEPS, "the per-step sweep did not launch once per step")
    add_launches(counts19)
    mask19 = est.agree(params19.double(), pts5.double())
    refit19, valid_refit19 = geo_est.lsq_fit(pts5.double(), mask19)
    min_err = float((params19.double().cpu() - torch.tensor([*TRUE_CENTER, TRUE_RADIUS])).abs().max())
    print(f"[19] fast_sphere_ransac_sweep n={N_MAIN} groups={SCAN_GROUPS} steps={SCAN_STEPS} "
          f"({hyp19} hypotheses): launches {counts19['sphere_mega']}; best count {int(count19)}, "
          f"minimal winner {params19.cpu().numpy().round(4).tolist()} (max error {min_err:.3g})")
    refit_err = float((refit19.cpu() - torch.tensor([*TRUE_CENTER, TRUE_RADIUS])).abs().max())
    print(f"    GEOMETRIC refit of its {int(mask19.sum())} inliers: valid={bool(valid_refit19)} "
          f"{refit19.cpu().numpy().round(4).tolist()} (max error {refit_err:.3g})")
    check(bool(valid_refit19) and refit_err < 0.1, "the scan sweep's refit misses the sphere")
    check(min_err < 0.5, "the per-step sweep's winner is far from the sphere")
    wall19 = timer.wall_ms(run19, reps=WALL_REPS)
    print(f"    wall {wall19:.3f} ms median of {WALL_REPS}, {hyp19 / wall19 * 1e3:.4g} "
          f"hypotheses/s [{smi}]")
    breakdown(torch, run19, "scan sweep")

    coords19 = sr._slot_planes(pts5, gen(), N_MAIN)
    shifts19 = torch.as_tensor(sr.mega_group_shifts(SCAN_GROUPS, N_MAIN), dtype=torch.int32,
                               device=dev)
    kc19, kp19 = sr.megakernel_call_cuda(shifts19, coords19, pt19, valid19, DELTA)
    pc19, pp19 = sr.megakernel_call_plain(shifts19, coords19, pt19, valid19, DELTA)
    mega_err = max(int((kc19 - pc19).abs().max()), float((kp19 - pp19).abs().max()))
    print(f"    sphere_mega vs plain at {SCAN_GROUPS} groups x {N_MAIN}: counts equal "
          f"{bool(torch.equal(kc19, pc19))}, params_t bit-equal {bool(torch.equal(kp19, pp19))}")
    check(torch.equal(kc19, pc19) and torch.equal(kp19, pp19),
          "sphere_mega disagrees with its plain version")
    # The same step's counts against f64 minimal_fit + agree, which shares no
    # arithmetic with the kernel, on every 32nd hypothesis.  Where the f64
    # rank gate rejects a fit that f32 accepts, f64 counts 0; on the
    # hypotheses both accept only border points may flip.
    hyp_step = SCAN_GROUPS * N_MAIN
    sub19 = torch.arange(0, hyp_step, 32, device=dev)
    samples19 = sr.reference_mega_samples(pts5, None, SCAN_GROUPS, coords2=coords19)[sub19]
    p64_19, v64_19 = est.minimal_fit(samples19.double())
    c64_19 = torch.where(v64_19, est.agree(p64_19, pts5.double()).sum(-1), 0)
    both19 = v64_19 & (kp19[4, sub19] == 0)
    d19 = (kc19[sub19].long() - c64_19.long()).abs()
    print(f"    sphere_mega vs f64 minimal_fit + agree on {len(sub19)} hypotheses of the step: "
          f"on the {int(both19.sum())} both fit, max|d|={max_or(d19[both19], 0)} (<=2), "
          f"{int((d19[both19] > 0).sum())} differ; {int((~v64_19).sum())} rejected by f64, "
          f"{int((kp19[4, sub19] != 0).sum())} degenerate in the kernel; max "
          f"{int(kc19[sub19].max())} vs {int(c64_19.max())}")
    check(max_or(d19[both19], 0) <= 2 and int(kc19[sub19].max()) == int(c64_19.max()),
          "sphere_mega disagrees with f64 minimal_fit + agree")
    mega_ms =timer.ms(lambda: sr._mega_launch(shifts19, coords19, pt19, valid19, DELTA), reps=20)
    mega_plain_ms = timer.ms(lambda: sr.megakernel_call_plain(shifts19, coords19, pt19, valid19,
                                                              DELTA), reps=2, warmup=1)
    mega_bound, mega_by = bound(
        hyp_step * (N_MAIN * MEGA_OPS_PER_CELL + SWEEP_OPS_PER_HYP),
        (coords19.numel() + 4 * pt19.shape[1] + shifts19.numel() + 9 * hyp_step) * 4, rates)
    print(f"    kernel ms: sphere_mega {mega_ms:.4f}, plain {mega_plain_ms:.4f}, bound "
          f"{mega_bound:.4f} ({mega_by}); {launch_shape(kernels.SPHERE_MEGA, hyp_step)} [{smi}]")

    n_small, g_small = MEGA_SMALL
    pts_small = torch.as_tensor(bench_cloud(rng, n_small), device=dev)
    pt_small, valid_small, _ = vote.pack_points(pts_small)
    coords_small = sr._slot_planes(pts_small, gen(), n_small)
    c_small, p_small = sr.fast_sphere_ransac_step(pts_small, pt_small, valid_small, None,
                                                  g_small, DELTA, coords2=coords_small)
    samples = sr.reference_mega_samples(pts_small, None, g_small, coords2=coords_small)
    p_ref, v_ref = est.minimal_fit(samples)
    agree_best = int(torch.where(v_ref, est.agree(p_ref, pts_small).sum(-1), 0).max())
    regain = int(est.agree(p_small, pts_small).sum())
    print(f"    step n={n_small} groups={g_small}: best {int(c_small)}, minimal_fit + agree best "
          f"{agree_best}, the winner re-achieves {regain}")
    check(abs(int(c_small) - agree_best) <= 1 and abs(regain - int(c_small)) <= 1,
          "the per-step sweep disagrees with minimal_fit + agree")
    mega_err = max(mega_err, abs(int(c_small) - agree_best))
    far19 = torch.as_tensor(far_cloud(args.seed, 19, N_MAIN), device=dev)
    pt_far19, valid_far19, _ = vote.pack_points(far19)
    coords_far19 = sr._slot_planes(far19, torch.Generator(device=dev).manual_seed(args.seed + 19),
                                   N_MAIN)
    kc_far19, kp_far19 = sr.megakernel_call_cuda(shifts19, coords_far19, pt_far19, valid_far19,
                                                 DELTA)
    pc_far19, pp_far19 = sr.megakernel_call_plain(shifts19, coords_far19, pt_far19, valid_far19,
                                                  DELTA)
    far_max19 = f64_best(est, sr.reference_mega_samples(far19, None, SCAN_GROUPS,
                                                        coords2=coords_far19), far19)
    print(f"    step on the cloud {FAR_OFFSET:g} from the origin: counts equal "
          f"{bool(torch.equal(kc_far19, pc_far19))}, params_t bit-equal "
          f"{bool(torch.equal(kp_far19, pp_far19))}; best {int(kc_far19.max())}, float64 "
          f"minimal_fit + agree maximum {far_max19}")
    check(torch.equal(kc_far19, pc_far19) and torch.equal(kp_far19, pp_far19),
          "sphere_mega disagrees with its plain version far from the origin")
    check(abs(int(kc_far19.max()) - far_max19) <= 1, "[19] sphere_mega far from the origin: the "
          "best count is not within 1 of the float64 maximum")

    # 20. sphere_planar_vote on a sampled plane --------------------------------
    def run20():
        sxyz = sr.planar_sphere_samples(gen(), pts5, SCAN_GROUPS)
        return sxyz, sr.sphere_fit_and_vote_planar(sxyz, pt19, valid19, DELTA)

    kernels.reset_launch_counts()
    sxyz20, (kc20, kp20) = run20()
    torch.cuda.synchronize()
    counts20 = kernels.launch_counts()
    check(counts20["sphere_planar_vote"] > 0,
          "sphere_fit_and_vote_planar did not launch sphere_planar_vote")
    add_launches(counts20)
    pc20, pp20 = sr.sphere_fit_and_vote_planar_plain(sxyz20, pt19, valid19, DELTA)
    samples20 = torch.stack([sxyz20[0:4].T, sxyz20[4:8].T, sxyz20[8:12].T], dim=-1)
    p_ref20, v_ref20 = est.minimal_fit(samples20)
    cref20 = torch.where(v_ref20, est.vote_counts(p_ref20, pts5), 0)
    d20 = (kc20.long() - cref20.long()).abs()
    planar_err = max(int((kc20 - pc20).abs().max()), float((kp20 - pp20).abs().max()))
    hyp20 = kc20.numel()
    # Border flips against an f64 literal agree on the kernel's own fits.
    sub = torch.arange(0, hyp20, max(1, hyp20 // 4096), device=dev)
    c64 = kp20[:4, sub].T.double()
    dist = torch.cdist(c64[:, :3], pts5.double(), compute_mode="donot_use_mm_for_euclid_dist")
    oracle = torch.where(kp20[4, sub] == 0, ((dist - c64[:, 3:4]).abs() < DELTA).sum(1), 0)
    flips20 = (kc20[sub].long() - oracle).abs()
    print(f"[20] sphere_fit_and_vote_planar B={hyp20} n={N_MAIN}: launches "
          f"{counts20['sphere_planar_vote']}; counts equal to plain {bool(torch.equal(kc20, pc20))}, "
          f"params_t bit-equal {bool(torch.equal(kp20, pp20))}; vs minimal_fit + vote_counts "
          f"max|d|={int(d20.max())} (<=2) on {int((d20 > 0).sum())} hypotheses, max "
          f"{int(kc20.max())} vs {int(cref20.max())}; vs f64 agree on {len(sub)}: "
          f"max|d|={int(flips20.max())} (<=5)")
    check(torch.equal(kc20, pc20) and torch.equal(kp20, pp20),
          "sphere_planar_vote disagrees with its plain version")
    # Two f32 evaluations of one band, each flipping border points: at
    # 131,072 hypotheses a hypothesis may lose two to the other's rounding.
    check(int(d20.max()) <= 2 and int(kc20.max()) == int(cref20.max()),
          "sphere_planar_vote disagrees with minimal_fit + vote_counts")
    check(int(flips20.max()) <= 5, "sphere_planar_vote disagrees with the f64 oracle")
    far20 = torch.as_tensor(far_cloud(args.seed, 20, N_MAIN), device=dev)
    pt_far20, valid_far20, _ = vote.pack_points(far20)
    sxyz_far20 = sr.planar_sphere_samples(
        torch.Generator(device=dev).manual_seed(args.seed + 20), far20, SCAN_GROUPS)
    kc_far20, kp_far20 = sr.sphere_fit_and_vote_planar_cuda(sxyz_far20, pt_far20, valid_far20,
                                                            DELTA)
    pc_far20, pp_far20 = sr.sphere_fit_and_vote_planar_plain(sxyz_far20, pt_far20, valid_far20,
                                                             DELTA)
    far_max20 = f64_best(est, torch.stack([sxyz_far20[0:4].T, sxyz_far20[4:8].T,
                                           sxyz_far20[8:12].T], dim=-1), far20)
    print(f"    the cloud {FAR_OFFSET:g} from the origin: counts equal "
          f"{bool(torch.equal(kc_far20, pc_far20))}, params_t bit-equal "
          f"{bool(torch.equal(kp_far20, pp_far20))}; best {int(kc_far20.max())}, float64 "
          f"minimal_fit + agree maximum {far_max20}")
    check(torch.equal(kc_far20, pc_far20) and torch.equal(kp_far20, pp_far20),
          "sphere_planar_vote disagrees with its plain version far from the origin")
    check(abs(int(kc_far20.max()) - far_max20) <= 1, "[20] sphere_planar_vote far from the "
          "origin: the best count is not within 1 of the float64 maximum")
    planar_ms = timer.ms(lambda: sr.sphere_fit_and_vote_planar_cuda(sxyz20, pt19, valid19, DELTA),
                         reps=20)
    planar_plain_ms = timer.ms(lambda: sr.sphere_fit_and_vote_planar_plain(sxyz20, pt19, valid19,
                                                                           DELTA),
                               reps=2, warmup=1)
    planar_bound, planar_by = bound(hyp20 * (N_MAIN * PLANAR_OPS[0] + PLANAR_OPS[1]),
                                    (sxyz20.numel() + 4 * pt19.shape[1] + 9 * hyp20) * 4, rates)
    print(f"    kernel ms: sphere_planar_vote {planar_ms:.4f}, plain {planar_plain_ms:.4f}, "
          f"bound {planar_bound:.4f} ({planar_by}) [{smi}]; "
          f"{launch_shape(kernels.SPHERE_PLANAR_VOTE, hyp20)}")

    # 21. drivers without a new kernel -----------------------------------------
    kernels.reset_launch_counts()
    res21 = ransac_fused_sweep(geo_est, cloud5, gen(), num_hypotheses=H_FUSED, device=DEVICE)
    torch.cuda.synchronize()
    counts21 = kernels.launch_counts()
    print(f"[21] ransac_fused_sweep GEOMETRIC n={N_MAIN} hypotheses={H_FUSED}: launches {counts21}")
    check_result(res21, "fused GEOMETRIC", N_MAIN)
    check(counts21["fused_sweep_sphere3d"] > 0, "the GEOMETRIC fused path did not launch B1")
    add_launches(counts21)
    lm21 = levenberg_marquardt(sphere_est._sphere_residual, sphere_est._sphere_jacobian,
                               SphereEstimator(DELTA, 3, ALGEBRAIC).lsq_fit(pts5, res21.consensus)[0],
                               pts5, mask=res21.consensus, config=geo_est.lm_config)
    refit21_ms = timer.wall_ms(lambda: geo_est.lsq_fit(pts5, res21.consensus), reps=WALL_REPS)
    print(f"    GEOMETRIC refit on {int(res21.consensus.sum())} inliers: {int(lm21.iterations)} LM "
          f"iterations, converged={bool(lm21.converged)}; lsq_fit wall {refit21_ms:.3f} ms median "
          f"of {WALL_REPS} [{smi}]")

    def run21():
        return ransac_fused_sweep(geo_est, cloud5, gen(), num_hypotheses=H_FUSED, device=DEVICE)

    wall21 = timer.wall_ms(run21, reps=WALL_REPS)
    print(f"    wall {wall21:.3f} ms median of {WALL_REPS}, {H_FUSED / wall21 * 1e3:.4g} "
          f"hypotheses/s [{smi}]")
    breakdown(torch, run21, "fused GEOMETRIC")

    fleet = torch.as_tensor(fleet_data(rng, FLEET_D, FLEET_N), device=dev)
    fleet_seeds = [next(seeds) for _ in range(FLEET_D)]

    def fleet_gens():
        return [torch.Generator(device=dev).manual_seed(s) for s in fleet_seeds]

    kernels.reset_launch_counts()
    res21b = ransac_batched(est, fleet, fleet_gens(), FLEET_GROUPS * FLEET_N)
    torch.cuda.synchronize()
    counts21b = kernels.launch_counts()
    check(counts21b["sphere_vote"] >= FLEET_D, "the fleet did not launch sphere_vote per dataset")
    add_launches(counts21b)
    single = [ransac_structured(est, fleet[d], g, FLEET_GROUPS * FLEET_N)
              for d, g in enumerate(fleet_gens())]
    single_counts = [int(r.best_count) for r in single]
    dparam = max(float((res21b.params[d] - single[d].params).abs().max()) for d in range(FLEET_D))
    print(f"    ransac_batched {FLEET_D} x n={FLEET_N} groups={FLEET_GROUPS}: launches "
          f"{counts21b['sphere_vote']}; counts {res21b.best_count.tolist()} per dataset "
          f"{single_counts}; max|dparam|={dparam:.2e} (<1e-5)")
    check(bool(res21b.valid.all()), "the fleet has an invalid result")
    check(res21b.best_count.tolist() == single_counts and dparam < 1e-5,
          "the fleet differs from per-dataset ransac_structured")
    check(min(single_counts) > (4 * FLEET_N) // 5 - FLEET_N // 10, "the fleet missed its spheres")
    wall21b = timer.wall_ms(lambda: ransac_batched(est, fleet, fleet_gens(), FLEET_GROUPS * FLEET_N),
                            reps=WALL_REPS)
    print(f"    wall {wall21b:.3f} ms median of {WALL_REPS} [{smi}]")

    pts21 = pts5.double()
    perm21 = torch.randperm(N_MAIN, generator=gen(), device=dev)

    def run21c(vote_mode):
        return planar_points.sphere3d_planar_sweep(pts21, None, GENERIC_GROUPS, DELTA,
                                                   vote=vote_mode, perm=perm21)

    kernels.reset_launch_counts()
    c_ds, p_ds = run21c("ds")
    c_f64, p_f64 = run21c("f64")
    torch.cuda.synchronize()
    check(sum(kernels.launch_counts().values()) == 0, "the generic engine launched a kernel")
    best21 = int(torch.argmax(c_f64))
    print(f"    sphere3d_planar_sweep f64 n={N_MAIN} groups={GENERIC_GROUPS}: ds counts equal f64 "
          f"{bool(torch.equal(c_ds, c_f64))}, best {int(c_f64[best21])} at "
          f"{p_f64[best21].cpu().numpy().round(4).tolist()}")
    check(torch.equal(c_ds, c_f64) and torch.equal(p_ds, p_f64),
          "the double-single vote differs from the f64 vote")
    hyp21c = GENERIC_GROUPS * N_MAIN
    for vote_mode in ("ds", "f64"):
        wall = timer.wall_ms(lambda vote_mode=vote_mode: run21c(vote_mode), reps=WALL_REPS)
        print(f"    {vote_mode} vote: wall {wall:.3f} ms median of {WALL_REPS}, "
              f"{hyp21c / wall * 1e3:.4g} hypotheses/s [{smi}]")
    sphere_s = time.perf_counter() - t_sphere
    print(f"    phases 18-21 took {sphere_s:.1f} s (budget {SPHERE_PHASES_BUDGET_S:.0f} s)")
    check(sphere_s < SPHERE_PHASES_BUDGET_S, "phases 18-21 overran their budget")

    # 22. the plane phantom (k = 31): B6 through ransac_structured ------------
    from lsqrrecipes_tpu_torch.ops import phantom_qr, us_fast
    from lsqrrecipes_tpu_torch.ransac import structured_samples

    t_phantom = time.perf_counter()
    ph_est = get("us_plane_phantom")(PHANTOM_DELTA)          # ITERATIVE, the default
    data22, truth22, n_out22 = phantom_data(rng, PHANTOM_N, geometry)
    data22_t = interop.data_to_torch(data22, device=dev)
    h22 = PHANTOM_GROUPS * PHANTOM_N
    chunk22 = us_fast._chunk_size(h22, PHANTOM_N, ph_est.k)
    chunks22 = -(-h22 // chunk22)

    def check_phantom(result, label):
        params = result.params.double().cpu().numpy()
        errors = phantom_errors(params, truth22)
        shoved = int(result.consensus[PHANTOM_N - n_out22:].sum())
        print(f"    {label}: valid={bool(result.valid)} params={params[:11].round(4).tolist()} "
              f"inliers={int(result.best_count)} fraction={float(result.inlier_fraction):.4f} "
              f"shoved poses in consensus={shoved} errors={[f'{e:.2e}' for e in errors]} "
              f"(limits {PHANTOM_LIMITS})")
        check(bool(result.valid), f"{label}: result not valid")
        check(bool(np.isfinite(params).all()), f"{label}: non-finite params")
        check(tuple(result.consensus.shape) == (PHANTOM_N,), f"{label}: consensus shape")
        check(shoved == 0, f"{label}: a shoved pose is in the consensus")
        check(all(e < lim for e, lim in zip(errors, PHANTOM_LIMITS)),
              f"{label}: ground truth not recovered: {errors}")

    def run22(seed=None):
        g = gen() if seed is None else torch.Generator(device=dev).manual_seed(seed)
        return ransac_structured(ph_est, data22, g, num_hypotheses=h22, device=DEVICE)

    kernels.reset_launch_counts()
    res22 = run22(args.seed + 22)
    torch.cuda.synchronize()
    counts22 = kernels.launch_counts()
    print(f"[22] ransac_structured plane phantom n={PHANTOM_N} groups={PHANTOM_GROUPS} "
          f"hypotheses={h22} ({ph_est.ls_type}; chunks of {chunk22}): launches {counts22}")
    check_phantom(res22, "structured")
    check(counts22["phantom_qr"] == chunks22, "the phantom sweep did not launch B6 once per chunk")
    check(sum(counts22.values()) == chunks22, "the phantom sweep launched another kernel")
    add_launches(counts22)
    wall22 = timer.wall_ms(run22, reps=WALL_REPS)
    print(f"    wall {wall22:.3f} ms median of {WALL_REPS}, {h22 / wall22 * 1e3:.4g} "
          f"hypotheses/s [{smi}]")
    busy22, rows22 = breakdown(torch, run22, "phantom structured", top=8)
    b6_ms22 = sum(ms for ms, _, key in rows22 if "phantom_qr" in key)
    print(f"    B6 device time {b6_ms22:.4f} ms, {b6_ms22 / busy22:.3f} of the device busy time")

    # ransac_fused_sweep has no phantom family: it runs the same structured sweep.
    kernels.reset_launch_counts()
    res22f = ransac_fused_sweep(ph_est, data22, torch.Generator(device=dev).manual_seed(
        args.seed + 22), num_hypotheses=h22, device=DEVICE)
    torch.cuda.synchronize()
    counts22f = kernels.launch_counts()
    print(f"    ransac_fused_sweep (structured fallback): launches {counts22f['phantom_qr']}; "
          f"same consensus {bool(torch.equal(res22f.consensus, res22.consensus))}")
    check(counts22f["phantom_qr"] == chunks22, "the fused fallback did not launch B6 per chunk")
    check(torch.equal(res22f.consensus, res22.consensus) and torch.equal(res22f.params, res22.params),
          "ransac_fused_sweep differs from ransac_structured on the phantom")
    add_launches(counts22f)

    # The ITERATIVE refit on the winner's consensus: its LM iterations and time.
    mask22 = res22.consensus
    x022, valid022 = ph_est._analytic(data22_t, mask22)
    lm22 = levenberg_marquardt(us_calibration._plane_phantom_residual,
                               us_calibration._plane_phantom_jacobian, x022[:11], data22_t,
                               mask=mask22, config=ph_est.lm_config)
    refit22_ms = timer.wall_ms(lambda: ph_est.lsq_fit(data22_t, mask22), reps=WALL_REPS)
    print(f"    ITERATIVE refit on {int(mask22.sum())} inliers: {int(lm22.iterations)} LM "
          f"iterations, converged={bool(lm22.converged)}, analytic start valid={bool(valid022)}; "
          f"lsq_fit wall {refit22_ms:.3f} ms median of {WALL_REPS} [{smi}]")
    check(bool(lm22.converged) and bool(valid022), "phantom: the LM refit did not converge")

    # B6 against its plain version on the sweep's own systems: the main path's
    # chunk, the whole sweep, and duplicate-row samples (one observation in
    # every slot, a rank-1 system whose inverse iteration may overflow; the
    # fit must reject each of them).
    planes22, _ = us_fast.build_sampling_planes("plane_phantom", data22_t, gen(), PHANTOM_GROUPS)
    a22 = us_fast.phantom_systems(planes22)
    bands22 = phantom_qr.pack_systems(a22)
    dup_planes22 = planes22[..., :PHANTOM_DUPLICATES].clone()
    dup_planes22[:] = dup_planes22[0:1]
    _, dup_valid22 = us_fast._plane_phantom_fit_slots(dup_planes22, ph_est.k)
    check(not bool(dup_valid22.any()), "a duplicate-row phantom sample passed the gates")
    phantom_err = 0.0
    for label, bands in (("chunk", bands22[:chunk22]), ("sweep", bands22),
                         ("duplicate rows", phantom_qr.pack_systems(
                             us_fast.phantom_systems(dup_planes22)))):
        got = phantom_qr.phantom_subspace_cuda(bands)
        plain = phantom_qr.phantom_subspace_plain(bands)
        finite = torch.isfinite(got) & torch.isfinite(plain)
        same = torch.equal(torch.isnan(got), torch.isnan(plain)) and torch.equal(
            torch.nan_to_num(got), torch.nan_to_num(plain))
        err = float((got - plain)[finite].abs().max()) if bool(finite.any()) else 0.0
        print(f"    phantom_qr vs plain, {label} (B={bands.shape[0]}): bit-equal {same} (NaN "
              f"where NaN), max|d|={err:.3g} on the finite entries, hypotheses with finite "
              f"output {float(finite.all(dim=0).all(dim=0).float().mean()):.4f}")
        check(same, f"phantom_qr disagrees with its plain version ({label})")
        phantom_err = max(phantom_err, err)
    bands_c = bands22[:chunk22].contiguous()
    pack_ms = timer.ms(lambda: phantom_qr.pack_systems(a22[..., :chunk22]), reps=20)
    phantom_ms = timer.ms(lambda: phantom_qr.phantom_subspace_cuda(bands_c), reps=20)
    phantom_all_ms = timer.ms(lambda: phantom_qr.phantom_subspace_cuda(bands22), reps=10)
    phantom_plain_ms = timer.ms(lambda: phantom_qr.phantom_subspace_plain(bands_c), reps=2,
                                warmup=1)
    systems_c = bands_c[:, :, :31].transpose(1, 2).contiguous()       # [B, 31 rows, 31 cols]
    phantom_lib_ms = timer.ms(lambda: torch.linalg.svd(systems_c), reps=3, warmup=1)
    phantom_all_plain_ms = timer.ms(lambda: phantom_qr.phantom_subspace_plain(bands22), reps=1,
                                    warmup=1)
    systems_all = bands22[:, :, :31].transpose(1, 2).contiguous()
    phantom_all_lib_ms = timer.ms(lambda: torch.linalg.svd(systems_all), reps=1, warmup=1)

    def phantom_bound(b):
        return bound(b * phantom_qr_ops(), b * (31 * 31 + 4 * 31) * 4, rates)

    phantom_bound_ms, phantom_by = phantom_bound(chunk22)
    phantom_all_bound, phantom_all_by = phantom_bound(h22)
    print(f"    kernel ms: phantom_qr {phantom_ms:.4f} at {chunk22} (pack {pack_ms:.4f}, counted in "
          f"the fit), {phantom_all_ms:.4f} at {h22}; plain {phantom_plain_ms:.4f} / "
          f"{phantom_all_plain_ms:.4f}; library (torch.linalg.svd of the f32 batch) "
          f"{phantom_lib_ms:.4f} / {phantom_all_lib_ms:.4f}; bound {phantom_bound_ms:.4f} "
          f"({phantom_by}) / {phantom_all_bound:.4f} ({phantom_all_by}); {phantom_qr_ops()} "
          f"operations per hypothesis [{smi}]")
    for b in (chunk22, h22):
        print(f"    phantom_qr at {b}: {launch_shape(kernels.PHANTOM_QR, b)}")

    # The f64 gate of the JAX chip check: the sweep's counts against f64
    # minimal_fit + agree on the same hypotheses, on that check's data model
    # (poses on the plane, N(0, 1) pixel noise) and on phase 22's.  Where a
    # sample's two smallest singular values nearly coincide (sigma_30 /
    # sigma_31 < PHANTOM_GAP) its null direction is arbitrary to rounding, and
    # the f32 subspace + Rayleigh-Ritz and the f64 SVD may pick different
    # planes (the JAX package's own fast path parts from its f64 fit on the
    # same samples); the gate holds the samples with a unique null direction.
    def f64_gate(data_t, label):
        perm = torch.randperm(PHANTOM_N, generator=gen(), device=dev)
        c_fast, _ = ph_est.structured_sweep(data_t, None, PHANTOM_GATE_GROUPS, perm=perm)
        samples = structured_samples(None, data_t, ph_est.k, PHANTOM_GATE_GROUPS, perm)
        p64, v64 = ph_est.minimal_fit(samples)
        c64 = torch.where(v64, ph_est.agree(p64, data_t).sum(-1), -1)
        d = (c_fast - c64).abs()
        planes, _ = us_fast.build_sampling_planes("plane_phantom", data_t, None,
                                                  PHANTOM_GATE_GROUPS, perm=perm)
        sv = torch.linalg.svdvals(us_fast.phantom_systems(planes).permute(2, 0, 1))
        ratio = sv[:, 29] / sv[:, 30]
        unique = ratio >= PHANTOM_GAP
        apart = ratio[d > 2]
        print(f"    f64 gate, {label}, {c_fast.numel()} hypotheses: max|dcount|={int(d.max())}, "
              f"mean {float(d.float().mean()):.4f}, {apart.numel()} above 2 (largest "
              f"sigma_30/sigma_31 among them {float(apart.max()) if apart.numel() else 0.0:.3g}); "
              f"on the {int(unique.sum())} with sigma_30/sigma_31 >= {PHANTOM_GAP:g}: "
              f"max|dcount|={max_or(d[unique], 0)} (<=2); maxcount fast={int(c_fast.max())} "
              f"f64={int(c64.max())}, invalid fast={int((c_fast < 0).sum())} "
              f"f64={int((c64 < 0).sum())}")
        check(int(c_fast.max()) == int(c64.max()) > 0, f"f64 gate ({label}): maxima differ")
        check(max_or(d[unique], 0) <= 2, f"the phantom sweep fails the f64 gate ({label})")

    f64_gate(interop.data_to_torch(phantom_data(rng, PHANTOM_N, geometry, sigma=1.0,
                                                shove=False)[0], device=dev),
             "the chip check's data")
    f64_gate(data22_t, "phase 22's data")

    # The gathered driver: the batched f64 31x31 SVD, no kernel.
    def run22g():
        return ransac(ph_est, data22, gen(), num_hypotheses=H_PHANTOM_GATHER, device=DEVICE)

    kernels.reset_launch_counts()
    res22g = run22g()
    torch.cuda.synchronize()
    counts22g = kernels.launch_counts()
    print(f"    ransac gather plane phantom hypotheses={H_PHANTOM_GATHER}: launches {counts22g}")
    check_phantom(res22g, "gather")
    check(sum(counts22g.values()) == 0, "the phantom gather path launched a kernel")
    wall22g = timer.wall_ms(run22g, reps=WALL_REPS)
    print(f"    wall {wall22g:.3f} ms median of {WALL_REPS}, {H_PHANTOM_GATHER / wall22g * 1e3:.4g} "
          f"hypotheses/s [{smi}]")
    breakdown(torch, run22g, "phantom gather")
    phantom_s = time.perf_counter() - t_phantom
    print(f"    phase 22 took {phantom_s:.1f} s (budget {PHANTOM_BUDGET_S:.0f} s)")
    check(phantom_s < PHANTOM_BUDGET_S, "phase 22 overran its budget")

    # 23-25. the stats LM, the sharded drivers, the resumable sweep ----------
    t_sharded = time.perf_counter()
    cross_est = get(US["crosswire"][0])(US_DELTA)
    phase_stats_lm(torch, dev, rng, timer, smi, (
        cross_est, interop.data_to_torch(us_data16["crosswire"], device=dev),
        consensus16["crosswire"]))
    fused_cases = [("sphere3d", torch.as_tensor(cloud5, device=dev), H_FUSED // N_MAIN, DELTA)]
    fused_cases += [(f, torch.as_tensor(clouds9[f], device=dev), H_FUSED // N_MAIN, DELTA)
                    for f in FAMILIES]
    fused_cases += [(f, interop.data_to_torch(rigid_data13[f], device=dev), RIGID[f][2],
                     getattr(rigid_est(f), "fused_delta", DELTA)) for f in RIGID]
    fused_cases += [(f, interop.data_to_torch(us_data16[f], device=dev), US[f][2], US_DELTA)
                    for f in US]
    pointer_est = get(US["pointer"][0])(US_DELTA)
    phase_sharded(
        torch, dev, timer, smi, add_launches, fused_cases,
        (ph_est, data22_t, PHANTOM_GROUPS, chunks22),
        (est, torch.as_tensor(cloud5, device=dev)),
        (plane_est, torch.as_tensor(cloud10, device=dev), res10.consensus),
        (pointer_est, interop.data_to_torch(us_data16["pointer"], device=dev),
         consensus16["pointer"]))
    phase_resume(torch, dev, rng, args.seed + 25, add_launches, est)
    sharded_s = time.perf_counter() - t_sharded
    print(f"    phases 23-25 took {sharded_s:.1f} s (budget {SHARDED_PHASES_BUDGET_S:.0f} s)")
    check(sharded_s < SHARDED_PHASES_BUDGET_S, "phases 23-25 overran their budget")

    # 26. the CLI, synthetic data and the examples -----------------------------
    errs26 = phase_host_layers(torch, dev, args.seed + 26, add_launches, name, timer, smi)
    sweep_err = max(sweep_err, errs26.pop("fused_sweep_sphere3d", 0.0))
    vote_err = max(vote_err, errs26.pop("sphere_vote", 0))
    for k, e in errs26.items():
        family = k.removeprefix("fused_sweep_")
        family_err[family] = max(family_err.get(family, 0), e)

    # 27. the consensus refits far from the origin -----------------------------
    phase_far_refits(torch, dev, args.seed, add_launches, timer, smi)

    # kernels line, card line, result line -----------------------------------
    def entry(name, err, ms, plain_ms, bound_ms, bound_by, library_ms):
        source = kernels.ALL[[k.name for k in kernels.ALL].index(name)].source
        return {"name": name, "route": "cuda",
                "source": str(source.relative_to(source.parents[2])),
                "replaces": REPLACES[name], "launches": launches.get(name, 0),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}

    pv = plane_vote_times[PLANE_VOTE_SHAPES[0]]
    record = {"kernels": [
        entry("fused_sweep_sphere3d", sweep_err, sweep_ms, sweep_plain_ms, sweep_bound,
              sweep_by, None),
        entry("sphere_vote", max(vote_err, err7), vote_ms, vote_plain_ms, vote_bound, vote_by,
              vote_lib_ms),
    ] + [
        entry(f"fused_sweep_{f}", family_err[f], *family_times[f], None) for f in FAMILIES
    ] + [
        entry("plane_vote", plane_vote_err, pv[0], pv[1], pv[3], pv[4], pv[2]),
    ] + [
        entry(f"fused_sweep_{f}", family_err[f], *family_times[f], None) for f in (*RIGID, *US)
    ] + [
        entry("sphere_lm", lm_err, lm_ms, lm_plain_ms, lm_bound, lm_by, None),
        entry("sphere_mega", mega_err, mega_ms, mega_plain_ms, mega_bound, mega_by, None),
        entry("sphere_planar_vote", planar_err, planar_ms, planar_plain_ms, planar_bound,
              planar_by, None),
        entry("phantom_qr", phantom_err, phantom_ms, phantom_plain_ms, phantom_bound_ms,
              phantom_by, phantom_lib_ms),
        entry("us_crosswire_residual", *crosswire_residual, None),
    ]}
    check(len(record["kernels"]) == len(kernels.ALL), "the kernels line misses a kernel")
    for k in record["kernels"]:
        check(all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms")), "bad timing")
        check(k["launches"] > 0, f"{k['name']} was not launched on the main path")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
