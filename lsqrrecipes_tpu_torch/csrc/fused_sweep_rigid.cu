// Whole-sweep RANSAC for pivot calibration, absolute orientation, ray
// intersection and the 6-unknown dense linear system, hand-written for
// Hopper (sm_90a).
//
// Replaces lsqrrecipes_tpu/ops/fused_sweep.py::_make_kernel with the
// pivot_fit_vote, absolute_orientation_fit_vote, ray3d_fit_vote and
// dense_linear6_fit_vote closures (the pallas_call in _sweep_call): one C
// launch symbol per family, each instantiating sweep_common.cuh's split-vote
// split_sweep_kernel.  Each family computes what its closure computes, in
// the closure's operation order:
//   * pivot (k = 3 frames, slot features [vec(R) 9, t 3, R^T t 3]): S = sum R,
//     v = sum t, u = sum R^T t; N = 9I - S S^T, rhs = 3v - S u; Cramer solve
//     for t_W, degenerate when |det N| < 1e-6; t_D = (S^T t_W - u) / 3;
//     params [t_D, t_W];
//   * absolute_orientation (k = 3 pairs, slot features [p1, p2]): per set
//     x = normalize(q0 - mean), y = Gram-Schmidt of q1 - mean, z = x cross y,
//     degenerate when |z|^2 < 1e-12; R = R2 R1^T, t = mean2 - R mean1;
//     params [vec(R) 9, t 3] (the host turns them into [q, t]);
//   * ray3d (k = 2 rays, slot features [p, n]): the midpoint x of the common
//     perpendicular, degenerate when |na x nb|^2 < cross_eps or either ray
//     parameter is negative; params x;
//   * dense_linear6 (k = 6 rows [a 6, b]): normal equations over the six
//     rows, an unrolled Cholesky whose pivots below 1e-10 flag the
//     degenerate case, forward and back substitution; params x.
// The fits use __f*_rn intrinsics (nothing is contracted into an FMA) and
// compute lax.rsqrt as 1/sqrt in two correctly rounded steps, so the winner's
// parameters are bit for bit those of the plain PyTorch versions
// (ops/fused_sweep.py).
//
// The votes.  The TPU closures vote through _dot_f32x3: three bf16 passes of
// K = 8-17 products on the matrix unit (whose f32 product is one bf16
// pass), walked in 512-column chunks to stay inside VMEM.  On the FP32 pipes
// neither reason holds, so every cell is computed in f32 from the staged
// rows, in the order the plain versions repeat (each FMA rounded once by
// linalg.small.fma_f32 there):
//   * pivot: e_j = fma(R_j2, t_D2, fma(R_j1, t_D1, fma(R_j0, t_D0, t_j))) -
//     t_W[j], |e|^2 = fma(e_2, e_2, fma(e_1, e_1, e_0 e_0)) < delta^2 (the
//     residual components, not the quadratic expansion whose ~1e4 terms
//     cancel; the function's 3 x (3 mul + 2 add + add + sub) + 3 mul + 2 add
//     + compare + count = 28 operations in 9 + 2 FMAs, 3 subtractions, a
//     multiply, a compare and a count);
//   * absolute_orientation: e_j = fma(R_j2, z1, fma(R_j1, y1, fma(R_j0, x1,
//     t_j))) - p2_j, |e|^2 as pivot's (the subtraction last, as pointer's;
//     the function's 28 operations likewise);
//   * ray3d: v = x - p, t = fma(n_z, v_z, fma(n_y, v_y, n_x v_x)) >= 0 and
//     fma(-(t t), w, |v|^2) < delta^2 with |v|^2 as t and w = 2 - |n|^2
//     formed once per point, the last term exact for directions that are not
//     unit (the function's 3 sub, 8 mul, 4 add, 2 sub, 2 compares, and,
//     count = 21 operations in 3 subtractions, 3 multiplies, 5 FMAs, two
//     compares and a count);
//   * dense_linear6: |e| < delta, e = fma(a5, x5, ... fma(a0, x0, -b)) (the
//     function's 15 operations in six FMAs, an abs-compare and a count).
// Padding columns (the ones row of P is 0) are staged with a NaN in the first
// row, so every comparison of theirs is false; the plain versions mask them.
//
// What bounds it on an H100: arithmetic.  At the family record's widths
// (pivot 2,048 groups x 512 lanes x 480 observations; absolute_orientation
// and ray3d 1,024 x 1,024 x 1,024; dense_linear6 2,048 x 1,024 x 1,024) the
// votes are 1.4e10-3.2e10 f32 operations against < 1 MB of input, 0.2-0.5 ms
// at 67 TFLOP/s; the fits (70-470 operations per hypothesis) add under 2%.
// Every cell runs on the FP32 pipes, and nothing per hypothesis is written
// to device memory.  split_sweep_kernel gives a block 32 k hypotheses (k per
// thread, their vote rows in registers) whose 8 warps split the points,
// stages a point as two or three float4s read as 16-byte broadcasts, adds
// the warps' counts exactly in shared memory and votes in FMA chains:
// absolute_orientation at k = 4 (96 registers, 2 blocks per SM) ~17.75
// instructions per cell against ~29.5 in the row-by-row sweep_kernel it
// replaced; dense_linear6 at k = 8 ~8.5 against ~16.5, every thread
// fitting one hypothesis, which halves the blocks and with them the fit's
// share of the sweep (its Cholesky takes 6 square roots and 27 divisions
// per hypothesis); ray3d at k = 8 (80 registers, 3 blocks per SM) ~14.4
// against ~21 + 7 scalar shared loads per point; pivot (three float4s, 682
// points per 32 KB tile) at k = 8 (104 registers, 2 blocks per SM), every
// thread fitting one of the 480-point sweep's hypotheses, ~17.7 against
// ~29.5 + 12 scalar shared loads per point.  At k = 4 both ran 3% slower
// on an H100 80GB HBM3 at 700 W (scripts/time_layouts.py).
// On an H100 80GB HBM3 at 700 W (chip_smoke.py) sweep_kernel took 1.3149 ms
// for dense_linear6, 1.1800 ms for absolute_orientation, 0.9053 ms for
// ray3d and 0.5914 ms for pivot.

#include "sweep_common.cuh"

namespace {

using lsq_sweep::Consts;
using lsq_sweep::rsqrt_rn;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float add3(float a, float b, float c) { return add(add(a, b), c); }

__device__ __forceinline__ float dot3(const float* u, const float* v) {
  return add3(mul(u[0], v[0]), mul(u[1], v[1]), mul(u[2], v[2]));
}

__device__ __forceinline__ void cross3(const float* u, const float* v, float* out) {
  out[0] = sub(mul(u[1], v[2]), mul(u[2], v[1]));
  out[1] = sub(mul(u[2], v[0]), mul(u[0], v[2]));
  out[2] = sub(mul(u[0], v[1]), mul(u[1], v[0]));
}

// Row `first` of P at `col`, or NaN on a padding column (P's ones row is 0).
__device__ __forceinline__ float live_or_nan(const float* __restrict__ p, long long stride,
                                             int col, int first, int ones) {
  return p[ones * stride + col] != 0.f ? p[first * stride + col] : __int_as_float(0x7fffffff);
}

struct Pivot {
  static constexpr int kSlots = 3, kDim = 15, kParams = 6, kVoteRows = 6;
  static constexpr int kHypPerThread = 8;
  using Point = lsq_sweep::Float4x3;
  struct Fit {
    float td[3], tw[3];
    bool degenerate;
  };

  static __device__ __forceinline__ Fit fit(const float s[3][15], const Consts&) {
    float S[3][3], v[3], u[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int k = 0; k < 3; ++k) S[j][k] = add3(s[0][3 * j + k], s[1][3 * j + k], s[2][3 * j + k]);
      v[j] = add3(s[0][9 + j], s[1][9 + j], s[2][9 + j]);
      u[j] = add3(s[0][12 + j], s[1][12 + j], s[2][12 + j]);
    }
    const float n00 = sub(9.f, dot3(S[0], S[0]));
    const float n11 = sub(9.f, dot3(S[1], S[1]));
    const float n22 = sub(9.f, dot3(S[2], S[2]));
    const float n01 = -dot3(S[0], S[1]);
    const float n02 = -dot3(S[0], S[2]);
    const float n12 = -dot3(S[1], S[2]);
    float r[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) r[j] = sub(mul(3.f, v[j]), dot3(S[j], u));
    const float c00 = sub(mul(n11, n22), mul(n12, n12));
    const float c01 = sub(mul(n02, n12), mul(n01, n22));
    const float c02 = sub(mul(n01, n12), mul(n02, n11));
    float det = add3(mul(n00, c00), mul(n01, c01), mul(n02, c02));
    Fit f;
    f.degenerate = fabsf(det) < 1e-6f;
    if (f.degenerate) det = 1.f;
    const float c11 = sub(mul(n00, n22), mul(n02, n02));
    const float c12 = sub(mul(n01, n02), mul(n00, n12));
    const float c22 = sub(mul(n00, n11), mul(n01, n01));
    f.tw[0] = __fdiv_rn(add3(mul(c00, r[0]), mul(c01, r[1]), mul(c02, r[2])), det);
    f.tw[1] = __fdiv_rn(add3(mul(c01, r[0]), mul(c11, r[1]), mul(c12, r[2])), det);
    f.tw[2] = __fdiv_rn(add3(mul(c02, r[0]), mul(c12, r[1]), mul(c22, r[2])), det);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float st = add3(mul(S[0][k], f.tw[0]), mul(S[1][k], f.tw[1]), mul(S[2][k], f.tw[2]));
      f.td[k] = __fdiv_rn(sub(st, u[k]), 3.f);
    }
    return f;
  }

  // Vote rows: t_D, then t_W.
  static __device__ __forceinline__ void vote_rows(const Fit& f, float r[kVoteRows]) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      r[c] = f.td[c];
      r[3 + c] = f.tw[c];
    }
  }

  // P rows: t 0-2, R^T t 3-5, vec(R) 6-14, ones 15, guard 16; staged [R_j0,
  // R_j1, R_j2, t_j] for j = 0, 1, 2 (t_0 NaN on padding columns).
  static __device__ __forceinline__ Point stage(const float* __restrict__ p, long long stride,
                                                int col) {
    const float* c = p + col;
    return {make_float4(c[6 * stride], c[7 * stride], c[8 * stride],
                        live_or_nan(p, stride, col, 0, 15)),
            make_float4(c[9 * stride], c[10 * stride], c[11 * stride], c[stride]),
            make_float4(c[12 * stride], c[13 * stride], c[14 * stride], c[2 * stride])};
  }

  // e_j = fma(R_j2, td_2, fma(R_j1, td_1, fma(R_j0, td_0, t_j))) - tw_j,
  // counted where fma(e_2, e_2, fma(e_1, e_1, e_0 e_0)) < delta^2.
  static __device__ __forceinline__ void vote(int& count, const float (&r)[kVoteRows],
                                              const Point& pt, const Consts& k) {
    const float4 row[3] = {pt.a, pt.b, pt.c};
    float e[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      e[j] = __fsub_rn(
          __fmaf_rn(row[j].z, r[2], __fmaf_rn(row[j].y, r[1], __fmaf_rn(row[j].x, r[0], row[j].w))),
          r[3 + j]);
    }
    lsq_sweep::count_below(
        count, __fmaf_rn(e[2], e[2], __fmaf_rn(e[1], e[1], __fmul_rn(e[0], e[0]))), k.delta_sq);
  }

  static __device__ __forceinline__ void params(const Fit& f, float* out) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[c] = f.td[c];
      out[3 + c] = f.tw[c];
    }
  }
};

struct AbsoluteOrientation {
  static constexpr int kSlots = 3, kDim = 6, kParams = 12, kVoteRows = 12;
  static constexpr int kHypPerThread = 4;
  using Point = lsq_sweep::Float4x2;
  struct Fit {
    float r[3][3], t[3];
    bool degenerate;
  };

  // Orthonormal frame (columns x, y, z) and mean of the slot points at
  // features base .. base + 2; true when the points are collinear.
  static __device__ __forceinline__ bool build_frame(const float s[3][6], int base, float x[3],
                                                     float y[3], float z[3], float mean[3]) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      mean[c] = __fdiv_rn(add3(s[0][base + c], s[1][base + c], s[2][base + c]), 3.f);
      x[c] = sub(s[0][base + c], mean[c]);
    }
    const float xr = rsqrt_rn(fmaxf(dot3(x, x), 1e-30f));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x[c] = mul(x[c], xr);
      y[c] = sub(s[1][base + c], mean[c]);
    }
    const float d = dot3(y, x);
#pragma unroll
    for (int c = 0; c < 3; ++c) y[c] = sub(y[c], mul(d, x[c]));
    const float yr = rsqrt_rn(fmaxf(dot3(y, y), 1e-30f));
#pragma unroll
    for (int c = 0; c < 3; ++c) y[c] = mul(y[c], yr);
    cross3(x, y, z);
    return dot3(z, z) < 1e-12f;
  }

  static __device__ __forceinline__ Fit fit(const float s[3][6], const Consts&) {
    float x1[3], y1[3], z1[3], m1[3], x2[3], y2[3], z2[3], m2[3];
    const bool d1 = build_frame(s, 0, x1, y1, z1, m1);
    const bool d2 = build_frame(s, 3, x2, y2, z2, m2);
    Fit f;
    f.degenerate = d1 || d2;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        f.r[a][b] = add3(mul(x2[a], x1[b]), mul(y2[a], y1[b]), mul(z2[a], z1[b]));
      }
      f.t[a] = sub(m2[a], dot3(f.r[a], m1));
    }
    return f;
  }

  // Vote rows: R row by row, then t.
  static __device__ __forceinline__ void vote_rows(const Fit& f, float r[kVoteRows]) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int c = 0; c < 3; ++c) r[3 * a + c] = f.r[a][c];
      r[9 + a] = f.t[a];
    }
  }

  // P rows: p1 0-2, p2 3-5, ones 6, guard 7; staged [p1, p2_x], [p2_y,
  // p2_z, 0, 0] (p1_x NaN on padding columns).
  static __device__ __forceinline__ Point stage(const float* __restrict__ p, long long stride,
                                                int col) {
    const float* c = p + col;
    return {make_float4(live_or_nan(p, stride, col, 0, 6), c[stride], c[2 * stride],
                        c[3 * stride]),
            make_float4(c[4 * stride], c[5 * stride], 0.f, 0.f)};
  }

  // e_j = fma(R_j2, z1, fma(R_j1, y1, fma(R_j0, x1, t_j))) - p2_j, counted
  // where fma(e_2, e_2, fma(e_1, e_1, e_0 e_0)) < delta^2.
  static __device__ __forceinline__ void vote(int& count, const float (&r)[kVoteRows],
                                              const Point& pt, const Consts& k) {
    const float p2[3] = {pt.a.w, pt.b.x, pt.b.y};
    float e[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      e[j] = __fsub_rn(__fmaf_rn(r[3 * j + 2], pt.a.z,
                                 __fmaf_rn(r[3 * j + 1], pt.a.y,
                                           __fmaf_rn(r[3 * j], pt.a.x, r[9 + j]))),
                       p2[j]);
    }
    lsq_sweep::count_below(
        count, __fmaf_rn(e[2], e[2], __fmaf_rn(e[1], e[1], __fmul_rn(e[0], e[0]))), k.delta_sq);
  }

  static __device__ __forceinline__ void params(const Fit& f, float* out) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int c = 0; c < 3; ++c) out[3 * a + c] = f.r[a][c];
      out[9 + a] = f.t[a];
    }
  }
};

struct Ray3D {
  static constexpr int kSlots = 2, kDim = 6, kParams = 3, kVoteRows = 3;
  static constexpr int kHypPerThread = 8;
  using Point = lsq_sweep::Float4x2;
  struct Fit {
    float x[3];
    bool degenerate;
  };

  static __device__ __forceinline__ Fit fit(const float s[2][6], const Consts& k) {
    const float* pa = s[0];
    const float* na = s[0] + 3;
    const float* pb = s[1];
    const float* nb = s[1] + 3;
    float p21[3], cr[3], c1[3], c2[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) p21[c] = sub(pb[c], pa[c]);
    cross3(na, nb, cr);
    const float denom = dot3(cr, cr);
    const bool nonparallel = denom >= k.cross_eps;
    const float safe = nonparallel ? denom : 1.f;
    cross3(p21, nb, c1);
    cross3(p21, na, c2);
    const float t1 = __fdiv_rn(dot3(cr, c1), safe);
    const float t2 = __fdiv_rn(dot3(cr, c2), safe);
    Fit f;
    f.degenerate = !(nonparallel && t1 >= 0.f && t2 >= 0.f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f.x[c] = mul(0.5f, add(add(add(pa[c], mul(t1, na[c])), pb[c]), mul(t2, nb[c])));
    }
    return f;
  }

  static __device__ __forceinline__ void vote_rows(const Fit& f, float r[kVoteRows]) {
#pragma unroll
    for (int c = 0; c < 3; ++c) r[c] = f.x[c];
  }

  // P rows: p 0-2, n 3-5, n.p 6, ones 7, |n|^2 8, |p|^2 9; staged [p, n_x],
  // [n_y, n_z, w = 2 - |n|^2, 0] (p_x NaN on padding columns).
  static __device__ __forceinline__ Point stage(const float* __restrict__ p, long long stride,
                                                int col) {
    const float* c = p + col;
    return {make_float4(live_or_nan(p, stride, col, 0, 7), c[stride], c[2 * stride],
                        c[3 * stride]),
            make_float4(c[4 * stride], c[5 * stride], sub(2.f, c[8 * stride]), 0.f)};
  }

  // v = x - p, t = fma(n_z, v_z, fma(n_y, v_y, n_x v_x)), |v|^2 likewise,
  // counted where t >= 0 and fma(-(t t), w, |v|^2) < delta^2.
  static __device__ __forceinline__ void vote(int& count, const float (&x)[kVoteRows],
                                              const Point& pt, const Consts& k) {
    const float vx = sub(x[0], pt.a.x), vy = sub(x[1], pt.a.y), vz = sub(x[2], pt.a.z);
    const float t = __fmaf_rn(pt.b.y, vz, __fmaf_rn(pt.b.x, vy, __fmul_rn(pt.a.w, vx)));
    const float d2 = __fmaf_rn(vz, vz, __fmaf_rn(vy, vy, __fmul_rn(vx, vx)));
    lsq_sweep::count_below_if(count, __fmaf_rn(-__fmul_rn(t, t), pt.b.z, d2), k.delta_sq, t);
  }

  static __device__ __forceinline__ void params(const Fit& f, float* out) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = f.x[c];
  }
};

struct DenseLinear6 {
  static constexpr int kSlots = 6, kDim = 7, kParams = 6, kVoteRows = 6;
  static constexpr int kHypPerThread = 8;
  using Point = lsq_sweep::Float4x2;
  struct Fit {
    float x[6];
    bool degenerate;
  };

  // sum over the six sampled rows of s[r][i] * s[r][j], in row order.
  static __device__ __forceinline__ float dot6(const float s[6][7], int i, int j) {
    float acc = mul(s[0][i], s[0][j]);
#pragma unroll
    for (int r = 1; r < 6; ++r) acc = add(acc, mul(s[r][i], s[r][j]));
    return acc;
  }

  static __device__ __forceinline__ Fit fit(const float s[6][7], const Consts&) {
    constexpr float kEps = 1e-10f;
    float l[6][6], y[6];
    Fit f;
    f.degenerate = false;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float piv = dot6(s, i, i);
#pragma unroll
      for (int k = 0; k < i; ++k) piv = sub(piv, mul(l[i][k], l[i][k]));
      f.degenerate = f.degenerate || piv < kEps;
      l[i][i] = __fsqrt_rn(fmaxf(piv, kEps));
#pragma unroll
      for (int j = i + 1; j < 6; ++j) {
        float t = dot6(s, i, j);
#pragma unroll
        for (int k = 0; k < i; ++k) t = sub(t, mul(l[j][k], l[i][k]));
        l[j][i] = __fdiv_rn(t, l[i][i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float t = dot6(s, i, 6);
#pragma unroll
      for (int k = 0; k < i; ++k) t = sub(t, mul(l[i][k], y[k]));
      y[i] = __fdiv_rn(t, l[i][i]);
    }
#pragma unroll
    for (int i = 5; i >= 0; --i) {
      float t = y[i];
#pragma unroll
      for (int k = i + 1; k < 6; ++k) t = sub(t, mul(l[k][i], f.x[k]));
      f.x[i] = __fdiv_rn(t, l[i][i]);
    }
    return f;
  }

  static __device__ __forceinline__ void vote_rows(const Fit& f, float r[kVoteRows]) {
#pragma unroll
    for (int c = 0; c < 6; ++c) r[c] = f.x[c];
  }

  // P rows: a 0-5, b 6, ones 7, guard 8; staged [a0 .. a3], [a4, a5, b, 0]
  // (a0 NaN on padding columns).
  static __device__ __forceinline__ Point stage(const float* __restrict__ p, long long stride,
                                                int col) {
    const float* c = p + col;
    return {make_float4(live_or_nan(p, stride, col, 0, 7), c[stride], c[2 * stride],
                        c[3 * stride]),
            make_float4(c[4 * stride], c[5 * stride], c[6 * stride], 0.f)};
  }

  // e = fma(a5, x5, ... fma(a1, x1, fma(a0, x0, -b))), counted where |e| <
  // delta: six FFMAs and one FSETP with |e| and -b as operand modifiers.
  static __device__ __forceinline__ void vote(int& count, const float (&x)[kVoteRows],
                                              const Point& pt, const Consts& k) {
    float e = __fmaf_rn(pt.a.x, x[0], -pt.b.z);
    e = __fmaf_rn(pt.a.y, x[1], e);
    e = __fmaf_rn(pt.a.z, x[2], e);
    e = __fmaf_rn(pt.a.w, x[3], e);
    e = __fmaf_rn(pt.b.x, x[4], e);
    e = __fmaf_rn(pt.b.y, x[5], e);
    lsq_sweep::count_below(count, fabsf(e), k.delta);
  }

  static __device__ __forceinline__ void params(const Fit& f, float* out) {
#pragma unroll
    for (int c = 0; c < 6; ++c) out[c] = f.x[c];
  }
};

// The kernels' constants from the launch symbols' f32 arguments.
Consts consts(float delta, float delta_sq, float cross_eps) {
  return Consts{0.f, delta_sq, delta, cross_eps};
}

}  // namespace

extern "C" const char* lsq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launch symbol: coords f32[kSlots * kDim, coords_stride] (coords_stride
// = 5 n_fit), p f32[rows of the family's P, p_stride], best_key u64[1]
// (scratch), best_out f32[kParams + 1], best_index i64[1]; all contiguous on
// the current device.  delta, delta_sq and cross_eps are f32 (cross_eps is
// read by ray3d only).  Evaluates num_groups * n_fit hypotheses (< 2^32) and
// enqueues three operations on `stream`; returns the first CUDA error, 0 on
// success.
extern "C" int fused_sweep_pivot_launch(
    const float* coords, long long coords_stride, const float* p, long long p_stride,
    int vote_cols, int n_fit, long long num_groups, int b, int m, unsigned mask, float delta,
    float delta_sq, float cross_eps, unsigned long long* best_key, float* best_out,
    long long* best_index, void* stream) {
  return lsq_sweep::launch_split<Pivot>(coords, coords_stride, p, p_stride, vote_cols, n_fit,
                                        num_groups, b, m, mask, consts(delta, delta_sq, cross_eps),
                                        best_key, best_out, best_index, stream);
}

// Each family's kernel's launch shape at num_hyp hypotheses on the current
// device, as lsq_sweep::kernel_shape gives it.
extern "C" int fused_sweep_pivot_shape(int num_hyp, int* out) {
  return lsq_sweep::kernel_shape(lsq_sweep::split_sweep_kernel<Pivot>, lsq_sweep::kSplitThreads,
                                 32 * Pivot::kHypPerThread, num_hyp, out);
}

extern "C" int fused_sweep_absolute_orientation_launch(
    const float* coords, long long coords_stride, const float* p, long long p_stride,
    int vote_cols, int n_fit, long long num_groups, int b, int m, unsigned mask, float delta,
    float delta_sq, float cross_eps, unsigned long long* best_key, float* best_out,
    long long* best_index, void* stream) {
  return lsq_sweep::launch_split<AbsoluteOrientation>(
      coords, coords_stride, p, p_stride, vote_cols, n_fit, num_groups, b, m, mask,
      consts(delta, delta_sq, cross_eps), best_key, best_out, best_index, stream);
}

extern "C" int fused_sweep_absolute_orientation_shape(int num_hyp, int* out) {
  return lsq_sweep::kernel_shape(lsq_sweep::split_sweep_kernel<AbsoluteOrientation>,
                                 lsq_sweep::kSplitThreads, 32 * AbsoluteOrientation::kHypPerThread,
                                 num_hyp, out);
}

extern "C" int fused_sweep_ray3d_launch(
    const float* coords, long long coords_stride, const float* p, long long p_stride,
    int vote_cols, int n_fit, long long num_groups, int b, int m, unsigned mask, float delta,
    float delta_sq, float cross_eps, unsigned long long* best_key, float* best_out,
    long long* best_index, void* stream) {
  return lsq_sweep::launch_split<Ray3D>(coords, coords_stride, p, p_stride, vote_cols, n_fit,
                                        num_groups, b, m, mask, consts(delta, delta_sq, cross_eps),
                                        best_key, best_out, best_index, stream);
}

extern "C" int fused_sweep_ray3d_shape(int num_hyp, int* out) {
  return lsq_sweep::kernel_shape(lsq_sweep::split_sweep_kernel<Ray3D>, lsq_sweep::kSplitThreads,
                                 32 * Ray3D::kHypPerThread, num_hyp, out);
}

extern "C" int fused_sweep_dense_linear6_launch(
    const float* coords, long long coords_stride, const float* p, long long p_stride,
    int vote_cols, int n_fit, long long num_groups, int b, int m, unsigned mask, float delta,
    float delta_sq, float cross_eps, unsigned long long* best_key, float* best_out,
    long long* best_index, void* stream) {
  return lsq_sweep::launch_split<DenseLinear6>(
      coords, coords_stride, p, p_stride, vote_cols, n_fit, num_groups, b, m, mask,
      consts(delta, delta_sq, cross_eps), best_key, best_out, best_index, stream);
}

extern "C" int fused_sweep_dense_linear6_shape(int num_hyp, int* out) {
  return lsq_sweep::kernel_shape(lsq_sweep::split_sweep_kernel<DenseLinear6>,
                                 lsq_sweep::kSplitThreads, 32 * DenseLinear6::kHypPerThread,
                                 num_hyp, out);
}
