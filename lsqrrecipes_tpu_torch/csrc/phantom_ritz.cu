// The plane phantom's Rayleigh-Ritz, rank gate and reconstruction after B6,
// hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package computes this tail of the k = 31
// minimal fit as plain arrays (lsqrrecipes_tpu/ops/us_fast.py::
// _phantom_ritz_and_reconstruct), which XLA fuses under jit.  The port runs
// eagerly, where the same lanes-form code was about 1,050 small launches per
// chunk of 4,352 hypotheses, and five blocking copies of Python numbers to
// the card.  This kernel computes
// lsqrrecipes_tpu_torch/ops/us_fast.py::phantom_ritz_plain in one launch.
//
// Per hypothesis b, from its system A (31 x 31, row r of sample slot r) and
// B6's four f32 vectors V (the span that holds A's null direction):
//   * W = A V and S = W^T W (4 x 4) in the data's dtype;
//   * the shifted S, two inverse-iteration steps on e_0 by its Cholesky
//     factor, the null vector x = V c, unit length;
//   * the deflated second Ritz value (sigma_30^2 over-estimated) and sigma_0^2
//     by two f32 power steps on the f32 rounding of A, the rank gate;
//   * the reconstruction: the plane normal R1 row 3 and t1_z, R1's Euler
//     angles, the scaled columns c1, c2 and t3, the closest rotation R3 by five
//     Newton polar steps, its Euler angles, the scales and the derived columns.
// Output: params [B, 41] in the data's dtype and valid [B] (bool).
//
// What bounds it: per hypothesis it reads A (7,688 bytes in float64) and V
// (496 bytes) and writes 329, against about 4,200 float64 multiply-adds (W
// and S) and 6,000 float32 ones (sigma_0): about 0.55 GB at 65,536
// hypotheses, 0.16 ms at the card's bandwidth.  A chunk holds 4,352
// hypotheses, so the launch has little to fill the card with.  The design:
//   * one thread per hypothesis, kThreads = 32 per block, so that a chunk's
//     136 blocks spread over the 132 SMs;
//   * A in the lane-major [31 rows, 31 columns, B] layout that the systems
//     are built in, so a warp reads one entry of 32 hypotheses as 256
//     contiguous bytes; it is streamed a row at a time: w_r = A[r, :] V^T
//     (four sums over the columns), then S += w_r w_r^T, so 4 + 10
//     accumulators stay in registers instead of W's 124;
//   * three passes over A in all: the first forms W, S and the first power
//     step together (its start is uniform), the other two the power steps;
//     a pass reads a row once for its sums over the columns and again, from
//     L1, for the update over the rows, so no row is held in registers;
//   * V read once from B6's own [B, 4, 32] output into shared memory, a
//     column per thread (row stride kThreads + 1, no bank conflicts);
//   * everything after S is scalar code per thread, every loop unrolled.
// Measured on an H100 80GB HBM3 at 700 W: 0.104 ms a 4,352-hypothesis chunk
// and 0.582 ms at 65,536 in float64 (167 registers, no spill; the 40-byte
// stack frame is cos's argument reduction), 12 blocks per SM.  Read through
// a plain pointer, V's shared loads were hoisted out of the row loops: 255
// registers, 524 bytes of spill stores and 0.182 / 0.834 ms.  64 threads a
// block ran a chunk as fast and 65,536 4% slower.
// Rounding: every product, sum, division and square root is its own
// correctly rounded intrinsic, every sum in the plain version's order (over
// the columns, then the rows, each in index order; Python's sum from 0 where
// the plain version uses it), comparisons against the constants rounded to
// the dtype as PyTorch rounds a Python number, atan2 and cos CUDA's own, as
// torch.atan2 and torch.cos call them on the card; so on the card the kernel
// equals the plain version bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kN = 31;            // unknowns, and rows of a system
constexpr int kQ = 4;             // subspace vectors
constexpr int kVRows = 32;        // B6's rows per vector (row 31 is padding)
constexpr int kParams = 41;
constexpr int kPolarIters = 5;

// Rounded operations that nvcc may not contract into FMAs.
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double cos_(double a) { return cos(a); }
__device__ __forceinline__ float cos_(float a) { return cosf(a); }
__device__ __forceinline__ float to_f32(double a) { return __double2float_rn(a); }
__device__ __forceinline__ float to_f32(float a) { return a; }

// torch.clamp_min: a NaN stays NaN.
template <typename T>
__device__ __forceinline__ T clamp_lo(T x, T lo) { return x < lo ? lo : x; }

// x * (1 / clamp(|x|, tiny)) for a 4-vector, |x|^2 summed from 0.
template <typename T>
__device__ __forceinline__ void unit4(T (&x)[kQ], T tiny) {
  T n2 = T(0);
#pragma unroll
  for (int i = 0; i < kQ; ++i) n2 = add(n2, mul(x[i], x[i]));
  const T inv = div(T(1), clamp_lo(sqrt_rn(n2), tiny));
#pragma unroll
  for (int i = 0; i < kQ; ++i) x[i] = mul(x[i], inv);
}

// linalg.small.cholesky_solve_lanes' factor, pivots floored at tiny.
template <typename T>
__device__ __forceinline__ void cholesky4(const T (&a)[kQ][kQ], T tiny, T (&l)[kQ][kQ]) {
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    T s = a[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = sub(s, mul(l[j][k], l[j][k]));
    const T ljj = sqrt_rn(clamp_lo(s, tiny));
    l[j][j] = ljj;
#pragma unroll
    for (int i = j + 1; i < kQ; ++i) {
      T t = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = sub(t, mul(l[i][k], l[j][k]));
      l[i][j] = div(t, ljj);
    }
  }
}

// Its two triangular solves, in place.
template <typename T>
__device__ __forceinline__ void cholesky_solve4(const T (&l)[kQ][kQ], T (&x)[kQ]) {
  T y[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    T t = x[i];
#pragma unroll
    for (int k = 0; k < i; ++k) t = sub(t, mul(l[i][k], y[k]));
    y[i] = div(t, l[i][i]);
  }
#pragma unroll
  for (int i = kQ - 1; i >= 0; --i) {
    T t = y[i];
#pragma unroll
    for (int k = i + 1; k < kQ; ++k) t = sub(t, mul(l[k][i], x[k]));
    x[i] = div(t, l[i][i]);
  }
}

// ops.us_fast.polar3_lanes: five Newton steps X <- (X + X^-T) / 2 with
// adjugate inverses; false where a step's |det| <= 1e-9.
template <typename T>
__device__ __forceinline__ bool polar3(T (&x)[3][3]) {
  bool ok = true;
#pragma unroll
  for (int it = 0; it < kPolarIters; ++it) {
    T c[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
        c[i][j] = sub(mul(x[i1][j1], x[i2][j2]), mul(x[i1][j2], x[i2][j1]));
      }
    }
    const T det = add(add(mul(x[0][0], c[0][0]), mul(x[0][1], c[0][1])), mul(x[0][2], c[0][2]));
    const bool good = fabs(det) > T(1e-9);
    ok = ok && good;
    const T inv = div(T(1), good ? det : T(1));
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) x[i][j] = mul(T(0.5), add(x[i][j], mul(c[i][j], inv)));
    }
  }
  return ok;
}

// ops.us_fast.euler_zyx_plus_lanes: (wz, wy, wx) with the gimbal branch.
template <typename T>
__device__ __forceinline__ void euler_zyx_plus(const T (&r)[3][3], T half_pi, T small_angle,
                                               T* out) {
  const T wy = atan2_(-r[2][0], sqrt_rn(add(mul(r[0][0], r[0][0]), mul(r[1][0], r[1][0]))));
  const bool gimbal = !((fabs(sub(wy, half_pi)) > small_angle) &&
                        (fabs(add(wy, half_pi)) > small_angle));
  const T cy = gimbal ? T(1) : cos_(wy);
  out[0] = gimbal ? T(0) : atan2_(div(r[1][0], cy), div(r[0][0], cy));
  out[1] = wy;
  out[2] = gimbal ? atan2_(r[0][1], r[1][1]) : atan2_(div(r[2][1], cy), div(r[2][2], cy));
}

// a[31, 31, B] (rows, columns, hypotheses), v[B, 4, 32] f32 (B6's output);
// params[B, 41], valid[B].
template <typename T>
__global__ void __launch_bounds__(kThreads)
phantom_ritz_kernel(const T* __restrict__ a, const float* __restrict__ v, int num_hyp,
                    T shift_coef, T tiny, T rank_coef, T half_pi, T small_angle, float p0,
                    T* __restrict__ params, bool* __restrict__ valid) {
  __shared__ float s_v[kQ * kN * (kThreads + 1)];
  const int tid = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long nb = static_cast<long long>(num_hyp);
  // The block's vectors, read as B6 wrote them, a hypothesis per column.
  for (int idx = tid; idx < kThreads * kQ * kVRows; idx += kThreads) {
    const int h = idx / (kQ * kVRows), qc = idx % (kQ * kVRows);
    const int q = qc / kVRows, c = qc % kVRows;
    if (c < kN && b0 + h < nb) {
      s_v[(q * kN + c) * (kThreads + 1) + h] = v[b0 * kQ * kVRows + idx];
    }
  }
  __syncthreads();
  const long long b = b0 + tid;
  if (b >= nb) return;
  // Read through a volatile pointer, so that V is read from shared memory
  // where it is used: hoisted out of the row loops, its 124 values would
  // take the registers (255 and spills in float64).
  const volatile float* vb = s_v + tid;
  auto vq = [&](int q, int c) { return T(vb[(q * kN + c) * (kThreads + 1)]); };

  bool fac_ok = true;
#pragma unroll
  for (int k = 0; k < kQ * kN; ++k) fac_ok = fac_ok && isfinite(vb[k * (kThreads + 1)]);

  // Pass 1: W = A V and S = W^T W a row at a time, and the first power step
  // g = A32^T (A32 p0) from the uniform start.  A row is read once for its
  // sums and read again (from L1) for g's update, so that it need not stay
  // in registers.
  T s[kQ][kQ];
  float g[kN];
#pragma unroll 1
  for (int r = 0; r < kN; ++r) {
    const T* ar = a + static_cast<long long>(r) * kN * nb + b;
    T w[kQ];
    float ap;
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      const T arc = ar[c * nb];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const T prod = mul(arc, vq(q, c));
        w[q] = c == 0 ? prod : add(w[q], prod);
      }
      const float prod = mul(p0, to_f32(arc));
      ap = c == 0 ? prod : add(ap, prod);
    }
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
#pragma unroll
      for (int j = i; j < kQ; ++j) {
        const T prod = mul(w[i], w[j]);
        s[i][j] = r == 0 ? prod : add(s[i][j], prod);
      }
    }
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      const float prod = mul(to_f32(ar[c * nb]), ap);
      g[c] = r == 0 ? prod : add(g[c], prod);
    }
  }
#pragma unroll
  for (int i = 1; i < kQ; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) s[i][j] = s[j][i];
  }

  // Passes 2 and 3: normalise, then the next power step; sigma_0^2 is the
  // Rayleigh quotient of the last.
  float p[kN];
#pragma unroll 1
  for (int step = 0; step < 2; ++step) {
    float n2 = mul(g[0], g[0]);
#pragma unroll
    for (int c = 1; c < kN; ++c) n2 = add(n2, mul(g[c], g[c]));
    const float inv = div(1.0f, sqrt_rn(clamp_lo(n2, static_cast<float>(1e-30))));
#pragma unroll
    for (int c = 0; c < kN; ++c) p[c] = mul(g[c], inv);
#pragma unroll 1
    for (int r = 0; r < kN; ++r) {
      const T* ar = a + static_cast<long long>(r) * kN * nb + b;
      float ap = mul(p[0], to_f32(ar[0]));
#pragma unroll
      for (int c = 1; c < kN; ++c) ap = add(ap, mul(p[c], to_f32(ar[c * nb])));
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        const float prod = mul(to_f32(ar[c * nb]), ap);
        g[c] = r == 0 ? prod : add(g[c], prod);
      }
    }
  }
  float sig0_sq = mul(p[0], g[0]);
#pragma unroll
  for (int c = 1; c < kN; ++c) sig0_sq = add(sig0_sq, mul(p[c], g[c]));

  // The smallest Ritz vector: two shifted inverse-iteration steps on e_0.
  const T trace = add(add(add(s[0][0], s[1][1]), s[2][2]), s[3][3]);
  const T shift = add(mul(shift_coef, trace), tiny);
  T s_ll[kQ][kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
#pragma unroll
    for (int j = 0; j < kQ; ++j) s_ll[i][j] = i == j ? add(s[i][j], shift) : s[i][j];
  }
  T l[kQ][kQ];
  cholesky4(s_ll, tiny, l);
  T cv[kQ] = {T(1), T(0), T(0), T(0)};
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    cholesky_solve4(l, cv);
    unit4(cv, tiny);
  }
  T x[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    T acc = T(0);
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc = add(acc, mul(cv[q], vq(q, i)));
    x[i] = acc;
  }
  T nx = mul(x[0], x[0]);
#pragma unroll
  for (int i = 1; i < kN; ++i) nx = add(nx, mul(x[i], x[i]));
  const T xn = div(T(1), clamp_lo(sqrt_rn(nx), tiny));
#pragma unroll
  for (int i = 0; i < kN; ++i) x[i] = mul(x[i], xn);

  // The rank gate: the deflated second Ritz value against sigma_0^2.
  auto deflate = [&](T (&y)[kQ]) {
    T dot = T(0);
#pragma unroll
    for (int i = 0; i < kQ; ++i) dot = add(dot, mul(cv[i], y[i]));
#pragma unroll
    for (int i = 0; i < kQ; ++i) y[i] = sub(y[i], mul(dot, cv[i]));
    unit4(y, tiny);
  };
  T y[kQ] = {T(0), T(1), T(0), T(0)};
  deflate(y);
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    cholesky_solve4(l, y);
    deflate(y);
  }
  T lam1 = T(0);
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    T sy = T(0);
#pragma unroll
    for (int j = 0; j < kQ; ++j) sy = add(sy, mul(s[i][j], y[j]));
    lam1 = add(lam1, mul(y[i], sy));
  }
  const bool rank_ok = lam1 > mul(rank_coef, clamp_lo(static_cast<T>(sig0_sq), T(1)));

  // The reconstruction.
  const T denom = sqrt_rn(add(add(mul(x[27], x[27]), mul(x[28], x[28])), mul(x[29], x[29])));
  const bool nondeg = denom > T(1e-30);
  const T invd = div(T(1), nondeg ? denom : T(1));
#pragma unroll
  for (int i = 0; i < kN; ++i) x[i] = mul(x[i], invd);
  const T r1[3] = {x[27], x[28], x[29]};           // R1 row 3, the plane normal
  const T wy1 = atan2_(-r1[0], sqrt_rn(add(mul(r1[1], r1[1]), mul(r1[2], r1[2]))));
  const bool gimbal1 = !((fabs(sub(wy1, half_pi)) > small_angle) &&
                         (fabs(add(wy1, half_pi)) > small_angle));
  const T cy1 = gimbal1 ? T(1) : cos_(wy1);
  const T wx1 = gimbal1 ? T(0) : atan2_(div(r1[1], cy1), div(r1[2], cy1));
  T inv[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) inv[j] = div(T(1), fabs(r1[j]) > T(1e-30) ? r1[j] : T(1));
  T cols[3][3];                                    // c1, c2, t3
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < 3; ++j) acc = add(acc, mul(x[9 * k + 3 * j + cc], inv[j]));
      cols[k][cc] = div(acc, T(3));
    }
  }

  // ops.us_fast.orthonormalize_lanes(c1, c2).
  const T* c1 = cols[0];
  const T* c2 = cols[1];
  const T n1 = add(add(mul(c1[0], c1[0]), mul(c1[1], c1[1])), mul(c1[2], c1[2]));
  const T n2 = add(add(mul(c2[0], c2[0]), mul(c2[1], c2[1])), mul(c2[2], c2[2]));
  const bool scales_ok = (n1 > T(1e-20)) && (n2 > T(1e-20));
  const T i1 = div(T(1), sqrt_rn(clamp_lo(n1, T(1e-30))));
  const T i2 = div(T(1), sqrt_rn(clamp_lo(n2, T(1e-30))));
  T ra[3], rb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ra[i] = mul(c1[i], i1);
    rb[i] = mul(c2[i], i2);
  }
  T rot[3][3] = {
      {ra[0], rb[0], sub(mul(ra[1], rb[2]), mul(ra[2], rb[1]))},
      {ra[1], rb[1], sub(mul(ra[2], rb[0]), mul(ra[0], rb[2]))},
      {ra[2], rb[2], sub(mul(ra[0], rb[1]), mul(ra[1], rb[0]))},
  };
  const bool polar_ok = polar3(rot);
  const T m_x = mul(n1, i1), m_y = mul(n2, i2);
  T angles3[3];
  euler_zyx_plus(rot, half_pi, small_angle, angles3);

  T* out = params + b * kParams;
  out[0] = wy1;
  out[1] = wx1;
  out[2] = x[30];                                  // t1_z
#pragma unroll
  for (int cc = 0; cc < 3; ++cc) out[3 + cc] = cols[2][cc];
#pragma unroll
  for (int k = 0; k < 3; ++k) out[6 + k] = angles3[k];
  out[9] = m_x;
  out[10] = m_y;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) {
      out[11 + 3 * j + cc] = mul(mul(m_x, r1[j]), rot[cc][0]);
      out[20 + 3 * j + cc] = mul(mul(m_y, r1[j]), rot[cc][1]);
      out[29 + 3 * j + cc] = mul(r1[j], cols[2][cc]);
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) out[38 + j] = r1[j];
  valid[b] = fac_ok && rank_ok && nondeg && scales_ok && polar_ok;
}

template <typename T>
void launch(const void* a, const void* v, int num_hyp, double shift_coef, double tiny,
            double rank_coef, double half_pi, double small_angle, float p0, void* params,
            void* valid, cudaStream_t s) {
  const unsigned blocks = lsq_sweep::ceil_div(static_cast<unsigned long long>(num_hyp), kThreads);
  phantom_ritz_kernel<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const float*>(v), num_hyp,
      static_cast<T>(shift_coef), static_cast<T>(tiny), static_cast<T>(rank_coef),
      static_cast<T>(half_pi), static_cast<T>(small_angle), p0, static_cast<T*>(params),
      static_cast<bool*>(valid));
}

}  // namespace

extern "C" const char* lsq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a[31, 31, B] contiguous, float64 if is_double, else float32; v the [B, 4,
// 32] float32 output of phantom_qr_launch; params[B, 41] in a's dtype and
// valid[B] (bool), all on the current device.  The constants are the plain
// version's Python numbers, rounded to the dtype here as PyTorch rounds them.
// Enqueues on `stream` and returns cudaGetLastError().
extern "C" int phantom_ritz_launch(const void* a, const void* v, int num_hyp, int is_double,
                                   double shift_coef, double tiny, double rank_coef,
                                   double half_pi, double small_angle, float p0, void* params,
                                   void* valid, void* stream) {
  if (num_hyp <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    launch<double>(a, v, num_hyp, shift_coef, tiny, rank_coef, half_pi, small_angle, p0, params,
                   valid, s);
  } else {
    launch<float>(a, v, num_hyp, shift_coef, tiny, rank_coef, half_pi, small_angle, p0, params,
                  valid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The float64 kernel's launch shape at num_hyp hypotheses.
extern "C" int phantom_ritz_shape(int num_hyp, int* out) {
  return lsq_sweep::kernel_shape(phantom_ritz_kernel<double>, kThreads, kThreads, num_hyp, out);
}
