// Whole-sweep RANSAC for the crosswire-phantom and calibrated-pointer
// ultrasound probe calibrations, hand-written for Hopper (sm_90a).
//
// Replaces lsqrrecipes_tpu/ops/fused_sweep.py::_make_kernel with the
// crosswire_fit_vote and pointer_fit_vote closures (the pallas_call in
// _sweep_call), with one C launch symbol each: each family runs a fit kernel
// and a vote kernel per chunk of hypotheses (see us_fit_kernel and the vote
// kernels).  Each family computes what its closure computes, in the
// operation order of the plain versions (ops/fused_sweep.py crosswire_fit /
// pointer_fit, which call linalg/small.py qr_solve_lanes and
// ops/us_fast.py orthonormalize_lanes):
//   * crosswire (k = 4 tracked images, slot features [vec(R2) 9, t2 3, u, v]):
//     the 12 x 12 system [u R2 | v R2 | R2 | -I] x = -t2 by Householder QR
//     with equilibrated columns (1/sqrt of the sequential sum of squares),
//     the pivot gate norm > 1e-5 and back substitution; then the scaled
//     columns c1 = x[0:3], c2 = x[3:6]: n = |c|^2 gated at 1e-20, r = c / |c|
//     with 1/sqrt in two rounded steps, the frame [r1, r2, r1 x r2] made a
//     rotation by five Newton polar steps X <- (X + X^-T) / 2 with adjugate
//     inverses (each gated at |det| > 1e-9); params [t1 = x[9:12],
//     t3 = x[6:9], m_x R3(:,0), m_y R3(:,1), R3(:,2)];
//   * pointer (k = 3 images, slot features [..., p 3]): the 9 x 9 system
//     [u R2 | v R2 | R2] x = p - t2, the same QR and polar steps; params
//     [t3, m_x R3(:,0), m_y R3(:,1), R3(:,2)].
// A lane is degenerate (counts 0) where a QR pivot, a column norm or a polar
// determinant fails its gate.  In the fits every product, sum, square root
// and division is its own __f*_rn operation (nothing is contracted into an
// FMA), so the winner's parameters are bit for bit those of the plain
// versions.
//
// The votes.  The TPU closures vote through _dot_f32x3: three bf16 passes of
// K = 16 (crosswire) and K = 8 (pointer) products on the matrix unit, in
// 512-column chunks to stay inside VMEM.  On the FP32 pipes neither reason
// holds, so every cell is computed in f32 from staged rows, using R2's
// orthogonality, |R2 img + t2 - t1|^2 = |img + R2^T t2 - R2^T t1|^2:
//   * crosswire: e_j = u c1_j + v c2_j + t3_j + (R2^T t2)_j - (R2 col j).t1,
//     |e|^2 < delta^2, as five FMAs and an add per component and a multiply
//     and two FMAs for |e|^2 (40 f32 operations per cell, an FMA counting
//     2);
//   * pointer: e_j = fma(v, c2_j, fma(u, c1_j, t3_j)) - w_j with w = R2^T
//     (p - t2), the subtraction last as in the closure's ((u c1_j + v c2_j)
//     + t3_j) - w_j, and |e|^2 a multiply and two FMAs (3 x (2 FMA + sub)
//     + mul + 2 FMA + compare + count = 22 operations).
// The plain versions round each FMA as CUDA does, so the two count alike.
// Padding columns (the ones row of P is 0) are staged with a NaN in u, so
// every comparison of theirs is false; the plain versions mask them.
//
// What bounds it on an H100: arithmetic.  At the JAX family record's width
// (1,024 groups x 1,024 lanes x 1,024 observations) the votes are 4.3e10
// (crosswire) and 2.3e10 (pointer) f32 operations and the fits about
// 3,900 and 2,100 operations per hypothesis (4.1e9 and 2.2e9), against
// < 2 MB of input: 0.70 and 0.38 ms at 67 TFLOP/s.  Every cell runs on the
// FP32 pipes, four hypotheses' vote rows per thread in registers so that
// one staged point feeds them all, points staged in shared memory and read
// as broadcasts.  The fits are unrolled into registers (the 12 x 12 QR holds
// about 170 floats), which is why each family fits in a kernel of its own:
// fused with the vote, the fit held the whole kernel at 255 (crosswire) and
// 210 (pointer) registers and one block of 256 threads per SM.  Split, the
// votes run at 96 registers or fewer, two or more blocks of 256 threads per
// SM, and the fit's rows pass through a workspace (54.5 and 41.9 MB per
// 2^20 hypotheses).  On an H100 80GB HBM3 at 700 W (chip_smoke.py) the
// crosswire sweep took 1.26-1.27 ms at that width (fit 0.23, vote
// 1.01-1.02), where the vote with separate multiplies and adds took
// 1.78-1.79 ms in all (timed from an edited copy of this source) and the
// fused kernel 2.18-2.19 ms; the pointer sweep took 0.74 ms (fit 0.116, vote
// 0.610) where its fused kernel took 1.21 ms.

#include "sweep_common.cuh"

namespace {

using lsq_sweep::Consts;
using lsq_sweep::rsqrt_rn;

constexpr float kQrEps = 1e-5f;       // Householder pivot gate (qr_solve_lanes eps)
constexpr float kTiny = 1.17549435e-38f;  // float's smallest normal, the equilibration floor

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float add3(float a, float b, float c) { return add(add(a, b), c); }

// max(x, lo) that keeps a NaN x, as torch.clamp_min does.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// Row `first` of P at `col`, or NaN on a padding column (P's ones row is 0).
__device__ __forceinline__ float live_or_nan(const float* __restrict__ p, long long stride,
                                             int col, int first, int ones) {
  return p[ones * stride + col] != 0.f ? p[first * stride + col] : __int_as_float(0x7fffffff);
}

// Householder least squares of a[R][C] x = b[R] with equilibrated columns;
// false where a pivot collapsed (norm <= 1e-5).  a and b are overwritten.
template <int R, int C>
__device__ __forceinline__ bool qr_solve(float (&a)[R][C], float (&b)[R], float (&x)[C]) {
  float inv_scale[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float norm2 = mul(a[0][c], a[0][c]);
#pragma unroll
    for (int r = 1; r < R; ++r) norm2 = add(norm2, mul(a[r][c], a[r][c]));
    inv_scale[c] = rsqrt_rn(clamp_min(norm2, kTiny));
#pragma unroll
    for (int r = 0; r < R; ++r) a[r][c] = mul(a[r][c], inv_scale[c]);
  }
  bool ok = true;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    float sigma = mul(a[k][k], a[k][k]);
#pragma unroll
    for (int r = k + 1; r < R; ++r) sigma = add(sigma, mul(a[r][k], a[r][k]));
    const float norm = __fsqrt_rn(sigma);
    const bool good = norm > kQrEps;
    ok = ok && good;
    const float akk = a[k][k];
    const float alpha = akk >= 0.f ? -norm : norm;
    const float vk = sub(akk, alpha);
    // v^T v = -2 alpha vk, so H = I + v v^T / (alpha vk).
    const float inv_denom = __fdiv_rn(1.f, good ? mul(alpha, vk) : 1.f);
#pragma unroll
    for (int j = k + 1; j < C; ++j) {
      float w = mul(vk, a[k][j]);
#pragma unroll
      for (int r = k + 1; r < R; ++r) w = add(w, mul(a[r][k], a[r][j]));
      w = mul(w, inv_denom);
      a[k][j] = add(a[k][j], mul(vk, w));
#pragma unroll
      for (int r = k + 1; r < R; ++r) a[r][j] = add(a[r][j], mul(a[r][k], w));
    }
    float w = mul(vk, b[k]);
#pragma unroll
    for (int r = k + 1; r < R; ++r) w = add(w, mul(a[r][k], b[r]));
    w = mul(w, inv_denom);
    b[k] = add(b[k], mul(vk, w));
#pragma unroll
    for (int r = k + 1; r < R; ++r) b[r] = add(b[r], mul(a[r][k], w));
    a[k][k] = alpha;
  }
#pragma unroll
  for (int i = C - 1; i >= 0; --i) {
    float t = b[i];
#pragma unroll
    for (int j = i + 1; j < C; ++j) t = sub(t, mul(a[i][j], x[j]));
    const float diag = a[i][i];
    x[i] = __fdiv_rn(t, fabsf(diag) > kQrEps ? diag : 1.f);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = mul(x[c], inv_scale[c]);
  return ok;
}

// Scales and closest rotation from the raw scaled columns x[0:3], x[3:6]:
// c1 = m_x R3(:,0), c2 = m_y R3(:,1), c3 = R3(:,2); false where a gate fails.
template <int N>
__device__ __forceinline__ bool orthonormalize(const float (&x)[N], float (&c1)[3],
                                               float (&c2)[3], float (&c3)[3]) {
  const float n1 = add3(mul(x[0], x[0]), mul(x[1], x[1]), mul(x[2], x[2]));
  const float n2 = add3(mul(x[3], x[3]), mul(x[4], x[4]), mul(x[5], x[5]));
  bool ok = n1 > 1e-20f && n2 > 1e-20f;
  const float i1 = rsqrt_rn(clamp_min(n1, 1e-30f));
  const float i2 = rsqrt_rn(clamp_min(n2, 1e-30f));
  float r1[3], r2[3], m[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r1[i] = mul(x[i], i1);
    r2[i] = mul(x[3 + i], i2);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int a = (i + 1) % 3, b = (i + 2) % 3;
    m[i][0] = r1[i];
    m[i][1] = r2[i];
    m[i][2] = sub(mul(r1[a], r2[b]), mul(r1[b], r2[a]));
  }
  // Five Newton polar steps X <- (X + X^-T) / 2, X^-T = cof(X) / det.
#pragma unroll
  for (int it = 0; it < 5; ++it) {
    float c[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int i1n = (i + 1) % 3, i2n = (i + 2) % 3;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
        c[i][j] = sub(mul(m[i1n][j1], m[i2n][j2]), mul(m[i1n][j2], m[i2n][j1]));
      }
    }
    const float det = add3(mul(m[0][0], c[0][0]), mul(m[0][1], c[0][1]), mul(m[0][2], c[0][2]));
    const bool good = fabsf(det) > 1e-9f;
    ok = ok && good;
    const float inv = __fdiv_rn(1.f, good ? det : 1.f);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) m[i][j] = mul(0.5f, add(m[i][j], mul(c[i][j], inv)));
    }
  }
  const float m_x = mul(n1, i1);
  const float m_y = mul(n2, i2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    c1[i] = mul(m_x, m[i][0]);
    c2[i] = mul(m_y, m[i][1]);
    c3[i] = m[i][2];
  }
  return ok;
}

struct Crosswire {
  static constexpr int kSlots = 4, kDim = 14, kParams = 15;
  struct Fit {
    float t1[3], t3[3], c1[3], c2[3], c3[3];
    bool degenerate;
  };

  static __device__ __forceinline__ Fit fit(const float s[4][14], const Consts&) {
    float a[12][12], b[12], x[12];
#pragma unroll
    for (int slot = 0; slot < 4; ++slot) {
      const float u = s[slot][12], v = s[slot][13];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int row = 3 * slot + j;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float r = s[slot][3 * j + c];
          a[row][c] = mul(u, r);
          a[row][3 + c] = mul(v, r);
          a[row][6 + c] = r;
          a[row][9 + c] = j == c ? -1.f : 0.f;
        }
        b[3 * slot + j] = -s[slot][9 + j];
      }
    }
    const bool ok = qr_solve<12, 12>(a, b, x);
    Fit f;
    const bool ok_rot = orthonormalize(x, f.c1, f.c2, f.c3);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      f.t1[i] = x[9 + i];
      f.t3[i] = x[6 + i];
    }
    f.degenerate = !(ok && ok_rot);
    return f;
  }

  static __device__ __forceinline__ void params(const Fit& f, float* out) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      out[i] = f.t1[i];
      out[3 + i] = f.t3[i];
      out[6 + i] = f.c1[i];
      out[9 + i] = f.c2[i];
      out[12 + i] = f.c3[i];
    }
  }

  // Workspace rows: t1 0-2, t3 3-5, c1 6-8, c2 9-11, degenerate 12.
  static constexpr int kWsRows = 13;
  static __device__ __forceinline__ void store(const Fit& f, float* ws, unsigned chunk,
                                               unsigned i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ws[c * chunk + i] = f.t1[c];
      ws[(3 + c) * chunk + i] = f.t3[c];
      ws[(6 + c) * chunk + i] = f.c1[c];
      ws[(9 + c) * chunk + i] = f.c2[c];
    }
  }
};

// Each family's sweep: a fit kernel and a vote kernel per chunk of at most
// `chunk` hypotheses, through a workspace ws f32[F::kWsRows, chunk] in
// structure-of-arrays order (row r of hypothesis i at ws[r * chunk + i]).
//   * the fit kernel (us_fit_kernel<F>, one wrapper per family): one
//     hypothesis per thread runs F::fit and F::store writes its vote rows
//     and the degenerate flag (the last row, 1 or 0).  The QR keeps its
//     system in registers, so the fit alone sets this kernel's registers;
//   * crosswire_vote_kernel: the split-vote layout (sweep_common.cuh), four
//     hypotheses' 12 rows (t1, t3, c1, c2) per thread.  A point is staged as
//     four float4 [u, v, q0, q1], [q2, R00, R01, R02], [R10, R11, R12, R20],
//     [R21, R22, 0, 0] with q = R2^T t2 (P's rows 3-5) and R2[k][j] P's row
//     6 + 3k + j, u NaN on a padding column (P's row 2, the ones row, is 0),
//     512 points per 32 KB tile.  Per cell, e_j = fma(R2[2][j], -t1_2,
//     fma(R2[1][j], -t1_1, fma(R2[0][j], -t1_0, fma(v, c2_j, fma(u, c1_j,
//     t3_j + q_j))))) and the count where fma(e2, e2, fma(e1, e1, e0 e0)) <
//     delta^2: 21 FMAs and adds, one multiply, a compare and a predicated add
//     per cell, and one 16-byte broadcast load;
//   * pointer_vote_kernel: the same layout, four hypotheses' 9 rows (t3, c1,
//     c2) per thread.  A point is staged as a float4 [u, v, w0, w1] and a
//     float w2 (P's rows 0, 1, 3-5), u NaN on a padding column, 2,048 points
//     per 40 KB tile.  Per cell, e_j = fma(v, c2_j, fma(u, c1_j, t3_j)) - w_j
//     and the count where fma(e2, e2, fma(e1, e1, e0 e0)) < delta^2: six
//     FMAs, three subtractions, a multiply, two FMAs, a compare and a
//     predicated add per cell, and two broadcast loads per point.  Its
//     __launch_bounds__ ask for 3 blocks per SM (80 registers, no spill;
//     left to itself the compiler took 96 and 2 blocks).
constexpr int kFitThreads = 128;
constexpr int kCwTile = 512;
static_assert(lsq_sweep::kSplitWarps * lsq_sweep::kSplitHypPerBlock * sizeof(int) <=
                  4 * kCwTile * sizeof(float4),
              "the partial counts reuse the tile");

template <class F>
__device__ __forceinline__ void fit_chunk(const float* __restrict__ coords,
                                          long long coords_stride, unsigned n_fit,
                                          unsigned h_first, unsigned n_valid, int b, int m,
                                          unsigned mask, const Consts& k,
                                          float* __restrict__ ws, unsigned chunk) {
  const unsigned i = blockIdx.x * kFitThreads + threadIdx.x;
  if (i >= n_valid) return;
  const typename F::Fit f =
      lsq_sweep::fit_hypothesis<F>(coords, coords_stride, h_first + i, n_fit, b, m, mask, k);
  F::store(f, ws, chunk, i);
  ws[(F::kWsRows - 1) * static_cast<size_t>(chunk) + i] = f.degenerate ? 1.f : 0.f;
}

__global__ void __launch_bounds__(kFitThreads)
crosswire_fit_kernel(const float* __restrict__ coords, long long coords_stride, unsigned n_fit,
                     unsigned h_first, unsigned n_valid, int b, int m, unsigned mask, Consts k,
                     float* __restrict__ ws, unsigned chunk) {
  fit_chunk<Crosswire>(coords, coords_stride, n_fit, h_first, n_valid, b, m, mask, k, ws, chunk);
}

__global__ void __launch_bounds__(lsq_sweep::kSplitThreads, 2)
crosswire_vote_kernel(const float* __restrict__ p, long long p_stride, int vote_cols,
                      unsigned h_first, unsigned n_valid, const float* __restrict__ ws,
                      unsigned chunk, float delta_sq, unsigned long long* __restrict__ best_key) {
  using namespace lsq_sweep;
  constexpr int kHyp = kSplitHypPerThread;
  __shared__ float4 tile[4][kCwTile];
  __shared__ bool counts_zero[kSplitHypPerBlock];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned i_first = blockIdx.x * kSplitHypPerBlock;
  float t3[kHyp][3], c1[kHyp][3], c2[kHyp][3], nt1[kHyp][3];
  int count[kHyp];
#pragma unroll
  for (int q = 0; q < kHyp; ++q) {
    const unsigned i = i_first + 32 * q + lane;
    const bool in = i < n_valid;  // a slot past the chunk votes on zeros, unpublished
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      nt1[q][c] = in ? -ws[c * chunk + i] : 0.f;
      t3[q][c] = in ? ws[(3 + c) * chunk + i] : 0.f;
      c1[q][c] = in ? ws[(6 + c) * chunk + i] : 0.f;
      c2[q][c] = in ? ws[(9 + c) * chunk + i] : 0.f;
    }
    count[q] = 0;
  }
  if (threadIdx.x < kSplitHypPerBlock) {
    const unsigned i = i_first + threadIdx.x;
    counts_zero[threadIdx.x] = i >= n_valid || ws[(Crosswire::kWsRows - 1) * chunk + i] != 0.f;
  }

  for (int t0 = 0; t0 < vote_cols; t0 += kCwTile) {
    const int len = min(kCwTile, vote_cols - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < len; i += kSplitThreads) {
      const int col = t0 + i;
      const float* r = p + col;
      tile[0][i] = make_float4(live_or_nan(p, p_stride, col, 0, 2), r[p_stride],
                               r[3 * p_stride], r[4 * p_stride]);
      tile[1][i] = make_float4(r[5 * p_stride], r[6 * p_stride], r[7 * p_stride],
                               r[8 * p_stride]);
      tile[2][i] = make_float4(r[9 * p_stride], r[10 * p_stride], r[11 * p_stride],
                               r[12 * p_stride]);
      tile[3][i] = make_float4(r[13 * p_stride], r[14 * p_stride], 0.f, 0.f);
    }
    __syncthreads();
#pragma unroll 2
    for (int i = warp; i < len; i += kSplitWarps) {
      const float4 s0 = tile[0][i], s1 = tile[1][i], s2 = tile[2][i], s3 = tile[3][i];
      const float u = s0.x, v = s0.y;
      const float qv[3] = {s0.z, s0.w, s1.x};
      // R2[k][j] for k, j < 3.
      const float r2[3][3] = {{s1.y, s1.z, s1.w}, {s2.x, s2.y, s2.z}, {s2.w, s3.x, s3.y}};
#pragma unroll
      for (int q = 0; q < kHyp; ++q) {
        float e[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float acc = __fadd_rn(t3[q][j], qv[j]);
          acc = __fmaf_rn(u, c1[q][j], acc);
          acc = __fmaf_rn(v, c2[q][j], acc);
          acc = __fmaf_rn(r2[0][j], nt1[q][0], acc);
          acc = __fmaf_rn(r2[1][j], nt1[q][1], acc);
          e[j] = __fmaf_rn(r2[2][j], nt1[q][2], acc);
        }
        const float d2 = __fmaf_rn(e[2], e[2], __fmaf_rn(e[1], e[1], __fmul_rn(e[0], e[0])));
        count_below(count[q], d2, delta_sq);
      }
    }
  }

  split_publish(count, reinterpret_cast<int*>(tile), counts_zero, h_first + i_first,
                n_valid - i_first, best_key);
}

struct Pointer {
  static constexpr int kSlots = 3, kDim = 17, kParams = 12;
  struct Fit {
    float t3[3], c1[3], c2[3], c3[3];
    bool degenerate;
  };

  static __device__ __forceinline__ Fit fit(const float s[3][17], const Consts&) {
    float a[9][9], b[9], x[9];
#pragma unroll
    for (int slot = 0; slot < 3; ++slot) {
      const float u = s[slot][12], v = s[slot][13];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int row = 3 * slot + j;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float r = s[slot][3 * j + c];
          a[row][c] = mul(u, r);
          a[row][3 + c] = mul(v, r);
          a[row][6 + c] = r;
        }
        b[3 * slot + j] = sub(s[slot][14 + j], s[slot][9 + j]);
      }
    }
    const bool ok = qr_solve<9, 9>(a, b, x);
    Fit f;
    const bool ok_rot = orthonormalize(x, f.c1, f.c2, f.c3);
#pragma unroll
    for (int i = 0; i < 3; ++i) f.t3[i] = x[6 + i];
    f.degenerate = !(ok && ok_rot);
    return f;
  }

  static __device__ __forceinline__ void params(const Fit& f, float* out) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      out[i] = f.t3[i];
      out[3 + i] = f.c1[i];
      out[6 + i] = f.c2[i];
      out[9 + i] = f.c3[i];
    }
  }

  // Workspace rows: t3 0-2, c1 3-5, c2 6-8, degenerate 9.
  static constexpr int kWsRows = 10;
  static __device__ __forceinline__ void store(const Fit& f, float* ws, unsigned chunk,
                                               unsigned i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ws[c * chunk + i] = f.t3[c];
      ws[(3 + c) * chunk + i] = f.c1[c];
      ws[(6 + c) * chunk + i] = f.c2[c];
    }
  }
};

constexpr int kPtTile = 2048;  // points per tile: 32 KB of float4 + 8 KB of w2
static_assert(lsq_sweep::kSplitWarps * lsq_sweep::kSplitHypPerBlock * sizeof(int) <=
                  kPtTile * sizeof(float4),
              "the partial counts reuse the tile");

__global__ void __launch_bounds__(kFitThreads)
pointer_fit_kernel(const float* __restrict__ coords, long long coords_stride, unsigned n_fit,
                   unsigned h_first, unsigned n_valid, int b, int m, unsigned mask, Consts k,
                   float* __restrict__ ws, unsigned chunk) {
  fit_chunk<Pointer>(coords, coords_stride, n_fit, h_first, n_valid, b, m, mask, k, ws, chunk);
}

__global__ void __launch_bounds__(lsq_sweep::kSplitThreads, 3)
pointer_vote_kernel(const float* __restrict__ p, long long p_stride, int vote_cols,
                    unsigned h_first, unsigned n_valid, const float* __restrict__ ws,
                    unsigned chunk, float delta_sq, unsigned long long* __restrict__ best_key) {
  using namespace lsq_sweep;
  constexpr int kHyp = kSplitHypPerThread;
  __shared__ float4 tile[kPtTile];  // [u, v, w0, w1]
  __shared__ float tile_w2[kPtTile];
  __shared__ bool counts_zero[kSplitHypPerBlock];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned i_first = blockIdx.x * kSplitHypPerBlock;
  float t3[kHyp][3], c1[kHyp][3], c2[kHyp][3];
  int count[kHyp];
#pragma unroll
  for (int q = 0; q < kHyp; ++q) {
    const unsigned i = i_first + 32 * q + lane;
    const bool in = i < n_valid;  // a slot past the chunk votes on zeros, unpublished
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      t3[q][c] = in ? ws[c * chunk + i] : 0.f;
      c1[q][c] = in ? ws[(3 + c) * chunk + i] : 0.f;
      c2[q][c] = in ? ws[(6 + c) * chunk + i] : 0.f;
    }
    count[q] = 0;
  }
  if (threadIdx.x < kSplitHypPerBlock) {
    const unsigned i = i_first + threadIdx.x;
    counts_zero[threadIdx.x] = i >= n_valid || ws[(Pointer::kWsRows - 1) * chunk + i] != 0.f;
  }

  for (int t0 = 0; t0 < vote_cols; t0 += kPtTile) {
    const int len = min(kPtTile, vote_cols - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < len; i += kSplitThreads) {
      const int col = t0 + i;
      const float* r = p + col;
      tile[i] = make_float4(live_or_nan(p, p_stride, col, 0, 2), r[p_stride], r[3 * p_stride],
                            r[4 * p_stride]);
      tile_w2[i] = r[5 * p_stride];
    }
    __syncthreads();
#pragma unroll 2
    for (int i = warp; i < len; i += kSplitWarps) {
      const float4 s = tile[i];
      const float w[3] = {s.z, s.w, tile_w2[i]};
#pragma unroll
      for (int q = 0; q < kHyp; ++q) {
        float e[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          e[j] = __fsub_rn(__fmaf_rn(s.y, c2[q][j], __fmaf_rn(s.x, c1[q][j], t3[q][j])), w[j]);
        }
        const float d2 = __fmaf_rn(e[2], e[2], __fmaf_rn(e[1], e[1], __fmul_rn(e[0], e[0])));
        count_below(count[q], d2, delta_sq);
      }
    }
  }

  split_publish(count, reinterpret_cast<int*>(tile), counts_zero, h_first + i_first,
                n_valid - i_first, best_key);
}

// Enqueue a family's whole sweep: clear the key; per chunk of at most
// `chunk` hypotheses the fit kernel, then the vote kernel; the finalize.
// Returns the first CUDA error, 0 on success.
template <class F, class FitKernel, class VoteKernel>
int launch_chunks(FitKernel fit_kernel, VoteKernel vote_kernel, const float* coords,
                  long long coords_stride, const float* p, long long p_stride, int vote_cols,
                  int n_fit, long long num_groups, int b, int m, unsigned mask, float delta,
                  float delta_sq, float cross_eps, unsigned long long* best_key, float* best_out,
                  long long* best_index, float* workspace, int chunk, void* stream) {
  using lsq_sweep::ceil_div;
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Consts k{0.f, delta_sq, delta, cross_eps};
  const unsigned step = static_cast<unsigned>(chunk);
  return lsq_sweep::launch_with<F>(
      coords, coords_stride, vote_cols, n_fit, num_groups, b, m, mask, k, best_key, best_out,
      best_index, s, [&](unsigned num_hyp) {
        for (unsigned long long h0 = 0; h0 < num_hyp; h0 += step) {
          const unsigned len = static_cast<unsigned>(num_hyp - h0 < step ? num_hyp - h0 : step);
          fit_kernel<<<ceil_div(len, kFitThreads), kFitThreads, 0, s>>>(
              coords, coords_stride, static_cast<unsigned>(n_fit), static_cast<unsigned>(h0),
              len, b, m, mask, k, workspace, step);
          cudaError_t err = cudaGetLastError();
          if (err != cudaSuccess) return err;
          vote_kernel<<<ceil_div(len, lsq_sweep::kSplitHypPerBlock), lsq_sweep::kSplitThreads,
                        0, s>>>(p, p_stride, vote_cols, static_cast<unsigned>(h0), len,
                                workspace, step, delta_sq, best_key);
          err = cudaGetLastError();
          if (err != cudaSuccess) return err;
        }
        return cudaSuccess;
      });
}

}  // namespace

extern "C" const char* lsq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launch symbol: coords f32[kSlots * kDim, coords_stride] (coords_stride
// = 5 n_fit), p f32[16 (crosswire) or 7 (pointer), p_stride], best_key u64[1]
// (scratch), best_out f32[kParams + 1], best_index i64[1], workspace
// f32[kWsRows (13 or 10), chunk]; all contiguous on the current device.
// delta_sq is f32 (delta and cross_eps are unused: the rigid families'
// signature).  Evaluates num_groups * n_fit hypotheses (< 2^32) in chunks of
// at most `chunk` and enqueues 2 + 2 ceil(num_hyp / chunk) operations on
// `stream`; returns the first CUDA error, 0 on success.
extern "C" int fused_sweep_crosswire_launch(
    const float* coords, long long coords_stride, const float* p, long long p_stride,
    int vote_cols, int n_fit, long long num_groups, int b, int m, unsigned mask, float delta,
    float delta_sq, float cross_eps, unsigned long long* best_key, float* best_out,
    long long* best_index, float* workspace, int chunk, void* stream) {
  return launch_chunks<Crosswire>(crosswire_fit_kernel, crosswire_vote_kernel, coords,
                                  coords_stride, p, p_stride, vote_cols, n_fit, num_groups, b, m,
                                  mask, delta, delta_sq, cross_eps, best_key, best_out,
                                  best_index, workspace, chunk, stream);
}

extern "C" int fused_sweep_pointer_launch(
    const float* coords, long long coords_stride, const float* p, long long p_stride,
    int vote_cols, int n_fit, long long num_groups, int b, int m, unsigned mask, float delta,
    float delta_sq, float cross_eps, unsigned long long* best_key, float* best_out,
    long long* best_index, float* workspace, int chunk, void* stream) {
  return launch_chunks<Pointer>(pointer_fit_kernel, pointer_vote_kernel, coords, coords_stride,
                                p, p_stride, vote_cols, n_fit, num_groups, b, m, mask, delta,
                                delta_sq, cross_eps, best_key, best_out, best_index, workspace,
                                chunk, stream);
}

// The launch shapes at num_hyp hypotheses (one chunk) on the current device,
// of each family's vote kernel (<family>_shape) and fit kernel
// (<family>_fit_shape), as lsq_sweep::kernel_shape gives them.
extern "C" int fused_sweep_crosswire_shape(int num_hyp, int* out) {
  return lsq_sweep::kernel_shape(crosswire_vote_kernel, lsq_sweep::kSplitThreads,
                                 lsq_sweep::kSplitHypPerBlock, num_hyp, out);
}

extern "C" int fused_sweep_crosswire_fit_shape(int num_hyp, int* out) {
  return lsq_sweep::kernel_shape(crosswire_fit_kernel, kFitThreads, kFitThreads, num_hyp, out);
}

extern "C" int fused_sweep_pointer_shape(int num_hyp, int* out) {
  return lsq_sweep::kernel_shape(pointer_vote_kernel, lsq_sweep::kSplitThreads,
                                 lsq_sweep::kSplitHypPerBlock, num_hyp, out);
}

extern "C" int fused_sweep_pointer_fit_shape(int num_hyp, int* out) {
  return lsq_sweep::kernel_shape(pointer_fit_kernel, kFitThreads, kFitThreads, num_hyp, out);
}
