// Whole-sweep RANSAC for the crosswire-phantom and calibrated-pointer
// ultrasound probe calibrations, hand-written for Hopper (sm_90a).
//
// Replaces lsqrrecipes_tpu/ops/fused_sweep.py::_make_kernel with the
// crosswire_fit_vote and pointer_fit_vote closures (the pallas_call in
// _sweep_call): one __global__ template (sweep_common.cuh) instantiated per
// family, with one C launch symbol each.  Each family computes what its
// closure computes, in the operation order of the plain versions
// (ops/fused_sweep.py crosswire_fit / pointer_fit, which call
// linalg/small.py qr_solve_lanes and ops/us_fast.py orthonormalize_lanes):
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
// determinant fails its gate.  Every product, sum, square root and division
// is its own __f*_rn operation (nothing is contracted into an FMA), so the
// winner's parameters are bit for bit those of the plain versions.
//
// The votes.  The TPU closures vote through _dot_f32x3: three bf16 passes of
// K = 16 (crosswire) and K = 8 (pointer) products on the matrix unit, in
// 512-column chunks to stay inside VMEM.  On the FP32 pipes neither reason
// holds, so every cell is computed in plain, unfused f32 from staged rows,
// using R2's orthogonality, |R2 img + t2 - t1|^2 = |img + R2^T t2 - R2^T t1|^2:
//   * crosswire: e_j = (((u c1_j + v c2_j) + t3_j) + (R2^T t2)_j)
//     - (R2 col j).t1, |e|^2 < delta^2 over the staged rows
//     [u, v, R2^T t2 3, vec(R2) 9] (3 x (5 mul + 5 add/sub) + 3 mul + 2 add
//     + compare + count = 37 f32 operations, about 40 with the indexing);
//   * pointer: e_j = ((u c1_j + v c2_j) + t3_j) - w_j with w = R2^T (p - t2),
//     over [u, v, w 3] (3 x (2 mul + 3 add/sub) + 5 + 2 = 22 operations).
// Padding columns (the ones row of P is 0) are staged with a NaN in u, so
// every comparison of theirs is false; the plain versions mask them.
//
// What bounds it on an H100: arithmetic.  At the JAX family record's width
// (1,024 groups x 1,024 lanes x 1,024 observations) the votes are 4.2e10
// (crosswire) and 2.3e10 (pointer) f32 operations and the fits about
// 3,900 and 2,100 operations per hypothesis (4.1e9 and 2.2e9), against
// < 2 MB of input: 0.70 and 0.38 ms at 67 TFLOP/s.  The design is the other
// sweeps': every cell on the FP32 pipes, several hypotheses' vote rows per
// thread in registers so that one staged column feeds them all, P staged in
// shared memory and read as broadcasts, nothing per hypothesis written to
// device memory.  The fits are unrolled into registers (the 12 x 12 QR
// holds about 170 floats), so crosswire fits two hypotheses per thread, not
// four, and its 14 staged rows take 512-column tiles (28 KB) to stay under
// the 48 KB static shared-memory limit; pointer fits four and stages 5 rows
// in 1,024-column tiles.

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
  static constexpr int kSlots = 4, kDim = 14, kParams = 15, kTileRows = 14, kTileCols = 512,
                       kHypPerThread = 2;
  struct Fit {
    float t1[3], t3[3], c1[3], c2[3], c3[3];
    bool degenerate;
  };
  struct Band {
    float t1[3], t3[3], c1[3], c2[3], delta_sq;
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

  static __device__ __forceinline__ Band band(const Fit& f, const Consts& k) {
    Band b;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      b.t1[i] = f.t1[i];
      b.t3[i] = f.t3[i];
      b.c1[i] = f.c1[i];
      b.c2[i] = f.c2[i];
    }
    b.delta_sq = k.delta_sq;
    return b;
  }

  // P rows: u 0, v 1, ones 2, R2^T t2 3-5, vec(R2) 6-14, guard 15.  Tile
  // rows: u 0 (NaN on padding columns), v 1, R2^T t2 2-4, vec(R2) 5-13.
  static __device__ __forceinline__ void stage(const float* __restrict__ p, long long stride,
                                               int col, float (*tile)[kTileCols], int i) {
    tile[0][i] = live_or_nan(p, stride, col, 0, 2);
    tile[1][i] = p[stride + col];
#pragma unroll
    for (int r = 2; r < kTileRows; ++r) tile[r][i] = p[(r + 1) * stride + col];
  }

  static __device__ __forceinline__ int vote(const Band& b, float (*tile)[kTileCols], int i) {
    const float u = tile[0][i], v = tile[1][i];
    float e[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float img = add(add(add(mul(u, b.c1[j]), mul(v, b.c2[j])), b.t3[j]), tile[2 + j][i]);
      // R2 col j . t1, with R2[k][j] at tile row 5 + 3k + j.
      const float rt1 = add3(mul(tile[5 + j][i], b.t1[0]), mul(tile[8 + j][i], b.t1[1]),
                             mul(tile[11 + j][i], b.t1[2]));
      e[j] = sub(img, rt1);
    }
    return add3(mul(e[0], e[0]), mul(e[1], e[1]), mul(e[2], e[2])) < b.delta_sq;
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
};

struct Pointer {
  static constexpr int kSlots = 3, kDim = 17, kParams = 12, kTileRows = 5;
  struct Fit {
    float t3[3], c1[3], c2[3], c3[3];
    bool degenerate;
  };
  struct Band {
    float t3[3], c1[3], c2[3], delta_sq;
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

  static __device__ __forceinline__ Band band(const Fit& f, const Consts& k) {
    Band b;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      b.t3[i] = f.t3[i];
      b.c1[i] = f.c1[i];
      b.c2[i] = f.c2[i];
    }
    b.delta_sq = k.delta_sq;
    return b;
  }

  // P rows: u 0, v 1, ones 2, w 3-5, guard 6.  Tile rows: u 0 (NaN on
  // padding columns), v 1, w 2-4.
  static __device__ __forceinline__ void stage(const float* __restrict__ p, long long stride,
                                               int col, float (*tile)[lsq_sweep::kTile], int i) {
    tile[0][i] = live_or_nan(p, stride, col, 0, 2);
    tile[1][i] = p[stride + col];
#pragma unroll
    for (int r = 2; r < kTileRows; ++r) tile[r][i] = p[(r + 1) * stride + col];
  }

  static __device__ __forceinline__ int vote(const Band& b, float (*tile)[lsq_sweep::kTile],
                                             int i) {
    const float u = tile[0][i], v = tile[1][i];
    float e[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      e[j] = sub(add(add(mul(u, b.c1[j]), mul(v, b.c2[j])), b.t3[j]), tile[2 + j][i]);
    }
    return add3(mul(e[0], e[0]), mul(e[1], e[1]), mul(e[2], e[2])) < b.delta_sq;
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
};

template <class F>
int launch(const float* coords, long long coords_stride, const float* p, long long p_stride,
           int vote_cols, int n_fit, long long num_groups, int b, int m, unsigned mask,
           float delta, float delta_sq, float cross_eps, unsigned long long* best_key,
           float* best_out, long long* best_index, void* stream) {
  return lsq_sweep::launch_sweep<F>(coords, coords_stride, p, p_stride, vote_cols, n_fit,
                                    num_groups, b, m, mask,
                                    Consts{0.f, delta_sq, delta, cross_eps}, best_key,
                                    best_out, best_index, stream);
}

}  // namespace

extern "C" const char* lsq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launch symbol: coords f32[kSlots * kDim, coords_stride] (coords_stride
// = 5 n_fit), p f32[16 (crosswire) or 7 (pointer), p_stride], best_key u64[1]
// (scratch), best_out f32[kParams + 1], best_index i64[1]; all contiguous on
// the current device.  delta_sq is f32 (delta and cross_eps are unused: the
// rigid families' signature).  Evaluates num_groups * n_fit hypotheses
// (< 2^32) and enqueues three operations on `stream`; returns the first CUDA
// error, 0 on success.
extern "C" int fused_sweep_crosswire_launch(
    const float* coords, long long coords_stride, const float* p, long long p_stride,
    int vote_cols, int n_fit, long long num_groups, int b, int m, unsigned mask, float delta,
    float delta_sq, float cross_eps, unsigned long long* best_key, float* best_out,
    long long* best_index, void* stream) {
  return launch<Crosswire>(coords, coords_stride, p, p_stride, vote_cols, n_fit, num_groups, b,
                           m, mask, delta, delta_sq, cross_eps, best_key, best_out, best_index,
                           stream);
}

extern "C" int fused_sweep_pointer_launch(
    const float* coords, long long coords_stride, const float* p, long long p_stride,
    int vote_cols, int n_fit, long long num_groups, int b, int m, unsigned mask, float delta,
    float delta_sq, float cross_eps, unsigned long long* best_key, float* best_out,
    long long* best_index, void* stream) {
  return launch<Pointer>(coords, coords_stride, p, p_stride, vote_cols, n_fit, num_groups, b, m,
                         mask, delta, delta_sq, cross_eps, best_key, best_out, best_index, stream);
}
