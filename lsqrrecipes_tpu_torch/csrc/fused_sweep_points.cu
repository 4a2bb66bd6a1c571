// Whole-sweep RANSAC for planes, 3D lines and 2D lines, hand-written for
// Hopper (sm_90a).
//
// Replaces lsqrrecipes_tpu/ops/fused_sweep.py::_make_kernel with the
// plane3d_fit_vote, line3d_fit_vote and line2d_fit_vote closures (the
// pallas_call in _sweep_call): one __global__ template (sweep_common.cuh)
// instantiated per family, with one C launch symbol each.  Each family
// computes what its closure computes:
//   * plane3d: cross-product normal of (s1 - s0) x (s2 - s0), degenerate when
//     its squared norm is below 1e-20; n normalised by 1/sqrt; vote
//     |P^T A| < 1 on rows [x, y, z, 1, guard] with A = [w n, o, w],
//     w = 1/delta, o = -(n.s0)/delta; params [n, s0];
//   * line2d: n = (dy, -dx)/|d| for d = p1 - p0, degenerate when |d|^2 <
//     delta^2; vote |P^T A| < 1 on rows [x, y, 1, guard], A = [w n, o, w];
//     params [nx, ny, x0, y0];
//   * line3d: u = (a - p1)/|a - p1| through a = p0, degenerate when
//     |a - p1|^2 < delta^2; vote |v|^2 - (u.v)^2 < delta^2 with v = p - a;
//     params [u, a].
// The fits use __f*_rn intrinsics in the closures' operation order (nothing
// is contracted into an FMA) and compute lax.rsqrt as 1/sqrt in two
// correctly rounded steps, so the winner's parameters are bit for bit those
// of the plain PyTorch version (ops/fused_sweep.py).
//
// The line3d vote.  The TPU closure forms e1 = u.p - u.a and e2 = |p|^2 -
// 2 a.p + |a|^2 as two K = 5 products on the matrix unit (a 3-pass bf16
// split, because the MXU multiplies in bf16) and counts e2 - e1^2 < delta^2.
// Here both are formed from v = p - a per cell on the FP32 pipes: the
// |p|^2 and |a|^2 terms of 1e3-1e4 that cancel in e2 never appear, so e2
// is exact to f32 rounding of |v|^2 itself, and it takes fewer operations
// (17 against 20 per cell).  Its multiplies and adds are kept apart, so the
// plain version repeats it exactly; padding columns (row 3 of P is 0) are
// staged as NaN and never count.
//
// What bounds it on an H100: arithmetic.  Per (hypothesis, column) cell the
// vote is, counted from the loops below, plane3d one multiply + four FMAs +
// compare + add (11 f32 operations, an FMA counting 2), line2d one multiply
// + three FMAs + compare + add (9), line3d 3 subtracts, 7 multiplies, 5
// adds/subtracts, compare and add (17); the fit is a few dozen operations per
// hypothesis.  At 4,096 groups x 1,024 lanes x 1,024 columns that is
// 3.8e10-7.3e10 operations against < 1 MB of input, so the bound is
// 0.6-1.1 ms at 67 TFLOP/s and the bytes (at 3.35 TB/s) are negligible.
// The design keeps every cell on the FP32 pipes (the depth-4/5 band product
// has no use for tensor cores, and TF32 would move the band edges), keeps
// four hypotheses' band rows per thread in registers so that one staged
// column feeds four hypotheses, stages P in 1,024-column tiles in shared
// memory read as broadcasts, and writes nothing per hypothesis to device
// memory.

#include "sweep_common.cuh"

namespace {

using lsq_sweep::Consts;
using lsq_sweep::kTile;
using lsq_sweep::rsqrt_rn;

constexpr float kNorm2Eps = 1e-20f;  // f32 collinearity gate of plane3d

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ float add3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, b), c);
}

// Band rows [w n, o, w] of |(n.p - d_off) / delta| < 1; a degenerate lane
// gets w = 0, o = 2 (it never agrees; its count is zeroed anyway).
template <int D>
__device__ __forceinline__ void signed_band(const float n[D], float d_off, bool degenerate,
                                            float inv_delta, float a[D + 2]) {
  const float w = degenerate ? 0.f : inv_delta;
  const float o = degenerate ? 2.f : mul(-d_off, inv_delta);
#pragma unroll
  for (int c = 0; c < D; ++c) a[c] = mul(w, n[c]);
  a[D] = o;
  a[D + 1] = w;
}

struct Plane3D {
  static constexpr int kSlots = 3, kDim = 3, kParams = 6, kTileRows = 5;
  struct Fit {
    float n[3], s0[3];
    bool degenerate;
  };
  struct Band {
    float a[5];
  };

  static __device__ __forceinline__ Fit fit(const float s[3][3], const Consts&) {
    float v1[3], v2[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v1[c] = __fsub_rn(s[1][c], s[0][c]);
      v2[c] = __fsub_rn(s[2][c], s[0][c]);
    }
    const float nx = __fsub_rn(mul(v1[1], v2[2]), mul(v1[2], v2[1]));
    const float ny = __fsub_rn(mul(v1[2], v2[0]), mul(v1[0], v2[2]));
    const float nz = __fsub_rn(mul(v1[0], v2[1]), mul(v1[1], v2[0]));
    const float norm2 = add3(mul(nx, nx), mul(ny, ny), mul(nz, nz));
    Fit f;
    f.degenerate = norm2 < kNorm2Eps;
    const float inv = rsqrt_rn(f.degenerate ? 1.f : norm2);
    f.n[0] = mul(nx, inv);
    f.n[1] = mul(ny, inv);
    f.n[2] = mul(nz, inv);
#pragma unroll
    for (int c = 0; c < 3; ++c) f.s0[c] = s[0][c];
    return f;
  }

  static __device__ __forceinline__ Band band(const Fit& f, const Consts& k) {
    const float d_off = add3(mul(f.n[0], f.s0[0]), mul(f.n[1], f.s0[1]), mul(f.n[2], f.s0[2]));
    Band b;
    signed_band<3>(f.n, d_off, f.degenerate, k.inv_delta, b.a);
    return b;
  }

  static __device__ __forceinline__ void stage(const float* __restrict__ p, long long stride,
                                               int col, float (*tile)[kTile], int i) {
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) tile[r][i] = p[r * stride + col];
  }

  static __device__ __forceinline__ int vote(const Band& b, float (*tile)[kTile], int i) {
    const float e = fmaf(tile[4][i], b.a[4], fmaf(tile[3][i], b.a[3],
                    fmaf(tile[2][i], b.a[2], fmaf(tile[1][i], b.a[1], tile[0][i] * b.a[0]))));
    return fabsf(e) < 1.f;
  }

  static __device__ __forceinline__ void params(const Fit& f, float* out) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[c] = f.n[c];
      out[3 + c] = f.s0[c];
    }
  }
};

struct Line2D {
  static constexpr int kSlots = 2, kDim = 2, kParams = 4, kTileRows = 4;
  struct Fit {
    float n[2], x0, y0;
    bool degenerate;
  };
  struct Band {
    float a[4];
  };

  static __device__ __forceinline__ Fit fit(const float s[2][2], const Consts& k) {
    const float dx = __fsub_rn(s[1][0], s[0][0]);
    const float dy = __fsub_rn(s[1][1], s[0][1]);
    const float dist2 = __fadd_rn(mul(dx, dx), mul(dy, dy));
    Fit f;
    f.degenerate = dist2 < k.delta_sq;
    const float inv = rsqrt_rn(f.degenerate ? 1.f : dist2);
    f.n[0] = mul(dy, inv);
    f.n[1] = mul(-dx, inv);
    f.x0 = s[0][0];
    f.y0 = s[0][1];
    return f;
  }

  static __device__ __forceinline__ Band band(const Fit& f, const Consts& k) {
    const float d_off = __fadd_rn(mul(f.n[0], f.x0), mul(f.n[1], f.y0));
    Band b;
    signed_band<2>(f.n, d_off, f.degenerate, k.inv_delta, b.a);
    return b;
  }

  static __device__ __forceinline__ void stage(const float* __restrict__ p, long long stride,
                                               int col, float (*tile)[kTile], int i) {
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) tile[r][i] = p[r * stride + col];
  }

  static __device__ __forceinline__ int vote(const Band& b, float (*tile)[kTile], int i) {
    const float e = fmaf(tile[3][i], b.a[3], fmaf(tile[2][i], b.a[2],
                    fmaf(tile[1][i], b.a[1], tile[0][i] * b.a[0])));
    return fabsf(e) < 1.f;
  }

  static __device__ __forceinline__ void params(const Fit& f, float* out) {
    out[0] = f.n[0];
    out[1] = f.n[1];
    out[2] = f.x0;
    out[3] = f.y0;
  }
};

struct Line3D {
  static constexpr int kSlots = 2, kDim = 3, kParams = 6, kTileRows = 3;
  struct Fit {
    float u[3], a[3];
    bool degenerate;
  };
  struct Band {
    float u[3], a[3], delta_sq;
  };

  static __device__ __forceinline__ Fit fit(const float s[2][3], const Consts& k) {
    float d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) d[c] = __fsub_rn(s[0][c], s[1][c]);
    const float dist2 = add3(mul(d[0], d[0]), mul(d[1], d[1]), mul(d[2], d[2]));
    Fit f;
    f.degenerate = dist2 < k.delta_sq;
    const float inv = rsqrt_rn(f.degenerate ? 1.f : dist2);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      f.u[c] = mul(d[c], inv);
      f.a[c] = s[0][c];
    }
    return f;
  }

  static __device__ __forceinline__ Band band(const Fit& f, const Consts& k) {
    Band b;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      b.u[c] = f.u[c];
      b.a[c] = f.a[c];
    }
    b.delta_sq = k.delta_sq;
    return b;
  }

  // Rows x, y, z; a padding column (row 3, the ones row, is 0) is staged
  // with x = NaN, so every cell of it compares false.
  static __device__ __forceinline__ void stage(const float* __restrict__ p, long long stride,
                                               int col, float (*tile)[kTile], int i) {
    const bool live = p[3 * stride + col] != 0.f;
    tile[0][i] = live ? p[col] : __int_as_float(0x7fffffff);
    tile[1][i] = p[stride + col];
    tile[2][i] = p[2 * stride + col];
  }

  static __device__ __forceinline__ int vote(const Band& b, float (*tile)[kTile], int i) {
    const float v0 = __fsub_rn(tile[0][i], b.a[0]);
    const float v1 = __fsub_rn(tile[1][i], b.a[1]);
    const float v2 = __fsub_rn(tile[2][i], b.a[2]);
    const float e1 = add3(mul(b.u[0], v0), mul(b.u[1], v1), mul(b.u[2], v2));
    const float e2 = add3(mul(v0, v0), mul(v1, v1), mul(v2, v2));
    return __fsub_rn(e2, mul(e1, e1)) < b.delta_sq;
  }

  static __device__ __forceinline__ void params(const Fit& f, float* out) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[c] = f.u[c];
      out[3 + c] = f.a[c];
    }
  }
};

}  // namespace

extern "C" const char* lsq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launch symbol: coords f32[kSlots * kDim, coords_stride] (coords_stride
// = 5 n_fit), p f32[kDim + 2, p_stride], best_key u64[1] (scratch), best_out
// f32[kParams + 1], best_index i64[1]; all contiguous on the current device.
// Evaluates num_groups * n_fit hypotheses (< 2^32) and enqueues three
// operations on `stream`; returns the first CUDA error, 0 on success.
extern "C" int fused_sweep_plane3d_launch(
    const float* coords, long long coords_stride, const float* p, long long p_stride,
    int vote_cols, int n_fit, long long num_groups, int b, int m, unsigned mask,
    float inv_delta, float delta_sq, unsigned long long* best_key, float* best_out,
    long long* best_index, void* stream) {
  return lsq_sweep::launch_sweep<Plane3D>(coords, coords_stride, p, p_stride, vote_cols, n_fit,
                                          num_groups, b, m, mask, Consts{inv_delta, delta_sq},
                                          best_key, best_out, best_index, stream);
}

extern "C" int fused_sweep_line3d_launch(
    const float* coords, long long coords_stride, const float* p, long long p_stride,
    int vote_cols, int n_fit, long long num_groups, int b, int m, unsigned mask,
    float inv_delta, float delta_sq, unsigned long long* best_key, float* best_out,
    long long* best_index, void* stream) {
  return lsq_sweep::launch_sweep<Line3D>(coords, coords_stride, p, p_stride, vote_cols, n_fit,
                                         num_groups, b, m, mask, Consts{inv_delta, delta_sq},
                                         best_key, best_out, best_index, stream);
}

extern "C" int fused_sweep_line2d_launch(
    const float* coords, long long coords_stride, const float* p, long long p_stride,
    int vote_cols, int n_fit, long long num_groups, int b, int m, unsigned mask,
    float inv_delta, float delta_sq, unsigned long long* best_key, float* best_out,
    long long* best_index, void* stream) {
  return lsq_sweep::launch_sweep<Line2D>(coords, coords_stride, p, p_stride, vote_cols, n_fit,
                                         num_groups, b, m, mask, Consts{inv_delta, delta_sq},
                                         best_key, best_out, best_index, stream);
}
