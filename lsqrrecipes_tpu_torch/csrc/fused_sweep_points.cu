// Whole-sweep RANSAC for planes, 3D lines and 2D lines, hand-written for
// Hopper (sm_90a).
//
// Replaces lsqrrecipes_tpu/ops/fused_sweep.py::_make_kernel with the
// plane3d_fit_vote, line3d_fit_vote and line2d_fit_vote closures (the
// pallas_call in _sweep_call), with one C launch symbol each: plane3d and
// line2d instantiate the __global__ template of sweep_common.cuh, line3d has
// a kernel of its own in the header's split-vote layout.  Each family
// computes what its closure computes:
//   * plane3d: cross-product normal of (s1 - s0) x (s2 - s0), degenerate when
//     its squared norm is below 1e-20; n normalised by 1/sqrt; vote
//     |P^T A| < 1 on rows [x, y, z, 1, guard] with A = [w n, o, w],
//     w = 1/delta, o = -(n.s0)/delta; params [n, s0];
//   * line2d: n = (dy, -dx)/|d| for d = p1 - p0, degenerate when |d|^2 <
//     delta^2; vote |P^T A| < 1 on rows [x, y, 1, guard], A = [w n, o, w];
//     params [nx, ny, x0, y0];
//   * line3d: u = (a - p1)/|a - p1| through a = p0, degenerate when
//     |a - p1|^2 < delta^2; vote |p - a|^2 - (u.(p - a))^2 < delta^2 on
//     rows [x, y, z, 1] relative to column 0; params [u, a].
// The fits use __f*_rn intrinsics in the closures' operation order (nothing
// is contracted into an FMA) and compute lax.rsqrt as 1/sqrt in two
// correctly rounded steps, so the winner's parameters are bit for bit those
// of the plain PyTorch version (ops/fused_sweep.py).
//
// The line3d vote.  The TPU closure forms e1 = u.p - u.a and e2 = |p|^2 -
// 2 a.p + |a|^2 as two K = 5 products on the matrix unit (a 3-pass bf16
// split, because the MXU multiplies in bf16) and counts e2 - e1^2 < delta^2.
// Here the same expansion is seven FMAs per cell on the FP32 pipes (see
// line3d_kernel), |a|^2 moved to the threshold, about the centre c = P's
// column 0 instead of the origin.  Expanded about the origin, the |p|^2 and
// |a|^2 terms cancel and dist^2 carries an absolute error of about
// ulp(|p|^2): against delta^2 = 1 that miscounted three quarters of the
// hypotheses of a cloud 1e3 from the origin, by up to 111 points.  About c the terms scale
// with the cloud's extent (~5e3 at the test clouds' 80 units, an error of
// ~1e-3), wherever the cloud lies.  On an H100 80GB HBM3 at 700 W
// (chip_smoke.py, uncentred) it took 1.57-1.58 ms at 4,096 groups x 1,024
// lanes x 1,024 columns, where v = p - a with five FMAs (timed from an edited
// copy of this source) took 1.97 ms and the earlier sweep_kernel layout
// without FMAs 2.72 ms.  The plain version
// centres and rounds each FMA as CUDA does, so the two count alike.
//
// What bounds it on an H100: arithmetic.  Per (hypothesis, column) cell the
// vote is plane3d one multiply + four FMAs + compare + add (11 f32
// operations, an FMA counting 2), line2d one multiply + three FMAs +
// compare + add (9), line3d seven FMAs + compare + add (16); the fit and
// vote rows are a few dozen operations per hypothesis.  At 4,096 groups x
// 1,024 lanes x 1,024 columns that is 3.8e10-6.9e10 operations against < 1 MB
// of input, so the bound is 0.6-1.03 ms at 67 TFLOP/s and the bytes (at
// 3.35 TB/s) are negligible.
// The design keeps every cell on the FP32 pipes (the depth-4/5 band product
// has no use for tensor cores, and TF32 would move the band edges), keeps
// four hypotheses' vote rows per thread in registers so that one staged
// column feeds four hypotheses, stages P in tiles in shared memory read as
// broadcasts, and writes nothing per hypothesis to device memory.

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
  static constexpr int kSlots = 2, kDim = 3, kParams = 6;
  struct Fit {
    float u[3], a[3];
    bool degenerate;
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

  static __device__ __forceinline__ void params(const Fit& f, float* out) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[c] = f.u[c];
      out[3 + c] = f.a[c];
    }
  }
};

// The line3d sweep in the split-vote layout (sweep_common.cuh).  Points and
// anchors are taken relative to the centre c = P's column 0 (a live point),
// so the expansion's terms scale with the cloud's extent and not with its
// distance from the origin.  The first kSplitHypPerBlock threads fit one
// hypothesis each and leave its vote rows in shared memory; every thread then
// takes the rows of its four hypotheses.  With a' = a - c and p' = p - c,
// per cell: t = fma(m2, z', fma(m1, y', fma(m0, x', |p'|^2))) with m = -2a',
// e1 = fma(u2, z', fma(u1, y', fma(u0, x', -u.a'))), and the count where
// fma(-e1, e1, t) < delta^2 - |a'|^2: seven FMAs, a compare and a predicated
// add.  Points are staged 2,048 at a time as float4 [x', y', z', |p'|^2],
// |p'|^2 = (x' x' + y' y') + z' z'; a padding column (row 3, the ones row,
// is 0) is staged with x' = NaN, so every cell of it compares false.
constexpr int kLineRows = 8;     // m 3, u 3, -u.a', delta^2 - |a'|^2
constexpr int kLineTile = 2048;  // points per shared-memory tile: 32 KB
static_assert(lsq_sweep::kSplitWarps * lsq_sweep::kSplitHypPerBlock * sizeof(int) <=
                  kLineTile * sizeof(float4),
              "the partial counts reuse the tile");

__global__ void __launch_bounds__(lsq_sweep::kSplitThreads)
line3d_kernel(const float* __restrict__ coords, long long coords_stride,
              const float* __restrict__ p, long long p_stride, int vote_cols,
              unsigned n_fit, unsigned num_hyp, int b, int m, unsigned mask, Consts k,
              unsigned long long* __restrict__ best_key) {
  using namespace lsq_sweep;
  __shared__ float4 tile[kLineTile];
  __shared__ float rows[kLineRows][kSplitHypPerBlock];
  __shared__ bool counts_zero[kSplitHypPerBlock];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned h_first = blockIdx.x * kSplitHypPerBlock;
  const float cx = p[0], cy = p[p_stride], cz = p[2 * p_stride];
  if (threadIdx.x < kSplitHypPerBlock) {
    const unsigned h = h_first + threadIdx.x;
    float r[kLineRows] = {};  // a slot past the last hypothesis votes on zeros, unpublished
    bool zero = true;
    if (h < num_hyp) {
      const Line3D::Fit f =
          fit_hypothesis<Line3D>(coords, coords_stride, h, n_fit, b, m, mask, k);
      const float a[3] = {__fsub_rn(f.a[0], cx), __fsub_rn(f.a[1], cy), __fsub_rn(f.a[2], cz)};
      const float* u = f.u;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        r[c] = -2.f * a[c];  // exact
        r[3 + c] = u[c];
      }
      r[6] = -add3(mul(u[0], a[0]), mul(u[1], a[1]), mul(u[2], a[2]));
      r[7] = __fsub_rn(k.delta_sq, add3(mul(a[0], a[0]), mul(a[1], a[1]), mul(a[2], a[2])));
      zero = f.degenerate;
    }
#pragma unroll
    for (int i = 0; i < kLineRows; ++i) rows[i][threadIdx.x] = r[i];
    counts_zero[threadIdx.x] = zero;
  }
  __syncthreads();
  float mx[kSplitHypPerThread], my[kSplitHypPerThread], mz[kSplitHypPerThread];
  float ux[kSplitHypPerThread], uy[kSplitHypPerThread], uz[kSplitHypPerThread];
  float nua[kSplitHypPerThread], thr[kSplitHypPerThread];
  int count[kSplitHypPerThread];
#pragma unroll
  for (int q = 0; q < kSplitHypPerThread; ++q) {
    const int i = 32 * q + lane;
    mx[q] = rows[0][i];
    my[q] = rows[1][i];
    mz[q] = rows[2][i];
    ux[q] = rows[3][i];
    uy[q] = rows[4][i];
    uz[q] = rows[5][i];
    nua[q] = rows[6][i];
    thr[q] = rows[7][i];
    count[q] = 0;
  }

  for (int t0 = 0; t0 < vote_cols; t0 += kLineTile) {
    const int len = min(kLineTile, vote_cols - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < len; i += kSplitThreads) {
      const int col = t0 + i;
      const float x = __fsub_rn(p[col], cx);
      const float y = __fsub_rn(p[p_stride + col], cy);
      const float z = __fsub_rn(p[2 * p_stride + col], cz);
      const bool live = p[3 * p_stride + col] != 0.f;
      tile[i] = make_float4(live ? x : __int_as_float(0x7fffffff), y, z,
                            add3(mul(x, x), mul(y, y), mul(z, z)));
    }
    __syncthreads();
#pragma unroll 4
    for (int i = warp; i < len; i += kSplitWarps) {
      const float4 pt = tile[i];
#pragma unroll
      for (int q = 0; q < kSplitHypPerThread; ++q) {
        const float t =
            __fmaf_rn(mz[q], pt.z, __fmaf_rn(my[q], pt.y, __fmaf_rn(mx[q], pt.x, pt.w)));
        const float e1 =
            __fmaf_rn(uz[q], pt.z, __fmaf_rn(uy[q], pt.y, __fmaf_rn(ux[q], pt.x, nua[q])));
        count_below(count[q], __fmaf_rn(-e1, e1, t), thr[q]);
      }
    }
  }

  split_publish(count, reinterpret_cast<int*>(tile), counts_zero, h_first,
                num_hyp - h_first, best_key);
}

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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Consts k{inv_delta, delta_sq};
  return lsq_sweep::launch_with<Line3D>(
      coords, coords_stride, vote_cols, n_fit, num_groups, b, m, mask, k, best_key, best_out,
      best_index, s, [&](unsigned num_hyp) {
        line3d_kernel<<<lsq_sweep::ceil_div(num_hyp, lsq_sweep::kSplitHypPerBlock),
                        lsq_sweep::kSplitThreads, 0, s>>>(
            coords, coords_stride, p, p_stride, vote_cols, static_cast<unsigned>(n_fit), num_hyp,
            b, m, mask, k, best_key);
        return cudaGetLastError();
      });
}

// The line3d kernel's launch shape at num_hyp hypotheses on the current
// device, as lsq_sweep::kernel_shape gives it.
extern "C" int fused_sweep_line3d_shape(int num_hyp, int* out) {
  return lsq_sweep::kernel_shape(line3d_kernel, lsq_sweep::kSplitThreads,
                                 lsq_sweep::kSplitHypPerBlock, num_hyp, out);
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
