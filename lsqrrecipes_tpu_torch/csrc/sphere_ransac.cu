// Per-step sphere RANSAC kernels, hand-written for Hopper (sm_90a): one
// thread per hypothesis fits a circumsphere and votes it against every point;
// the argmax over the hypotheses stays outside, as in the TPU package.
//
// Replaces lsqrrecipes_tpu/ops/sphere_ransac.py::_make_megakernel (the
// pallas_call in _megakernel_call) by sphere_mega_launch, the per-step sweep:
//   * hypothesis h = g * n + i (g < num_groups) takes for slot j the column
//     shifts[g, j] + i of rows 3j..3j+2 of the doubled slot planes
//     coords2[12, 2n] (four permutations, each written twice);
//   * the Cramer circumsphere in the TPU kernel's operation order
//     (sphere_fit.cuh), so params_t is bit-equal to the plain version's;
//   * the K = 5 affine band vote |e| < 1, e = w |p - c|^2 + o expanded as
//     e = a0 x + a1 y + a2 z + a3 + a4 |p|^2 with A = [w(-2c), w|c|^2 + o, w]
//     (w = 0, o = 2 on degenerate lanes), summed left to right from separate
//     multiplies and adds, on the valid columns of points_t.
//
// Replaces lsqrrecipes_tpu/ops/sphere_ransac.py::_fused_kernel (the
// pallas_call in sphere_fit_and_vote_planar) by sphere_planar_vote_launch,
// the planar fit-and-vote on given samples:
//   * hypothesis h takes slot j, coordinate c from row 4c + j of sxyz[12, B];
//   * the same circumsphere;
//   * its own predicate, two K = 4 bounds closed at the lower edge:
//     s = -2cx x - 2cy y - 2cz z, e_hi = s + (|c|^2 - hi + 1e30 degenerate),
//     e_lo = s + (|c|^2 - lo); agree iff e_hi + |p|^2 < 0 and
//     e_lo + |p|^2 >= 0, hi = (r + delta)^2, lo = max(r - delta, 0)^2.
//
// Both write counts int32[B] and params_t f32[8, B] = [cx, cy, cz, r,
// degenerate, 0, 0, 0].  Invalid columns (valid == 0) are staged as NaN, so
// no predicate holds there: the plain versions' "agree and valid".
//
// What bounds them on an H100: arithmetic.  A cell is four multiplies, four
// adds, a compare and an add (B7; 3 + 6 + 2 compares + and + add for B8), a
// fit ~115 operations; one step at 131,072 hypotheses x 1,024 columns is
// ~1.5e9 operations against ~6 MB of input and output.  So:
//   * the point columns are staged in 1,024-column shared-memory tiles as
//     float4 (x, y, z, |p|^2) and read as warp-wide broadcasts;
//   * each thread keeps the band of two hypotheses in registers, so each
//     staged column feeds two hypotheses, and 131,072 hypotheses make 256
//     blocks of 256 threads (about two per SM);
//   * the multiplies and adds stay separate (__f*_rn), which costs the FMA
//     rate but keeps the counts equal to the plain versions'.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sphere_fit.cuh"

namespace {

using lsq_sphere::band_rows;
using lsq_sphere::center_sq;
using lsq_sphere::circumsphere;
using lsq_sphere::Hypothesis;
using lsq_sphere::nan_max;

constexpr int kThreads = 256;
constexpr int kHypPerThread = 2;
constexpr int kHypPerBlock = kThreads * kHypPerThread;
constexpr int kTile = 1024;  // point columns per shared-memory tile

// Columns t0 .. t0 + len of points_t as (x, y, z, |p|^2); invalid ones NaN.
__device__ __forceinline__ void stage_tile(const float* __restrict__ points_t,
                                           const float* __restrict__ valid, int n_pad,
                                           int t0, int len, float4* tile) {
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const int col = t0 + i;
    const float x = points_t[col], y = points_t[n_pad + col], z = points_t[2 * n_pad + col];
    const float pp = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
    tile[i] = valid[col] != 0.f ? make_float4(x, y, z, pp)
                                : make_float4(NAN, NAN, NAN, NAN);
  }
}

__device__ __forceinline__ void write_params(const Hypothesis& s, unsigned h,
                                             unsigned num_hyp, float* __restrict__ params_t) {
  params_t[h] = s.cx;
  params_t[num_hyp + h] = s.cy;
  params_t[2 * static_cast<size_t>(num_hyp) + h] = s.cz;
  params_t[3 * static_cast<size_t>(num_hyp) + h] = s.r;
  params_t[4 * static_cast<size_t>(num_hyp) + h] = s.degenerate ? 1.f : 0.f;
#pragma unroll
  for (int row = 5; row < 8; ++row) params_t[row * static_cast<size_t>(num_hyp) + h] = 0.f;
}

__global__ void __launch_bounds__(kThreads)
sphere_mega_kernel(const int* __restrict__ shifts, const float* __restrict__ coords2,
                   const float* __restrict__ points_t, const float* __restrict__ valid,
                   int n, int n_pad, unsigned num_hyp, float delta,
                   int* __restrict__ counts, float* __restrict__ params_t) {
  __shared__ float4 tile[kTile];
  const unsigned base = blockIdx.x * kHypPerBlock + threadIdx.x;
  const size_t stride = 2 * static_cast<size_t>(n);
  float a[kHypPerThread][5];
  int count[kHypPerThread];
#pragma unroll
  for (int k = 0; k < kHypPerThread; ++k) {
    const unsigned h = base + k * kThreads;
    count[k] = 0;
#pragma unroll
    for (int q = 0; q < 5; ++q) a[k][q] = 0.f;
    if (h < num_hyp) {
      const unsigned g = h / n, i = h % n;
      float p[4][3];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t col = static_cast<size_t>(__ldg(shifts + 4 * g + j)) + i;
#pragma unroll
        for (int c = 0; c < 3; ++c) p[j][c] = __ldg(coords2 + (3 * j + c) * stride + col);
      }
      const Hypothesis s = circumsphere(p);
      band_rows(s, delta, a[k]);
      write_params(s, h, num_hyp, params_t);
    }
  }

  for (int t0 = 0; t0 < n_pad; t0 += kTile) {
    const int len = min(kTile, n_pad - t0);
    __syncthreads();  // the previous tile is no longer read
    stage_tile(points_t, valid, n_pad, t0, len, tile);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < len; ++i) {
      const float4 q = tile[i];
#pragma unroll
      for (int k = 0; k < kHypPerThread; ++k) {
        float e = __fmul_rn(a[k][0], q.x);
        e = __fadd_rn(e, __fmul_rn(a[k][1], q.y));
        e = __fadd_rn(e, __fmul_rn(a[k][2], q.z));
        e = __fadd_rn(e, a[k][3]);
        e = __fadd_rn(e, __fmul_rn(a[k][4], q.w));
        count[k] += fabsf(e) < 1.f;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kHypPerThread; ++k) {
    const unsigned h = base + k * kThreads;
    if (h < num_hyp) counts[h] = count[k];
  }
}

__global__ void __launch_bounds__(kThreads)
sphere_planar_vote_kernel(const float* __restrict__ sxyz, const float* __restrict__ points_t,
                          const float* __restrict__ valid, unsigned num_hyp, int n_pad,
                          float delta, int* __restrict__ counts,
                          float* __restrict__ params_t) {
  __shared__ float4 tile[kTile];
  const unsigned base = blockIdx.x * kHypPerBlock + threadIdx.x;
  // Per hypothesis: -2c (3), |c|^2 - hi + 1e30 degenerate, |c|^2 - lo.
  float a[kHypPerThread][5];
  int count[kHypPerThread];
#pragma unroll
  for (int k = 0; k < kHypPerThread; ++k) {
    const unsigned h = base + k * kThreads;
    count[k] = 0;
#pragma unroll
    for (int q = 0; q < 5; ++q) a[k][q] = 0.f;
    if (h < num_hyp) {
      float p[4][3];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          p[j][c] = __ldg(sxyz + (4 * c + j) * static_cast<size_t>(num_hyp) + h);
        }
      }
      const Hypothesis s = circumsphere(p);
      const float cc = center_sq(s);
      const float rp = __fadd_rn(s.r, delta);
      const float hi = __fmul_rn(rp, rp);
      const float lo_root = nan_max(__fsub_rn(s.r, delta), 0.f);
      const float lo = __fmul_rn(lo_root, lo_root);
      a[k][0] = __fmul_rn(-2.f, s.cx);
      a[k][1] = __fmul_rn(-2.f, s.cy);
      a[k][2] = __fmul_rn(-2.f, s.cz);
      a[k][3] = __fadd_rn(__fsub_rn(cc, hi), s.degenerate ? 1e30f : 0.f);
      a[k][4] = __fsub_rn(cc, lo);
      write_params(s, h, num_hyp, params_t);
    }
  }

  for (int t0 = 0; t0 < n_pad; t0 += kTile) {
    const int len = min(kTile, n_pad - t0);
    __syncthreads();  // the previous tile is no longer read
    stage_tile(points_t, valid, n_pad, t0, len, tile);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < len; ++i) {
      const float4 q = tile[i];
#pragma unroll
      for (int k = 0; k < kHypPerThread; ++k) {
        float s = __fadd_rn(__fmul_rn(a[k][0], q.x), __fmul_rn(a[k][1], q.y));
        s = __fadd_rn(s, __fmul_rn(a[k][2], q.z));
        const float e_hi = __fadd_rn(__fadd_rn(s, a[k][3]), q.w);
        const float e_lo = __fadd_rn(__fadd_rn(s, a[k][4]), q.w);
        count[k] += (e_hi < 0.f) & (e_lo >= 0.f);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kHypPerThread; ++k) {
    const unsigned h = base + k * kThreads;
    if (h < num_hyp) counts[h] = count[k];
  }
}

unsigned blocks_for(unsigned long long num_hyp) {
  return static_cast<unsigned>((num_hyp + kHypPerBlock - 1) / kHypPerBlock);
}

}  // namespace

extern "C" const char* lsq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// shifts i32[num_groups, 4] (each in [0, n]), coords2 f32[12, 2n], points_t
// f32[3, n_pad], valid f32[1, n_pad], counts i32[num_groups n], params_t
// f32[8, num_groups n]; all contiguous on the current device, num_groups n
// < 2^31.  Enqueues on `stream` and returns cudaGetLastError().
extern "C" int sphere_mega_launch(const int* shifts, const float* coords2,
                                  const float* points_t, const float* valid, int n, int n_pad,
                                  int num_groups, float delta, int* counts, float* params_t,
                                  void* stream) {
  const unsigned long long num_hyp = static_cast<unsigned long long>(num_groups) * n;
  if (n <= 0 || num_groups <= 0 || n_pad <= 0 || num_hyp >= (1ull << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sphere_mega_kernel<<<blocks_for(num_hyp), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      shifts, coords2, points_t, valid, n, n_pad, static_cast<unsigned>(num_hyp), delta,
      counts, params_t);
  return static_cast<int>(cudaGetLastError());
}

// sxyz f32[12, num_hyp] (rows x0..x3, y0..y3, z0..z3), points_t f32[3, n_pad],
// valid f32[1, n_pad], counts i32[num_hyp], params_t f32[8, num_hyp]; all
// contiguous on the current device.  Enqueues on `stream` and returns
// cudaGetLastError().
extern "C" int sphere_planar_vote_launch(const float* sxyz, const float* points_t,
                                         const float* valid, int num_hyp, int n_pad,
                                         float delta, int* counts, float* params_t,
                                         void* stream) {
  if (num_hyp <= 0 || n_pad <= 0) return static_cast<int>(cudaErrorInvalidValue);
  sphere_planar_vote_kernel<<<blocks_for(num_hyp), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      sxyz, points_t, valid, static_cast<unsigned>(num_hyp), n_pad, delta, counts, params_t);
  return static_cast<int>(cudaGetLastError());
}
