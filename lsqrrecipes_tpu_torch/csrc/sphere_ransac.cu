// Per-step sphere RANSAC kernels, hand-written for Hopper (sm_90a): each
// thread fits the circumspheres of its hypotheses and votes them against every
// point; the argmax over the hypotheses stays outside, as in the TPU package.
//
// Replaces lsqrrecipes_tpu/ops/sphere_ransac.py::_make_megakernel (the
// pallas_call in _megakernel_call) by sphere_mega_launch, the per-step sweep:
//   * hypothesis h = g * n + i (g < num_groups) takes for slot j the column
//     shifts[g, j] + i of rows 3j..3j+2 of the doubled slot planes
//     coords2[12, 2n] (four permutations, each written twice);
//   * the Cramer circumsphere in the TPU kernel's operation order
//     (sphere_fit.cuh), so params_t is bit-equal to the plain version's;
//   * the K = 5 affine band vote |e| < 1, e = w |p - c|^2 + o expanded as
//     e = a0 x' + a1 y' + a2 z' + a3 + a4 |p'|^2 with A = [w(-2c'), w|c'|^2 +
//     o, w] (w = 0, o = 2 on degenerate lanes), as four fused multiply-adds,
//     e = fma(a4, |p'|^2, fma(a2, z', fma(a1, y', fma(a0, x', a3)))), on the
//     valid columns of points_t (the TPU kernel's one K = 5 dot_general).
//
// Replaces lsqrrecipes_tpu/ops/sphere_ransac.py::_fused_kernel (the
// pallas_call in sphere_fit_and_vote_planar) by sphere_planar_vote_launch,
// the planar fit-and-vote on given samples:
//   * hypothesis h takes slot j, coordinate c from row 4c + j of sxyz[12, B];
//   * the same circumsphere;
//   * its own predicate, two bounds on one value closed at the lower edge:
//     t = fma(-2c'z, z', fma(-2c'y, y', fma(-2c'x, x', |p'|^2))), agree iff
//     t < -((|c'|^2 - hi) + 1e30 degenerate) and t >= -(|c'|^2 - lo),
//     hi = (r + delta)^2, lo = max(r - delta, 0)^2.  For finite values
//     fl(t + a) < 0 iff t < -a and fl(t + a) >= 0 iff t >= -a, so against the
//     TPU kernel's (s + a) + |p'|^2 with s = -2c'.p' unfused only the three
//     FMAs round otherwise.
//
// Both expand |p - c|^2 about o = points_t's column 0 (sphere_fit.cuh's
// vote_origin), p' = p - o and c' = c - o, where the TPU kernels expand it
// about the origin: 1e4 from the origin ulp(|p|^2) is 32, against a band of
// 40 at r = 10, delta = 1.  The fits are not centred.
//
// Both write counts int32[B] and params_t f32[8, B] = [cx, cy, cz, r,
// degenerate, 0, 0, 0].  Invalid columns (valid == 0) are staged as NaN, so
// no predicate holds there: the plain versions' "agree and valid".
//
// What bounds them on an H100: arithmetic.  A cell is four FMAs, an abs, a
// compare and an add (B7; three FMAs, two compares and an add for B8), a fit
// ~115 operations; one step at 131,072 hypotheses x 1,024 columns is ~1.5e9
// operations against ~6 MB of input and output.  So:
//   * the point columns are staged in 1,024-column shared-memory tiles as
//     float4 (x, y, z, |p|^2) and read as warp-wide broadcasts;
//   * B7 keeps the band of four hypotheses per thread in registers, so one
//     LDS.128 of a staged column feeds four cells of ~6 issue slots each
//     (4 FFMA, FSETP with |e|, the count's add), and 131,072 hypotheses make
//     128 blocks of 256 threads, one per SM (four SMs idle); its plain
//     version emulates each fmaf exactly (linalg.small.fma_f32), so the
//     counts stay equal.  On an H100 80GB HBM3 at 700 W a step took
//     0.048-0.052 ms of device time (0.049-0.074 ms by CUDA events around
//     back-to-back launches), against 0.065-0.066 ms with separate
//     multiplies and adds and two hypotheses per thread, and 0.053-0.056 ms
//     in 256 blocks of 128 threads;
//   * B8 takes the split-vote layout of B2 and the rigid sweeps
//     (sweep_common.cuh): a block owns 32 x 8 hypotheses, 8 per thread (4
//     was measured slower), every thread fits one and leaves its vote rows
//     in shared memory, every thread keeps the rows of its hypotheses
//     l + 32 k in registers, the 8 warps split the columns, and split_total
//     adds the warps' exact partial counts.  A cell is 3 FFMA, 2 FSETP and
//     one predicated add (count_in); its plain version rounds each FMA as
//     the card does, so the counts stay equal.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sphere_fit.cuh"
#include "sweep_common.cuh"

namespace {

using lsq_sphere::band_rows;
using lsq_sphere::centre_about;
using lsq_sphere::circumsphere;
using lsq_sphere::Hypothesis;
using lsq_sphere::nan_max;

constexpr int kThreads = 256;  // both kernels
constexpr int kWarps = kThreads / 32;
// B8: hypotheses per thread; the vote rows a hypothesis keeps, -2c' (3),
// -(|c'|^2 - hi + 1e30 degenerate) and -(|c'|^2 - lo); the resident blocks
// per SM it asks for.  4 blocks (one wave at 131,072 hypotheses) cap it at
// 64 registers and spill 40 bytes, and were measured slower than 3 at 80
// registers (PERF.md, scripts/time_layouts.py).
constexpr int kPlanarHypPerThread = 8;
constexpr int kPlanarHypPerBlock = 32 * kPlanarHypPerThread;
constexpr int kPlanarRows = 5;
constexpr int kPlanarMinBlocks = 3;
// B7: four hypotheses per thread.
constexpr int kMegaHypPerThread = 4;
constexpr int kMegaHypPerBlock = kThreads * kMegaHypPerThread;
constexpr int kTile = 1024;  // point columns per shared-memory tile

// Columns t0 .. t0 + len of points_t relative to o as (x', y', z', |p'|^2);
// invalid ones NaN.
__device__ __forceinline__ void stage_tile(const float* __restrict__ points_t,
                                           const float* __restrict__ valid, int n_pad,
                                           float3 o, int t0, int len, float4* tile) {
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const int col = t0 + i;
    tile[i] = valid[col] != 0.f ? lsq_sphere::centred_point(points_t, n_pad, col, o)
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
  const unsigned base = blockIdx.x * kMegaHypPerBlock + threadIdx.x;
  const size_t stride = 2 * static_cast<size_t>(n);
  const float3 o = lsq_sphere::vote_origin(points_t, n_pad, n_pad);
  float a[kMegaHypPerThread][5];
  int count[kMegaHypPerThread];
#pragma unroll
  for (int k = 0; k < kMegaHypPerThread; ++k) {
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
      band_rows(s, o, delta, a[k]);
      write_params(s, h, num_hyp, params_t);
    }
  }

  for (int t0 = 0; t0 < n_pad; t0 += kTile) {
    const int len = min(kTile, n_pad - t0);
    __syncthreads();  // the previous tile is no longer read
    stage_tile(points_t, valid, n_pad, o, t0, len, tile);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < len; ++i) {
      const float4 q = tile[i];
#pragma unroll
      for (int k = 0; k < kMegaHypPerThread; ++k) {
        const float e = __fmaf_rn(a[k][4], q.w, __fmaf_rn(a[k][2], q.z,
                        __fmaf_rn(a[k][1], q.y, __fmaf_rn(a[k][0], q.x, a[k][3]))));
        count[k] += fabsf(e) < 1.f;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMegaHypPerThread; ++k) {
    const unsigned h = base + k * kThreads;
    if (h < num_hyp) counts[h] = count[k];
  }
}

__global__ void __launch_bounds__(kThreads, kPlanarMinBlocks)
sphere_planar_vote_kernel(const float* __restrict__ sxyz, const float* __restrict__ points_t,
                          const float* __restrict__ valid, unsigned num_hyp, int n_pad,
                          float delta, int* __restrict__ counts,
                          float* __restrict__ params_t) {
  constexpr int kHyp = kPlanarHypPerThread, kBlockHyp = kPlanarHypPerBlock;
  static_assert(kWarps * kBlockHyp * sizeof(int) <= kTile * sizeof(float4),
                "the partial counts reuse the tile");
  __shared__ float4 tile[kTile];
  __shared__ float rows[kPlanarRows][kBlockHyp];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned h_first = blockIdx.x * kBlockHyp;
  const float3 o = lsq_sphere::vote_origin(points_t, n_pad, n_pad);
  if (threadIdx.x < kBlockHyp) {
    const unsigned h = h_first + threadIdx.x;
    float v[kPlanarRows] = {};  // a slot past the last hypothesis votes on zeros, unstored
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
      const float3 c = centre_about(s, o);
      const float cc = lsq_sphere::norm_sq(c);
      const float rp = __fadd_rn(s.r, delta);
      const float hi = __fmul_rn(rp, rp);
      const float lo_root = nan_max(__fsub_rn(s.r, delta), 0.f);
      const float lo = __fmul_rn(lo_root, lo_root);
      v[0] = __fmul_rn(-2.f, c.x);
      v[1] = __fmul_rn(-2.f, c.y);
      v[2] = __fmul_rn(-2.f, c.z);
      // -((|c'|^2 - hi) + 1e30 deg) and -(|c'|^2 - lo), each difference
      // taken the other way round: round to nearest is symmetric, so these
      // are the negations bit for bit.
      v[3] = __fsub_rn(__fsub_rn(hi, cc), s.degenerate ? 1e30f : 0.f);
      v[4] = __fsub_rn(lo, cc);
      write_params(s, h, num_hyp, params_t);
    }
#pragma unroll
    for (int i = 0; i < kPlanarRows; ++i) rows[i][threadIdx.x] = v[i];
  }
  __syncthreads();
  float a[kHyp][kPlanarRows];
  int count[kHyp];
#pragma unroll
  for (int k = 0; k < kHyp; ++k) {
#pragma unroll
    for (int i = 0; i < kPlanarRows; ++i) a[k][i] = rows[i][32 * k + lane];
    count[k] = 0;
  }

  for (int t0 = 0; t0 < n_pad; t0 += kTile) {
    const int len = min(kTile, n_pad - t0);
    __syncthreads();  // the previous tile is no longer read
    stage_tile(points_t, valid, n_pad, o, t0, len, tile);
    __syncthreads();
#pragma unroll 4
    for (int i = warp; i < len; i += kWarps) {
      const float4 q = tile[i];
#pragma unroll
      for (int k = 0; k < kHyp; ++k) {
        const float t = __fmaf_rn(a[k][2], q.z, __fmaf_rn(a[k][1], q.y,
                        __fmaf_rn(a[k][0], q.x, q.w)));
        lsq_sweep::count_in(count[k], t, a[k][4], a[k][3]);
      }
    }
  }
  const int total = lsq_sweep::split_total(count, reinterpret_cast<int*>(tile));
  const unsigned h = h_first + threadIdx.x;
  if (threadIdx.x < kBlockHyp && h < num_hyp) counts[h] = total;
}

unsigned blocks_for(unsigned long long num_hyp, int per_block) {
  return static_cast<unsigned>((num_hyp + per_block - 1) / per_block);
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
  sphere_mega_kernel<<<blocks_for(num_hyp, kMegaHypPerBlock), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      shifts, coords2, points_t, valid, n, n_pad, static_cast<unsigned>(num_hyp), delta,
      counts, params_t);
  return static_cast<int>(cudaGetLastError());
}

// The per-step sweep's launch shape at num_hyp hypotheses on the current
// device: out[0..5] = registers per thread, local (spill) bytes per thread,
// threads per block, hypotheses per block, blocks, resident blocks per SM.
// Returns the CUDA error of the queries.
extern "C" int sphere_mega_shape(int num_hyp, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, sphere_mega_kernel);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sphere_mega_kernel,
                                                        kThreads, 0);
  }
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = kThreads;
  out[3] = kMegaHypPerBlock;
  out[4] = static_cast<int>(blocks_for(static_cast<unsigned>(num_hyp), kMegaHypPerBlock));
  out[5] = per_sm;
  return static_cast<int>(err);
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
  sphere_planar_vote_kernel<<<blocks_for(num_hyp, kPlanarHypPerBlock), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      sxyz, points_t, valid, static_cast<unsigned>(num_hyp), n_pad, delta, counts, params_t);
  return static_cast<int>(cudaGetLastError());
}

// The planar fit-and-vote's launch shape at num_hyp hypotheses
// (lsq_sweep::kernel_shape).
extern "C" int sphere_planar_vote_shape(int num_hyp, int* out) {
  return lsq_sweep::kernel_shape(sphere_planar_vote_kernel, kThreads, kPlanarHypPerBlock,
                                 num_hyp, out);
}
