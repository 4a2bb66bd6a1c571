// Per-hypothesis sphere inlier counts, hand-written for Hopper (sm_90a).
//
// Replaces lsqrrecipes_tpu/ops/vote.py::_sphere_vote_kernel (the pallas_call
// in sphere_vote_counts).  For every hypothesis (cx, cy, cz, r) it counts the
// valid points p inside the sqrt-free squared band
//     lo2 < |p - c|^2 < (r + delta)^2,
//     lo2 = (r - delta)^2 if r - delta >= 0 else -inf,
// the predicate of SphereEstimator.vote_counts.  The TPU kernel expands
// |p - c|^2 = |p|^2 - 2 c.p + |c|^2 about the origin; this one about the
// centre o = points_t's column 0 (sphere_fit.cuh's vote_origin, read on the
// device), with p' = p - o and c' = c - o: 1e4 from the origin ulp(|p|^2) is
// 32 against a band of 40 at r = 10, delta = 1, and the uncentred plain
// version counted 525 where float64 counts 819-820.
//
// What bounds it on an H100: instruction issue.  The bound counts a
// (hypothesis, point) cell as 10 f32 operations (-2 c.p as three multiplies
// and two adds, d2 as two adds, two compares, the count) while the bytes are
// the params in, the counts out and the points once: at B = 65,536 x
// n = 1,024 that is 6.7e8 operations against 1.3 MB, and at 2^20 x 8,192
// 1.28 ms at 67 TFLOP/s.  The TPU kernel put c.p on the matrix unit; a
// depth-3 contraction has no use for the tensor cores (and TF32 would move
// the band edge), so every cell is FP32 instructions, issued one warp
// instruction per clock per SM quarter.  The layout cuts those instructions:
//   * |p'|^2 - 2 c'.p' is three fused multiply-adds, t = fma(-2c'z, z',
//     fma(-2c'y, y', fma(-2c'x, x', |p'|^2))), then d2 = t + |c'|^2: with the two
//     compares and one predicated add, 7 instructions per cell where
//     separate multiplies and adds take 10.  The plain PyTorch version
//     computes each FMA exactly as CUDA rounds it (linalg.small.fma_f32), so
//     the counts stay equal to it; against JAX's kernel they differ by at
//     most one at a band edge, as the unfused form did;
//   * a thread keeps kHypPerThread = 4 hypotheses in registers (-2c', |c'|^2
//     and both band edges), so one warp-wide broadcast of a point feeds four
//     cells: a quarter of a shared-memory load per cell, and the loop's own
//     instructions amortised over 16 cells per unrolled step;
//   * a block owns 32 x 4 = 128 hypotheses, and its 8 warps split the point
//     axis (warp w takes points w, w + 8, ...); at the end they add their
//     partial counts in shared memory, an integer sum that is exact in any
//     order, so 65,536 hypotheses make 512 blocks (about four per SM) and
//     2^20 make 8,192, with no atomics and no memset;
//   * the points are staged tile by tile (2,048 points, 32 KB) in shared
//     memory as float4 [x', y', z', |p'|^2]; a padding column (valid == 0) is
//     staged with |p'|^2 = +inf, so it fails d2 < hi2 and needs no per-cell
//     valid test;
//   * the [B, n] distance matrix never exists: the counts are the only output.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py) this took 2.62-2.63 ms at
// 2^20 x 8,192, where the same layout with separate multiplies and adds took
// 3.49-3.50 ms and one thread per hypothesis with a shared-memory load per
// cell 4.02-4.05 ms; both layouts issue short of one instruction per clock
// (PERF.md).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "sphere_fit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHypPerThread = 4;
constexpr int kHypPerBlock = 32 * kHypPerThread;  // every warp holds all of them
constexpr int kTile = 2048;  // points per shared-memory tile: 32 KB
static_assert(kWarps * kHypPerBlock * sizeof(int) <= kTile * sizeof(float4),
              "the partial counts reuse the tile");

// count + 1 where lo2 < d2 < hi2: two compares and one predicated add.  The
// C++ form count += (d2 < hi2) & (d2 > lo2) compiles to an add and a
// predicated move, one issue slot more per cell.  PTX's gt and lt are
// ordered, so a NaN never counts.
__device__ __forceinline__ void count_inside(int& count, float d2, float lo2, float hi2) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.gt.f32 p, %1, %2;\n\t"
      "setp.lt.and.f32 p, %1, %3, p;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(count)
      : "f"(d2), "f"(lo2), "f"(hi2));
}

__global__ void __launch_bounds__(kThreads)
sphere_vote_kernel(const float* __restrict__ params,
                   const float* __restrict__ points_t,
                   const float* __restrict__ valid,
                   int n_pad, unsigned num_hyp, float delta,
                   int* __restrict__ counts) {
  __shared__ float4 tile[kTile];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned base = blockIdx.x * kHypPerBlock + lane;
  // Every operation is its own correctly rounded intrinsic (__f*_rn), in the
  // plain version's order, so the two agree bit for bit; scaling c' by -2 is
  // exact.
  const float3 o = lsq_sphere::vote_origin(points_t, n_pad, n_pad);
  float mx[kHypPerThread], my[kHypPerThread], mz[kHypPerThread];
  float cc[kHypPerThread], hi2[kHypPerThread], lo2[kHypPerThread];
  int count[kHypPerThread];
#pragma unroll
  for (int k = 0; k < kHypPerThread; ++k) {
    const unsigned h = base + 32 * k;
    float cx = 0.f, cy = 0.f, cz = 0.f, r = 0.f;
    if (h < num_hyp) {  // a slot past the last hypothesis votes on zeros, unstored
      const float* row = params + 4 * static_cast<size_t>(h);
      cx = row[0];
      cy = row[1];
      cz = row[2];
      r = row[3];
    }
    const float3 c = make_float3(__fsub_rn(cx, o.x), __fsub_rn(cy, o.y), __fsub_rn(cz, o.z));
    mx[k] = -2.f * c.x;
    my[k] = -2.f * c.y;
    mz[k] = -2.f * c.z;
    cc[k] = lsq_sphere::norm_sq(c);
    const float rp = __fadd_rn(r, delta);
    const float rm = __fsub_rn(r, delta);
    hi2[k] = __fmul_rn(rp, rp);
    lo2[k] = rm >= 0.f ? __fmul_rn(rm, rm) : -CUDART_INF_F;
    count[k] = 0;
  }

  for (int t0 = 0; t0 < n_pad; t0 += kTile) {
    const int len = min(kTile, n_pad - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const int col = t0 + i;
      float4 pt = lsq_sphere::centred_point(points_t, n_pad, col, o);
      if (valid[col] == 0.f) pt.w = CUDART_INF_F;
      tile[i] = pt;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = warp; i < len; i += kWarps) {
      const float4 p = tile[i];
#pragma unroll
      for (int k = 0; k < kHypPerThread; ++k) {
        const float t = __fmaf_rn(mz[k], p.z, __fmaf_rn(my[k], p.y, __fmaf_rn(mx[k], p.x, p.w)));
        const float d2 = __fadd_rn(t, cc[k]);
        count_inside(count[k], d2, lo2[k], hi2[k]);
      }
    }
  }

  __syncthreads();  // the tile is no longer read: it holds the partial counts
  int* partial = reinterpret_cast<int*>(tile);  // [kWarps][kHypPerBlock]
#pragma unroll
  for (int k = 0; k < kHypPerThread; ++k) partial[warp * kHypPerBlock + 32 * k + lane] = count[k];
  __syncthreads();
  if (threadIdx.x < kHypPerBlock) {
    const unsigned h = blockIdx.x * kHypPerBlock + threadIdx.x;
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += partial[w * kHypPerBlock + threadIdx.x];
    if (h < num_hyp) counts[h] = total;
  }
}

int blocks_for(unsigned num_hyp) {
  return static_cast<int>((num_hyp + kHypPerBlock - 1) / kHypPerBlock);
}

}  // namespace

extern "C" const char* lsq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// params f32[num_hyp, 4], points_t f32[3, n_pad], valid f32[n_pad],
// counts int32[num_hyp]; all contiguous on the current device, num_hyp below
// 2^31.  Enqueues on `stream` and returns cudaGetLastError().
extern "C" int sphere_vote_launch(const float* params, const float* points_t,
                                  const float* valid, int n_pad, int num_hyp,
                                  float delta, int* counts, void* stream) {
  if (num_hyp <= 0) return 0;
  sphere_vote_kernel<<<blocks_for(num_hyp), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      params, points_t, valid, n_pad, static_cast<unsigned>(num_hyp), delta, counts);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape at num_hyp hypotheses on the current device: out[0..5] =
// registers per thread, local (spill) bytes per thread, threads per block,
// hypotheses per block, blocks, resident blocks per SM.  Returns the CUDA
// error of the queries.
extern "C" int sphere_vote_shape(int num_hyp, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, sphere_vote_kernel);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sphere_vote_kernel, kThreads, 0);
  }
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = kThreads;
  out[3] = kHypPerBlock;
  out[4] = blocks_for(num_hyp);
  out[5] = per_sm;
  return static_cast<int>(err);
}
