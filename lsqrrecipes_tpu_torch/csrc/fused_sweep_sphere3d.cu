// Whole 3D-sphere RANSAC sweep, hand-written for Hopper (sm_90a).
//
// Replaces lsqrrecipes_tpu/ops/fused_sweep.py::_make_kernel with the
// sphere3d_fit_vote closure (the pallas_call in _sweep_call).  It computes
// what that kernel computes, not its block structure:
//   * hypothesis h = g * n_fit + lane (g < num_groups) takes, for slot j, the
//     point at column shift_units(g, j) * 128 + lane of rows 3j..3j+2 of the
//     [12, 5 n_fit] four-permutation coordinate plane, with
//     shift_units = (((g * 1103515245) & mask) >> (b j)) & (m - 1) in uint32
//     (the TPU kernel's int32 wraparound has the same low bits);
//   * a Cramer circumsphere in f32 with the closure's exact operation order
//     (sphere_fit.cuh: explicit __f*_rn intrinsics, so no multiply-add is
//     contracted and the fit is bit-for-bit the plain PyTorch version's);
//   * an affine band vote |P^T A| < 1 over the first vote_cols columns of P
//     [5, p_stride] (rows x, y, z, 1, |p|^2; padding columns carry a 1e30
//     guard in row 4) with A = [w(-2c), w|c|^2 + o, w];
//   * degenerate lanes (|det| < 1e-9) count 0 outright: their w = 0 would
//     also cancel the guard and let padding columns vote;
//   * the winner is the highest count, ties to the lowest h, i.e. the
//     earliest group and then the lowest lane, as the TPU grid's strict
//     ">" across steps and min-index within a step give.
//
// The TPU grid runs in order, so its running best lives in one SMEM scalar.
// Here blocks run concurrently and in no order, so each block reduces its
// hypotheses to one key (count << 32) | (0xFFFFFFFF - h) and atomicMax-es it
// into one global word, whose maximum is exactly that winner; a one-thread
// second kernel decodes the key and refits the winner for its parameters.
//
// What bounds it on an H100: arithmetic.  Each (hypothesis, column) cell is
// four FMAs and a multiply, a compare and an add (~10 f32 operations);
// 4.19M hypotheses x 1024 columns is 4.3e10 operations against < 1 MB of
// input.  The depth-5 band product has no use for the tensor cores (TF32
// would move the band edges), so:
//   * each thread keeps the band rows of 4 hypotheses in registers, so one
//     staged column feeds 4 hypotheses' FMAs;
//   * P is staged in 1024-column tiles in shared memory (float4 rows 0-3 plus
//     row 4, 20 KB) and read as warp-wide broadcasts;
//   * nothing per hypothesis is written to device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sphere_fit.cuh"

namespace {

using lsq_sphere::band_rows;
using lsq_sphere::circumsphere;
using lsq_sphere::Hypothesis;

constexpr int kThreads = 256;
constexpr int kHypPerThread = 4;
constexpr int kHypPerBlock = kThreads * kHypPerThread;
constexpr int kTile = 1024;  // P columns per shared-memory tile
constexpr unsigned kHashA = 1103515245u;

// The four sample points of hypothesis (g, lane) and their circumsphere.
__device__ __forceinline__ Hypothesis fit_sphere(const float* __restrict__ coords,
                                                 long long stride, unsigned g,
                                                 unsigned lane, int b, int m,
                                                 unsigned mask) {
  const unsigned hashed = (g * kHashA) & mask;
  float p[4][3];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned units = (hashed >> (b * j)) & static_cast<unsigned>(m - 1);
    const long long col = static_cast<long long>(units) * 128 + lane;
#pragma unroll
    for (int c = 0; c < 3; ++c) p[j][c] = __ldg(coords + (3 * j + c) * stride + col);
  }
  return circumsphere(p);
}

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ coords, long long coords_stride,
             const float* __restrict__ p, long long p_stride, int vote_cols,
             unsigned n_fit, unsigned num_hyp, int b, int m, unsigned mask,
             float delta, unsigned long long* __restrict__ best_key) {
  __shared__ float4 tile_xyz1[kTile];  // P rows 0-3
  __shared__ float tile_pp[kTile];     // P row 4
  __shared__ unsigned long long warp_best[kThreads / 32];

  const unsigned base = blockIdx.x * kHypPerBlock + threadIdx.x;
  float a[kHypPerThread][5];
  int count[kHypPerThread];
  bool counts_zero[kHypPerThread];
#pragma unroll
  for (int k = 0; k < kHypPerThread; ++k) {
    const unsigned h = base + k * kThreads;
    count[k] = 0;
    counts_zero[k] = true;
    if (h < num_hyp) {
      const Hypothesis s = fit_sphere(coords, coords_stride, h / n_fit, h % n_fit,
                                      b, m, mask);
      band_rows(s, delta, a[k]);
      counts_zero[k] = s.degenerate;
    } else {
#pragma unroll
      for (int q = 0; q < 5; ++q) a[k][q] = 0.f;
    }
  }

  for (int t0 = 0; t0 < vote_cols; t0 += kTile) {
    const int len = min(kTile, vote_cols - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const int col = t0 + i;
      tile_xyz1[i] = make_float4(p[col], p[p_stride + col], p[2 * p_stride + col],
                                 p[3 * p_stride + col]);
      tile_pp[i] = p[4 * p_stride + col];
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < len; ++i) {
      const float4 q = tile_xyz1[i];
      const float pp = tile_pp[i];
#pragma unroll
      for (int k = 0; k < kHypPerThread; ++k) {
        const float e = fmaf(pp, a[k][4], fmaf(q.w, a[k][3],
                        fmaf(q.z, a[k][2], fmaf(q.y, a[k][1], q.x * a[k][0]))));
        count[k] += fabsf(e) < 1.f;
      }
    }
  }

  // Best key of this thread, warp, block; then one atomic per block.
  unsigned long long key = 0;
#pragma unroll
  for (int k = 0; k < kHypPerThread; ++k) {
    const unsigned h = base + k * kThreads;
    if (h < num_hyp) {
      const unsigned long long c = counts_zero[k] ? 0ull : static_cast<unsigned long long>(count[k]);
      const unsigned long long cand = (c << 32) | (0xFFFFFFFFull - h);
      key = cand > key ? cand : key;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_down_sync(0xFFFFFFFFu, key, off);
    key = other > key ? other : key;
  }
  if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = key;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long best = warp_best[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) best = warp_best[w] > best ? warp_best[w] : best;
    atomicMax(best_key, best);
  }
}

// Decode the winning key and refit its hypothesis: best_out = [cx, cy, cz, r,
// count], best_index = h.
__global__ void finalize_kernel(const float* __restrict__ coords, long long coords_stride,
                                unsigned n_fit, int b, int m, unsigned mask,
                                const unsigned long long* __restrict__ best_key,
                                float* __restrict__ best_out,
                                long long* __restrict__ best_index) {
  const unsigned long long key = *best_key;
  const unsigned h = 0xFFFFFFFFu - static_cast<unsigned>(key & 0xFFFFFFFFull);
  const Hypothesis s = fit_sphere(coords, coords_stride, h / n_fit, h % n_fit, b, m, mask);
  best_out[0] = s.cx;
  best_out[1] = s.cy;
  best_out[2] = s.cz;
  best_out[3] = s.r;
  best_out[4] = static_cast<float>(key >> 32);
  *best_index = h;
}

}  // namespace

extern "C" const char* lsq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// coords f32[12, coords_stride] (coords_stride = 5 n_fit), p f32[5, p_stride],
// best_key u64[1] (scratch), best_out f32[5], best_index i64[1]; all
// contiguous on the current device.  Evaluates num_groups * n_fit
// hypotheses (< 2^32) and enqueues three operations on `stream`; returns the
// first CUDA error, 0 on success.
extern "C" int fused_sweep_sphere3d_launch(
    const float* coords, long long coords_stride, const float* p, long long p_stride,
    int vote_cols, int n_fit, long long num_groups, int b, int m, unsigned mask,
    float delta, unsigned long long* best_key, float* best_out, long long* best_index,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long num_hyp = static_cast<unsigned long long>(num_groups) * n_fit;
  if (num_hyp == 0 || num_hyp > 0xFFFFFFFFull) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(best_key, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((num_hyp + kHypPerBlock - 1) / kHypPerBlock);
  sweep_kernel<<<blocks, kThreads, 0, s>>>(coords, coords_stride, p, p_stride, vote_cols,
                                          static_cast<unsigned>(n_fit),
                                          static_cast<unsigned>(num_hyp), b, m, mask,
                                          delta, best_key);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_kernel<<<1, 1, 0, s>>>(coords, coords_stride, static_cast<unsigned>(n_fit), b,
                                  m, mask, best_key, best_out, best_index);
  return static_cast<int>(cudaGetLastError());
}
