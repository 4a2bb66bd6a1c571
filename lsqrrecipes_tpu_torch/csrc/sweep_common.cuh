// Shared pieces of the whole-sweep fused RANSAC kernels (sm_90a).
//
// A family F supplies its minimal fit and its per-cell vote; this header
// supplies what every family does alike, as the TPU kernel
// lsqrrecipes_tpu/ops/fused_sweep.py::_make_kernel does for every fit_vote
// closure (the four rigid families, pivot, absolute_orientation, ray3d and
// dense_linear6, instantiate split_sweep_kernel, the split-vote layout
// below; sphere3d, line3d, crosswire and pointer use the shift hash, the
// finalize kernel and that layout with kernels of their own; plane3d and
// line2d instantiate sweep_kernel):
//   * the shift hash: hypothesis h = g * n_fit + lane takes, for slot j, the
//     point at column shift_units(g, j) * 128 + lane of rows
//     F::kDim * j .. F::kDim * j + kDim - 1 of the four-permutation
//     coordinate plane, shift_units = (((g * 1103515245) & mask) >> (b j))
//     & (m - 1) in uint32 (the low bits of the TPU's int32 wraparound);
//   * the vote: each thread fits kHypPerThread hypotheses and keeps what
//     their vote needs in registers; the first vote_cols columns of the
//     packed point rows are staged tile by tile in shared memory and read
//     as warp-wide broadcasts;
//   * degenerate lanes count 0 outright;
//   * the winner: each block reduces its hypotheses to one 64-bit key
//     (count << 32) | (0xFFFFFFFF - h) and atomicMax-es it into one global
//     word, whose maximum is the highest count with the lowest h (the TPU's
//     "earliest group, then lowest lane"); a one-thread finalize kernel
//     decodes it and refits the winner for its parameters.
//
// A sweep_kernel family F provides:
//   kSlots, kDim, kParams, kTileRows  — sample slots, features per sampled
//                                       observation, parameters, staged rows;
//   struct Fit { bool degenerate; ... };  struct Band { ... };
//   static Fit fit(const float s[kSlots][kDim], const Consts&);
//   static Band band(const Fit&, const Consts&);
//   static void stage(const float* p, long long p_stride, int col,
//                     float (*tile)[kTile], int i);
//   static int vote(const Band&, float (*tile)[kTile], int i);
//   static void params(const Fit&, float* out);
// (split_sweep_kernel's families: see there.)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lsq_sweep {

constexpr int kThreads = 256;
constexpr int kHypPerThread = 4;
constexpr int kTile = 1024;  // P columns per shared-memory tile
constexpr unsigned kHashA = 1103515245u;

// Host-computed f32 constants, each the double value rounded once to f32, as
// the TPU closures' Python-float constants are: 1/delta and delta^2 (the
// point families), delta and delta^2 (the rigid families) and the ray
// family's parallel gate sin^2(min_angular_deviation).  A family reads only
// the ones it needs; the others are 0.
struct Consts {
  float inv_delta;
  float delta_sq;
  float delta;
  float cross_eps;
};

constexpr int kHypPerBlock = kThreads * kHypPerThread;

// The kSlots x kDim coordinates of hypothesis (g, lane).
template <int kSlots, int kDim>
__device__ __forceinline__ void load_slots(const float* __restrict__ coords,
                                           long long stride, unsigned g, unsigned lane,
                                           int b, int m, unsigned mask,
                                           float s[kSlots][kDim]) {
  const unsigned hashed = (g * kHashA) & mask;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const unsigned units = (hashed >> (b * j)) & static_cast<unsigned>(m - 1);
    const long long col = static_cast<long long>(units) * 128 + lane;
#pragma unroll
    for (int c = 0; c < kDim; ++c) s[j][c] = __ldg(coords + (kDim * j + c) * stride + col);
  }
}

// 1/sqrt(x) as two correctly rounded operations (rsqrtf is approximate).
__device__ __forceinline__ float rsqrt_rn(float x) {
  return __fdiv_rn(1.f, __fsqrt_rn(x));
}

template <class F>
__device__ __forceinline__ typename F::Fit fit_hypothesis(
    const float* __restrict__ coords, long long stride, unsigned h, unsigned n_fit,
    int b, int m, unsigned mask, const Consts& k) {
  float s[F::kSlots][F::kDim];
  load_slots<F::kSlots, F::kDim>(coords, stride, h / n_fit, h % n_fit, b, m, mask, s);
  return F::fit(s, k);
}

template <class F>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ coords, long long coords_stride,
             const float* __restrict__ p, long long p_stride, int vote_cols,
             unsigned n_fit, unsigned num_hyp, int b, int m, unsigned mask, Consts k,
             unsigned long long* __restrict__ best_key) {
  constexpr int kHyp = kHypPerThread;
  __shared__ float tile[F::kTileRows][kTile];
  __shared__ unsigned long long warp_best[kThreads / 32];

  const unsigned base = blockIdx.x * kHypPerBlock + threadIdx.x;
  typename F::Band band[kHyp];
  int count[kHyp];
  bool counts_zero[kHyp];
#pragma unroll
  for (int q = 0; q < kHyp; ++q) {
    const unsigned h = base + q * kThreads;
    count[q] = 0;
    counts_zero[q] = true;
    band[q] = typename F::Band{};
    if (h < num_hyp) {
      const typename F::Fit f = fit_hypothesis<F>(coords, coords_stride, h, n_fit, b, m,
                                                  mask, k);
      band[q] = F::band(f, k);
      counts_zero[q] = f.degenerate;
    }
  }

  for (int t0 = 0; t0 < vote_cols; t0 += kTile) {
    const int len = min(kTile, vote_cols - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < len; i += kThreads) F::stage(p, p_stride, t0 + i, tile, i);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < len; ++i) {
#pragma unroll
      for (int q = 0; q < kHyp; ++q) count[q] += F::vote(band[q], tile, i);
    }
  }

  // Best key of this thread, warp, block; then one atomic per block.
  unsigned long long key = 0;
#pragma unroll
  for (int q = 0; q < kHyp; ++q) {
    const unsigned h = base + q * kThreads;
    if (h < num_hyp) {
      const unsigned long long c =
          counts_zero[q] ? 0ull : static_cast<unsigned long long>(count[q]);
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

// Decode the winning key and refit its hypothesis: best_out = [params...,
// count], best_index = h.
template <class F>
__global__ void finalize_kernel(const float* __restrict__ coords, long long coords_stride,
                                unsigned n_fit, int b, int m, unsigned mask, Consts k,
                                const unsigned long long* __restrict__ best_key,
                                float* __restrict__ best_out,
                                long long* __restrict__ best_index) {
  const unsigned long long key = *best_key;
  const unsigned h = 0xFFFFFFFFu - static_cast<unsigned>(key & 0xFFFFFFFFull);
  const typename F::Fit f = fit_hypothesis<F>(coords, coords_stride, h, n_fit, b, m, mask, k);
  F::params(f, best_out);
  best_out[F::kParams] = static_cast<float>(key >> 32);
  *best_index = h;
}

// ---------------------------------------------------------------------------
// The split-vote layout (split_sweep_kernel below, the rigid families;
// sphere3d, line3d, crosswire and pointer with kernels of their own).  A block of
// kSplitThreads threads owns kSplitHypPerBlock consecutive hypotheses: lane l
// of every warp holds the vote rows of hypotheses l + 32 q (q <
// kSplitHypPerThread) in registers, and warp w votes on points w, w +
// kSplitWarps, ..., read from shared memory as warp-wide broadcasts, so one
// staged point feeds four cells per thread.  The warps' partial counts are
// then added in shared memory (integer sums, exact in any order) and the
// block publishes one key.  4,096 groups x 1,024 lanes make 32,768 blocks;
// the count is one predicated add per cell.
// ---------------------------------------------------------------------------

constexpr int kSplitThreads = 256;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSplitHypPerThread = 4;
constexpr int kSplitHypPerBlock = 32 * kSplitHypPerThread;

// count + 1 where x < lim: one compare and one predicated add.  The C++ form
// count += x < lim compiles to an add and a predicated move, one issue slot
// more per cell.  PTX's lt is ordered, so a NaN never counts.
__device__ __forceinline__ void count_below(int& count, float x, float lim) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.lt.f32 p, %1, %2;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(count)
      : "f"(x), "f"(lim));
}

// count + 1 where lo <= x < hi, the lower-closed twin of count_below: two
// compares and-ed into one predicated add.  Both are ordered, so a NaN never
// counts.
__device__ __forceinline__ void count_in(int& count, float x, float lo, float hi) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.ge.f32 p, %1, %2;\n\t"
      "setp.lt.and.f32 p, %1, %3, p;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(count)
      : "f"(x), "f"(lo), "f"(hi));
}

// count + 1 where t >= 0 and x < lim: the second compare ands the first's
// predicate, then one predicated add.  Both compares are ordered, so a NaN
// in either never counts.
__device__ __forceinline__ void count_below_if(int& count, float x, float lim, float t) {
  asm("{\n\t.reg .pred q, p;\n\t"
      "setp.ge.f32 q, %3, 0f00000000;\n\t"
      "setp.lt.and.f32 p, %1, %2, q;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(count)
      : "f"(x), "f"(lim), "f"(t));
}

// The block's end: add the warps' partial counts of its hypotheses h_first +
// i (i < n_valid; counts_zero[i] marks a degenerate one, which counts 0),
// reduce them to the best key (count << 32) | (0xFFFFFFFF - h) and
// atomicMax it into best_key.  Each thread holds the counts of kHyp
// hypotheses (l + 32 q for lane l), so the block owns 32 kHyp <= kSplitThreads
// of them.  `partial` holds kSplitWarps x 32 kHyp ints of shared memory that
// no thread reads any more (it may alias the caller's point tile).  Every
// thread of the block calls it.
template <int kHyp>
__device__ __forceinline__ void split_publish(const int (&count)[kHyp], int* partial,
                                              const bool* counts_zero, unsigned h_first,
                                              unsigned n_valid,
                                              unsigned long long* __restrict__ best_key) {
  constexpr int kBlockHyp = 32 * kHyp;
  static_assert(kBlockHyp <= kSplitThreads, "one thread per hypothesis adds the partials");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the caller's tile is no longer read
#pragma unroll
  for (int q = 0; q < kHyp; ++q) partial[warp * kBlockHyp + 32 * q + lane] = count[q];
  __syncthreads();
  if (threadIdx.x >= kBlockHyp) return;  // whole warps: no shuffle below diverges
  unsigned long long key = 0;
  if (threadIdx.x < n_valid) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) total += partial[w * kBlockHyp + threadIdx.x];
    const unsigned long long c =
        counts_zero[threadIdx.x] ? 0ull : static_cast<unsigned long long>(total);
    key = (c << 32) | (0xFFFFFFFFull - (h_first + threadIdx.x));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_down_sync(0xFFFFFFFFu, key, off);
    key = other > key ? other : key;
  }
  // One atomic per warp, skipped where the published key is already higher
  // (a stale read only costs an atomic: atomicMax is monotone).
  if (lane == 0 && key > *reinterpret_cast<volatile unsigned long long*>(best_key)) {
    atomicMax(best_key, key);
  }
}

// split_publish's first half for a kernel that writes every hypothesis's
// count (the planar fit-and-vote): the warps' partial counts stored in
// `partial` as there, and thread t < 32 kHyp gets the total of the block's
// hypothesis t, an integer sum, exact in any order (0 in the other
// threads).  split_publish keeps its own copy, with the reads inside its
// n_valid guard: calling this one added 8-16 instructions to each sweep it
// ends.  Every thread of the block calls it.
template <int kHyp>
__device__ __forceinline__ int split_total(const int (&count)[kHyp], int* partial) {
  constexpr int kBlockHyp = 32 * kHyp;
  static_assert(kBlockHyp <= kSplitThreads, "one thread per hypothesis adds the partials");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // the caller's tile is no longer read
#pragma unroll
  for (int q = 0; q < kHyp; ++q) partial[warp * kBlockHyp + 32 * q + lane] = count[q];
  __syncthreads();
  int total = 0;
  if (threadIdx.x < kBlockHyp) {
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) total += partial[w * kBlockHyp + threadIdx.x];
  }
  return total;
}

// split_sweep_kernel: the split-vote sweep of a family that supplies its
// per-cell vote.  Beside kSlots, kDim, kParams, Fit, fit() and params() (as
// sweep_kernel's families), F provides:
//   kVoteRows   — vote rows per hypothesis, held in registers;
//   Point       — one staged point, a struct of float4s read as 16-byte
//                 warp broadcasts (Float4x2 or Float4x3 below);
//   static void vote_rows(const Fit&, float r[kVoteRows]);
//   static Point stage(const float* p, long long p_stride, int col);
//   static void vote(int& count, const float (&r)[kVoteRows], const Point&,
//                    const Consts&);   // count_below(_if) on the cell's value
//   kHypPerThread — hypotheses per thread, 4 or 8: a block owns 32 x that
//                 many, and at 8 every thread fits one.
// The kernel asks for two resident blocks per SM (at most 128 registers a
// thread): three made absolute_orientation and dense_linear6 spill.
// The first 32 kHypPerThread threads fit one hypothesis each and leave its
// vote rows in shared memory; every thread then takes the rows of its
// kHypPerThread (l + 32 q for lane l), and warp w votes on points w,
// w + kSplitWarps, ... of 32 KB tiles (1,024 points of two float4s, 682 of
// three).  The family's vote is all that runs per cell.
struct Float4x2 {
  float4 a, b;
};
struct Float4x3 {
  float4 a, b, c;
};

constexpr int kSplitTileBytes = 32768;

template <class F>
__global__ void __launch_bounds__(kSplitThreads, 2)
split_sweep_kernel(const float* __restrict__ coords, long long coords_stride,
                   const float* __restrict__ p, long long p_stride, int vote_cols,
                   unsigned n_fit, unsigned num_hyp, int b, int m, unsigned mask, Consts k,
                   unsigned long long* __restrict__ best_key) {
  using Point = typename F::Point;
  constexpr int kHyp = F::kHypPerThread;
  constexpr int kBlockHyp = 32 * kHyp;
  constexpr int kRows = F::kVoteRows;
  constexpr int kPoints = kSplitTileBytes / static_cast<int>(sizeof(Point));
  static_assert(kSplitWarps * kBlockHyp * sizeof(int) <= sizeof(Point) * kPoints,
                "the partial counts reuse the tile");
  __shared__ Point tile[kPoints];
  __shared__ float rows[kRows][kBlockHyp];
  __shared__ bool counts_zero[kBlockHyp];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned h_first = blockIdx.x * kBlockHyp;
  if (threadIdx.x < kBlockHyp) {
    const unsigned h = h_first + threadIdx.x;
    float r[kRows] = {};  // a slot past the last hypothesis votes on zeros, unpublished
    bool zero = true;
    if (h < num_hyp) {
      const typename F::Fit f = fit_hypothesis<F>(coords, coords_stride, h, n_fit, b, m, mask, k);
      F::vote_rows(f, r);
      zero = f.degenerate;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) rows[i][threadIdx.x] = r[i];
    counts_zero[threadIdx.x] = zero;
  }
  __syncthreads();
  float r[kHyp][kRows];
  int count[kHyp];
#pragma unroll
  for (int q = 0; q < kHyp; ++q) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) r[q][i] = rows[i][32 * q + lane];
    count[q] = 0;
  }

  for (int t0 = 0; t0 < vote_cols; t0 += kPoints) {
    const int len = min(kPoints, vote_cols - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < len; i += kSplitThreads) tile[i] = F::stage(p, p_stride, t0 + i);
    __syncthreads();
#pragma unroll 4
    for (int i = warp; i < len; i += kSplitWarps) {
      const Point pt = tile[i];
#pragma unroll
      for (int q = 0; q < kHyp; ++q) F::vote(count[q], r[q], pt, k);
    }
  }

  split_publish(count, reinterpret_cast<int*>(tile), counts_zero, h_first, num_hyp - h_first,
                best_key);
}

inline unsigned ceil_div(unsigned long long a, unsigned b) {
  return static_cast<unsigned>((a + b - 1) / b);
}

// What every launch symbol does around its family's kernels: check the sizes
// (num_groups * n_fit hypotheses, < 2^32), clear the key, let `sweep`
// enqueue the kernels that vote (it takes num_hyp and returns the first CUDA
// error), then the one-thread finalize.  Returns the first CUDA error, 0 on
// success.
template <class F, class Sweep>
int launch_with(const float* coords, long long coords_stride, int vote_cols, int n_fit,
                long long num_groups, int b, int m, unsigned mask, Consts k,
                unsigned long long* best_key, float* best_out, long long* best_index,
                cudaStream_t s, Sweep sweep) {
  const unsigned long long num_hyp = static_cast<unsigned long long>(num_groups) * n_fit;
  if (num_hyp == 0 || num_hyp > 0xFFFFFFFFull || vote_cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(best_key, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sweep(static_cast<unsigned>(num_hyp));
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_kernel<F><<<1, 1, 0, s>>>(coords, coords_stride, static_cast<unsigned>(n_fit), b,
                                     m, mask, k, best_key, best_out, best_index);
  return static_cast<int>(cudaGetLastError());
}

// Enqueue the whole sweep of a sweep_kernel family on `stream`: clear the
// key, sweep, finalize.  Returns the first CUDA error, 0 on success.
template <class F>
int launch_sweep(const float* coords, long long coords_stride, const float* p,
                 long long p_stride, int vote_cols, int n_fit, long long num_groups, int b,
                 int m, unsigned mask, Consts k, unsigned long long* best_key,
                 float* best_out, long long* best_index, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_with<F>(coords, coords_stride, vote_cols, n_fit, num_groups, b, m, mask, k,
                        best_key, best_out, best_index, s, [&](unsigned num_hyp) {
                          sweep_kernel<F><<<ceil_div(num_hyp, kHypPerBlock), kThreads, 0, s>>>(
                              coords, coords_stride, p, p_stride, vote_cols,
                              static_cast<unsigned>(n_fit), num_hyp, b, m, mask, k, best_key);
                          return cudaGetLastError();
                        });
}

// Enqueue the whole sweep of a split_sweep_kernel family on `stream`: clear
// the key, sweep, finalize.  Returns the first CUDA error, 0 on success.
template <class F>
int launch_split(const float* coords, long long coords_stride, const float* p,
                 long long p_stride, int vote_cols, int n_fit, long long num_groups, int b,
                 int m, unsigned mask, Consts k, unsigned long long* best_key,
                 float* best_out, long long* best_index, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_with<F>(coords, coords_stride, vote_cols, n_fit, num_groups, b, m, mask, k,
                        best_key, best_out, best_index, s, [&](unsigned num_hyp) {
                          split_sweep_kernel<F>
                              <<<ceil_div(num_hyp, 32 * F::kHypPerThread), kSplitThreads, 0, s>>>(
                                  coords, coords_stride, p, p_stride, vote_cols,
                                  static_cast<unsigned>(n_fit), num_hyp, b, m, mask, k,
                                  best_key);
                          return cudaGetLastError();
                        });
}

// A kernel's launch shape at num_hyp hypotheses on the current device, for
// the <name>_shape queries: out[0..5] = registers per thread, local (spill)
// bytes per thread, threads per block, hypotheses per block, blocks,
// resident blocks per SM.  Returns the CUDA error of the queries.
template <class Kernel>
int kernel_shape(Kernel kernel, int threads, int hyp_per_block, int num_hyp, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  }
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = threads;
  out[3] = hyp_per_block;
  out[4] = static_cast<int>(ceil_div(static_cast<unsigned>(num_hyp), hyp_per_block));
  out[5] = per_sm;
  return static_cast<int>(err);
}

}  // namespace lsq_sweep
