// Shared pieces of the whole-sweep fused RANSAC kernels (sm_90a).
//
// A family F supplies its minimal fit and its per-cell vote; this header
// supplies what every family does alike, as the TPU kernel
// lsqrrecipes_tpu/ops/fused_sweep.py::_make_kernel does for every fit_vote
// closure:
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
// A family F provides:
//   kSlots, kDim, kParams, kTileRows  — sample slots, features per sampled
//                                       observation, parameters, staged rows;
//   optionally kTileCols              — columns per shared-memory tile where
//                                       kTileRows x kTile floats would pass
//                                       the 48 KB static limit (else kTile);
//   optionally kHypPerThread          — hypotheses per thread where four
//                                       fits' registers would spill (else
//                                       kHypPerThread below);
//   struct Fit { bool degenerate; ... };  struct Band { ... };
//   static Fit fit(const float s[kSlots][kDim], const Consts&);
//   static Band band(const Fit&, const Consts&);
//   static void stage(const float* p, long long p_stride, int col,
//                     float (*tile)[TileCols<F>::value], int i);
//   static int vote(const Band&, float (*tile)[TileCols<F>::value], int i);
//   static void params(const Fit&, float* out);

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Columns of P per shared-memory tile for family F: F::kTileCols if the
// family declares it, else kTile.
template <class F, class = void>
struct TileCols {
  static constexpr int value = kTile;
};
template <class F>
struct TileCols<F, std::void_t<decltype(F::kTileCols)>> {
  static constexpr int value = F::kTileCols;
};

// Hypotheses per thread for family F: F::kHypPerThread if the family
// declares it, else kHypPerThread.
template <class F, class = void>
struct HypPerThread {
  static constexpr int value = kHypPerThread;
};
template <class F>
struct HypPerThread<F, std::void_t<decltype(F::kHypPerThread)>> {
  static constexpr int value = F::kHypPerThread;
};

template <class F>
struct HypPerBlock {
  static constexpr int value = kThreads * HypPerThread<F>::value;
};

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
  constexpr int kCols = TileCols<F>::value;
  constexpr int kHyp = HypPerThread<F>::value;
  __shared__ float tile[F::kTileRows][kCols];
  __shared__ unsigned long long warp_best[kThreads / 32];

  const unsigned base = blockIdx.x * HypPerBlock<F>::value + threadIdx.x;
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

  for (int t0 = 0; t0 < vote_cols; t0 += kCols) {
    const int len = min(kCols, vote_cols - t0);
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

// Enqueue the whole sweep on `stream`: clear the key, sweep, finalize.
// Returns the first CUDA error, 0 on success.
template <class F>
int launch_sweep(const float* coords, long long coords_stride, const float* p,
                 long long p_stride, int vote_cols, int n_fit, long long num_groups, int b,
                 int m, unsigned mask, Consts k, unsigned long long* best_key,
                 float* best_out, long long* best_index, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long num_hyp = static_cast<unsigned long long>(num_groups) * n_fit;
  if (num_hyp == 0 || num_hyp > 0xFFFFFFFFull || vote_cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(best_key, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>((num_hyp + HypPerBlock<F>::value - 1) / HypPerBlock<F>::value);
  sweep_kernel<F><<<blocks, kThreads, 0, s>>>(coords, coords_stride, p, p_stride, vote_cols,
                                              static_cast<unsigned>(n_fit),
                                              static_cast<unsigned>(num_hyp), b, m, mask, k,
                                              best_key);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_kernel<F><<<1, 1, 0, s>>>(coords, coords_stride, static_cast<unsigned>(n_fit), b,
                                     m, mask, k, best_key, best_out, best_index);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lsq_sweep
