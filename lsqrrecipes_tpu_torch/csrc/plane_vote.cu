// Per-hypothesis signed-distance inlier counts, hand-written for Hopper
// (sm_90a).
//
// Replaces lsqrrecipes_tpu/ops/vote.py::_plane_vote_kernel (the pallas_call
// in plane_vote_counts).  For every hypothesis [n (d), offset] it counts the
// valid points p with
//     (n.p - offset)^2 < delta_sq,
// for d = 2 (2D lines) and d = 3 (planes).
//
// What bounds it on an H100: instruction issue.  A (hypothesis, point) cell
// costs, counted from the loop below, d multiplies and d - 1 adds for n.p,
// one subtract, one multiply, a compare and the count: 9 f32 operations for
// d = 3 and 7 for d = 2, while the bytes are the params in, the counts out
// and the points once: at B = 65,536 x n = 1,024 that is 6.0e8 operations
// against 1.3 MB, 0.009 ms at 67 TFLOP/s against 0.0004 ms at 3.35 TB/s
// (2^20 x 8,192: 1.15 ms against 0.006 ms).  The multiplies and adds stay
// apart (__f*_rn: no FMA), so the plain PyTorch version repeats the
// arithmetic exactly and the counts equal it and the JAX kernel's; each then
// takes a full issue slot, and the cell's ~9 warp instructions per 32 cells
// (d = 3), at four issues per clock per SM, set the floor (about 2.3 ms at
// 2^20 x 8,192, twice the bound).  The TPU kernel put n.p on the matrix
// unit; a depth-2/3 contraction has no use for the tensor cores (and TF32
// would move the band edge).  The layout spends as little as it can beside
// those 9:
//   * a thread keeps kHypPerThread = 4 hypotheses (n and the offset) in
//     registers, so one warp-wide broadcast of a point feeds four cells: a
//     quarter of a shared-memory load per cell, and the loop's own
//     instructions amortised over 16 cells per unrolled step;
//   * a point is staged as one float4 (x, y, z or 0, 0) whatever d is, so it
//     is one 16-byte broadcast; an invalid column (valid == 0) is staged with
//     x = NaN, so every cell of it compares false and needs no per-cell valid
//     test;
//   * a block owns 32 x 4 = 128 hypotheses, and its 8 warps split the point
//     axis (warp w takes points w, w + 8, ...); at the end they add their
//     partial counts in shared memory, an integer sum that is exact in any
//     order, so 65,536 hypotheses make 512 blocks (about four per SM) and
//     2^20 make 8,192, with no atomics and no memset;
//   * the points come in tiles of 2,048 (32 KB), so any n works;
//   * the [B, n] distance matrix never exists: the counts are the only output.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py) this took 2.80-2.83 ms at
// 2^20 x 8,192 (d = 3), where one thread per hypothesis reading d floats
// from shared memory per cell took 3.39-3.41 ms.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHypPerThread = 4;
constexpr int kHypPerBlock = 32 * kHypPerThread;  // every warp holds all of them
constexpr int kTile = 2048;  // points per shared-memory tile: 32 KB
static_assert(kWarps * kHypPerBlock * sizeof(int) <= kTile * sizeof(float4),
              "the partial counts reuse the tile");

// count + 1 where q < delta_sq: a compare and one predicated add.  The C++
// form count += q < delta_sq compiles to an add and a predicated move, one
// issue slot more per cell.  PTX's lt is ordered, so a NaN never counts.
__device__ __forceinline__ void count_below(int& count, float q, float delta_sq) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.lt.f32 p, %1, %2;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(count)
      : "f"(q), "f"(delta_sq));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
plane_vote_kernel(const float* __restrict__ params, const float* __restrict__ points_t,
                  const float* __restrict__ valid, int n_pad, unsigned num_hyp,
                  float delta_sq, int* __restrict__ counts) {
  __shared__ float4 tile[kTile];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned base = blockIdx.x * kHypPerBlock + lane;
  float nrm[kHypPerThread][D], offset[kHypPerThread];
  int count[kHypPerThread];
#pragma unroll
  for (int k = 0; k < kHypPerThread; ++k) {
    const unsigned h = base + 32 * k;
    const bool live = h < num_hyp;  // a slot past the last one votes on zeros, unstored
    const float* row = params + (D + 1) * static_cast<size_t>(live ? h : 0);
#pragma unroll
    for (int c = 0; c < D; ++c) nrm[k][c] = live ? row[c] : 0.f;
    offset[k] = live ? row[D] : 0.f;
    count[k] = 0;
  }

  for (int t0 = 0; t0 < n_pad; t0 += kTile) {
    const int len = min(kTile, n_pad - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const int col = t0 + i;
      const float x = valid[col] != 0.f ? points_t[col] : __int_as_float(0x7fffffff);
      tile[i] = make_float4(x, points_t[n_pad + col], D == 3 ? points_t[2 * n_pad + col] : 0.f,
                            0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int i = warp; i < len; i += kWarps) {
      const float4 p = tile[i];
#pragma unroll
      for (int k = 0; k < kHypPerThread; ++k) {
        // n.p summed in coordinate order, each operation rounded on its own.
        float s = __fadd_rn(__fmul_rn(nrm[k][0], p.x), __fmul_rn(nrm[k][1], p.y));
        if (D == 3) s = __fadd_rn(s, __fmul_rn(nrm[k][D - 1], p.z));
        s = __fsub_rn(s, offset[k]);
        count_below(count[k], __fmul_rn(s, s), delta_sq);
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

// params f32[num_hyp, dim + 1], points_t f32[dim, n_pad], valid f32[n_pad],
// counts int32[num_hyp]; dim 2 or 3; all contiguous on the current device,
// num_hyp below 2^31.  Enqueues on `stream` and returns cudaGetLastError().
extern "C" int plane_vote_launch(const float* params, const float* points_t,
                                 const float* valid, int dim, int n_pad, int num_hyp,
                                 float delta_sq, int* counts, void* stream) {
  if (num_hyp <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned b = static_cast<unsigned>(num_hyp);
  if (dim == 3) {
    plane_vote_kernel<3><<<blocks_for(b), kThreads, 0, s>>>(params, points_t, valid, n_pad, b,
                                                            delta_sq, counts);
  } else if (dim == 2) {
    plane_vote_kernel<2><<<blocks_for(b), kThreads, 0, s>>>(params, points_t, valid, n_pad, b,
                                                            delta_sq, counts);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of the d = 3 kernel at num_hyp hypotheses on the current
// device (d = 2 has the same block shape): out[0..5] = registers per thread,
// local (spill) bytes per thread, threads per block, hypotheses per block,
// blocks, resident blocks per SM.  Returns the CUDA error of the queries.
extern "C" int plane_vote_shape(int num_hyp, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, plane_vote_kernel<3>);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, plane_vote_kernel<3>, kThreads,
                                                        0);
  }
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = kThreads;
  out[3] = kHypPerBlock;
  out[4] = blocks_for(static_cast<unsigned>(num_hyp));
  out[5] = per_sm;
  return static_cast<int>(err);
}
