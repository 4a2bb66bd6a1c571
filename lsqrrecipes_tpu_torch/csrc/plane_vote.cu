// Per-hypothesis signed-distance inlier counts, hand-written for Hopper
// (sm_90a).
//
// Replaces lsqrrecipes_tpu/ops/vote.py::_plane_vote_kernel (the pallas_call
// in plane_vote_counts).  For every hypothesis [n (d), offset] it counts the
// valid points p with
//     (n.p - offset)^2 < delta_sq,
// for d = 2 (2D lines) and d = 3 (planes).
//
// What bounds it on an H100: arithmetic.  A (hypothesis, point) cell costs,
// counted from the loop below, d multiplies and d - 1 adds for n.p, one
// subtract, one multiply, a compare and the count: 9 f32 operations for
// d = 3 and 7 for d = 2, while the bytes are the params in, the counts out
// and the points once: at B = 65,536 x n = 1,024 that is 6.0e8 operations
// against 1.3 MB, 0.009 ms at 67 TFLOP/s against 0.0004 ms at 3.35 TB/s
// (2^20 x 8,192: 1.15 ms against 0.006 ms).  The TPU kernel put n.p on the
// matrix unit; a depth-2/3 contraction has no use for the tensor cores (and
// TF32 would move the band edge), so the whole cell stays on the FP32 pipes:
//   * multiplies and adds are kept apart (no FMA), so the plain PyTorch
//     version repeats the arithmetic exactly and the counts are equal;
//   * one thread per hypothesis, with n and the offset in registers;
//   * the points are staged tile by tile in shared memory, one row per
//     coordinate, and read as warp-wide broadcasts;
//   * an invalid column (valid == 0) is staged with x = NaN, so every cell
//     of it compares false and needs no per-cell valid test;
//   * the [B, n] distance matrix never exists: the counts are the only output.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // points per shared-memory tile: 16 or 24 KB

template <int D>
__global__ void __launch_bounds__(kThreads)
plane_vote_kernel(const float* __restrict__ params, const float* __restrict__ points_t,
                  const float* __restrict__ valid, int n_pad, int num_hyp, float delta_sq,
                  int* __restrict__ counts) {
  __shared__ float tile[D][kTile];

  const int h = blockIdx.x * kThreads + threadIdx.x;
  const bool live = h < num_hyp;
  float n[D];
#pragma unroll
  for (int c = 0; c < D; ++c) n[c] = live ? params[(D + 1) * h + c] : 0.f;
  const float offset = live ? params[(D + 1) * h + D] : 0.f;

  int count = 0;
  for (int t0 = 0; t0 < n_pad; t0 += kTile) {
    const int len = min(kTile, n_pad - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const int col = t0 + i;
      tile[0][i] = valid[col] != 0.f ? points_t[col] : __int_as_float(0x7fffffff);
#pragma unroll
      for (int c = 1; c < D; ++c) tile[c][i] = points_t[c * n_pad + col];
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < len; ++i) {
      // n.p summed in coordinate order, each operation rounded on its own.
      float s = __fmul_rn(n[0], tile[0][i]);
#pragma unroll
      for (int c = 1; c < D; ++c) s = __fadd_rn(s, __fmul_rn(n[c], tile[c][i]));
      s = __fsub_rn(s, offset);
      count += __fmul_rn(s, s) < delta_sq;
    }
  }
  if (live) counts[h] = count;
}

}  // namespace

extern "C" const char* lsq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// params f32[num_hyp, dim + 1], points_t f32[dim, n_pad], valid f32[n_pad],
// counts int32[num_hyp]; dim 2 or 3; all contiguous on the current device.
// Enqueues on `stream` and returns cudaGetLastError().
extern "C" int plane_vote_launch(const float* params, const float* points_t,
                                 const float* valid, int dim, int n_pad, int num_hyp,
                                 float delta_sq, int* counts, void* stream) {
  if (num_hyp <= 0) return 0;
  const int blocks = (num_hyp + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 3) {
    plane_vote_kernel<3><<<blocks, kThreads, 0, s>>>(params, points_t, valid, n_pad, num_hyp,
                                                     delta_sq, counts);
  } else if (dim == 2) {
    plane_vote_kernel<2><<<blocks, kThreads, 0, s>>>(params, points_t, valid, n_pad, num_hyp,
                                                     delta_sq, counts);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
