// Per-hypothesis sphere inlier counts, hand-written for Hopper (sm_90a).
//
// Replaces lsqrrecipes_tpu/ops/vote.py::_sphere_vote_kernel (the pallas_call
// in sphere_vote_counts).  For every hypothesis (cx, cy, cz, r) it counts the
// valid points p inside the sqrt-free squared band
//     lo2 < |p|^2 - 2 c.p + |c|^2 < (r + delta)^2,
//     lo2 = (r - delta)^2 if r - delta >= 0 else -inf,
// the predicate of SphereEstimator.vote_counts.
//
// What bounds it on an H100: arithmetic.  A (hypothesis, point) cell costs
// 10 f32 operations (-2 c.p as three multiplies and two adds, d2 as two
// adds, two compares, the count) while the bytes are the params in, the
// counts out and the points once: at B = 65,536 x n = 1,024 that is 6.7e8
// operations against 1.3 MB.  The TPU kernel put c.p on the matrix unit; a
// depth-3 contraction has no use for the tensor cores (and TF32 would move
// the band edge), so the whole cell stays on the FP32 pipes:
//   * multiplies and adds are kept apart (no FMA), so the plain PyTorch
//     version repeats the arithmetic exactly and the counts are equal;
//   * one thread per hypothesis, with c, |c|^2 and both band edges in
//     registers;
//   * the points are staged tile by tile in shared memory as float4
//     [x, y, z, |p|^2] and read as warp-wide broadcasts, one 16-byte load per
//     cell per warp;
//   * a padding column (valid == 0) is staged with |p|^2 = +inf, so it fails
//     d2 < hi2 and needs no per-cell valid test;
//   * the [B, n] distance matrix never exists: the counts are the only output.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // points per shared-memory tile: 32 KB

__global__ void __launch_bounds__(kThreads)
sphere_vote_kernel(const float* __restrict__ params,
                   const float* __restrict__ points_t,
                   const float* __restrict__ valid,
                   int n_pad, int num_hyp, float delta,
                   int* __restrict__ counts) {
  __shared__ float4 tile[kTile];

  const int h = blockIdx.x * kThreads + threadIdx.x;
  const bool live = h < num_hyp;
  float cx = 0.f, cy = 0.f, cz = 0.f, r = 0.f;
  if (live) {
    cx = params[4 * h + 0];
    cy = params[4 * h + 1];
    cz = params[4 * h + 2];
    r = params[4 * h + 3];
  }
  // Every operation rounds on its own (__f*_rn: nothing is contracted into
  // an FMA), in the plain version's order, so the two agree bit for bit.
  // -2 c.p is summed as (-2 cx) x + (-2 cy) y + (-2 cz) z: scaling by -2 is
  // exact, so this is the plain version's -(2 (cx x + cy y + cz z)).
  const float mx = -2.f * cx, my = -2.f * cy, mz = -2.f * cz;
  const float cc = __fadd_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)), __fmul_rn(cz, cz));
  const float rp = r + delta;
  const float rm = r - delta;
  const float hi2 = rp * rp;
  const float lo2 = rm >= 0.f ? rm * rm : -CUDART_INF_F;

  int count = 0;
  for (int t0 = 0; t0 < n_pad; t0 += kTile) {
    const int len = min(kTile, n_pad - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const int col = t0 + i;
      const float x = points_t[col];
      const float y = points_t[n_pad + col];
      const float z = points_t[2 * n_pad + col];
      // Unfused, in row order: the plain version's |p|^2 bit for bit.
      const float pp = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
      tile[i] = make_float4(x, y, z, valid[col] != 0.f ? pp : CUDART_INF_F);
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < len; ++i) {
      const float4 p = tile[i];
      const float m2cp = __fadd_rn(__fadd_rn(__fmul_rn(mx, p.x), __fmul_rn(my, p.y)),
                                   __fmul_rn(mz, p.z));
      const float d2 = __fadd_rn(__fadd_rn(p.w, m2cp), cc);
      count += (d2 < hi2) & (d2 > lo2);
    }
  }
  if (live) counts[h] = count;
}

}  // namespace

extern "C" const char* lsq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// params f32[num_hyp, 4], points_t f32[3, n_pad], valid f32[n_pad],
// counts int32[num_hyp]; all contiguous on the current device.  Enqueues on
// `stream` and returns cudaGetLastError().
extern "C" int sphere_vote_launch(const float* params, const float* points_t,
                                  const float* valid, int n_pad, int num_hyp,
                                  float delta, int* counts, void* stream) {
  if (num_hyp <= 0) return 0;
  const int blocks = (num_hyp + kThreads - 1) / kThreads;
  sphere_vote_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      params, points_t, valid, n_pad, num_hyp, delta, counts);
  return static_cast<int>(cudaGetLastError());
}
