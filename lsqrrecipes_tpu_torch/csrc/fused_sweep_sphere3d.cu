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
//   * an affine band vote |w |p - c|^2 + o| < 1 over the live columns among
//     the first vote_cols of P [5, p_stride] (rows x, y, z, 1, |p|^2; a
//     padding column has 0 in the ones row), which the TPU kernel expands
//     as |P^T A| with A = [w(-2c), w|c|^2 + o, w] about the origin and this
//     kernel about P's column 0 (see below);
//   * degenerate lanes (|det| < 1e-9) count 0 outright;
//   * the winner is the highest count, ties to the lowest h, i.e. the
//     earliest group and then the lowest lane, as the TPU grid's strict
//     ">" across steps and min-index within a step give.
//
// The TPU grid runs in order, so its running best lives in one SMEM scalar.
// Here blocks run concurrently and in no order, so each block reduces its
// hypotheses to one key (count << 32) | (0xFFFFFFFF - h) and atomicMax-es it
// into one global word, whose maximum is exactly that winner; a one-thread
// second kernel decodes the key and refits the winner for its parameters
// (sweep_common.cuh's launch_with and finalize_kernel).
//
// What bounds it on an H100: arithmetic.  Each (hypothesis, column) cell is
// four FMAs, an abs-compare and a count (11 f32 operations, an FMA counting
// 2); 4.19M hypotheses x 1,024 columns is 4.7e10 operations against < 1 MB
// of input.  The depth-5 band product has no use for the tensor cores (TF32
// would move the band edges), so the vote runs on the FP32 pipes in
// sweep_common.cuh's split-vote layout with eight hypotheses per thread (see
// sphere3d_kernel): B7's cell (sphere_ransac.cu), e = fma(a4, |p'|^2, fma(a2,
// z', fma(a1, y', fma(a0, x', a3)))) on one float4 broadcast per point, so
// that one staged point feeds eight cells, and the count one predicated add.
// Points and centres are taken relative to P's column 0 (sphere_fit.cuh's
// vote_origin): about the origin, a cloud 1e4 away lost its band to
// ulp(|p|^2), and the plain version's best count fell from 823 to 706.
// Nothing per hypothesis is written to device memory.  The plain version
// (ops/fused_sweep.py::_sphere3d_vote) rounds each FMA as CUDA does, so the
// two count alike.  A cell issues ~6.4 instructions with the loop (4 FFMA,
// an FSETP on |e|, a predicated IADD, an eighth of an LDS.128), where a
// multiply and four FMAs on two shared loads per point, counted by a C++
// add, issue ~8.5.  On an H100 80GB HBM3 at 700 W (chip_smoke.py) the sweep
// took 1.16 ms at 4,096 groups x 1,024 lanes x 1,024 columns (0.12 ms of it
// on 1 column), where that older kernel took 1.45-1.46 ms and this layout at
// four hypotheses per thread 1.21 ms.

#include "sphere_fit.cuh"
#include "sweep_common.cuh"

namespace {

using lsq_sphere::band_rows;
using lsq_sphere::centred_point;
using lsq_sphere::circumsphere;
using lsq_sphere::Hypothesis;
using lsq_sweep::Consts;

// The family as sweep_common.cuh's fit_hypothesis and finalize_kernel take
// it: four slots of [x, y, z], parameters [cx, cy, cz, r].
struct Sphere3D {
  static constexpr int kSlots = 4, kDim = 3, kParams = 4;
  using Fit = Hypothesis;

  static __device__ __forceinline__ Fit fit(const float s[4][3], const Consts&) {
    return circumsphere(s);
  }

  static __device__ __forceinline__ void params(const Fit& f, float* out) {
    out[0] = f.cx;
    out[1] = f.cy;
    out[2] = f.cz;
    out[3] = f.r;
  }
};

// The sweep in the split-vote layout (sweep_common.cuh) with eight
// hypotheses per thread, so a block owns 256: every thread fits one and
// leaves its band rows a0..a4 in shared memory, then takes the rows of its
// eight (l + 32 q for lane l), and warp w votes on points w, w + 8, ....
// Against four per thread (128 per block, half the threads fitting) this
// halves the blocks, and with them the fit's latency, the staging and the
// publishing per hypothesis, and the shared load per cell.  With o = P's
// column 0, the band rows are formed about o and points are staged 2,048 at
// a time as float4 [x', y', z', |p'|^2] from P's rows 0-2 (p' = p - o; P's
// |p|^2 row is not read); a padding column (row 3, the ones row, is 0) is
// staged with x' = NaN, so every cell of it compares false.  Per cell: four
// FMAs, one compare of |e| against 1 and a predicated add.
constexpr int kSphereHypPerThread = 8;
constexpr int kSphereHypPerBlock = 32 * kSphereHypPerThread;
constexpr int kSphereRows = 5;     // a0 .. a4
constexpr int kSphereTile = 2048;  // points per shared-memory tile: 32 KB
static_assert(kSphereHypPerBlock == lsq_sweep::kSplitThreads, "one fit per thread");
static_assert(lsq_sweep::kSplitWarps * kSphereHypPerBlock * sizeof(int) <=
                  kSphereTile * sizeof(float4),
              "the partial counts reuse the tile");

__global__ void __launch_bounds__(lsq_sweep::kSplitThreads, 3)
sphere3d_kernel(const float* __restrict__ coords, long long coords_stride,
                const float* __restrict__ p, long long p_stride, int vote_cols,
                unsigned n_fit, unsigned num_hyp, int b, int m, unsigned mask, Consts k,
                unsigned long long* __restrict__ best_key) {
  using namespace lsq_sweep;
  constexpr int kHyp = kSphereHypPerThread;
  __shared__ float4 tile[kSphereTile];
  __shared__ float rows[kSphereRows][kSphereHypPerBlock];
  __shared__ bool counts_zero[kSphereHypPerBlock];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned h_first = blockIdx.x * kSphereHypPerBlock;
  const float3 o = lsq_sphere::vote_origin(p, p_stride, vote_cols);
  {
    const unsigned h = h_first + threadIdx.x;
    float a[kSphereRows] = {};  // a slot past the last hypothesis votes on zeros, unpublished
    bool zero = true;
    if (h < num_hyp) {
      const Hypothesis s =
          fit_hypothesis<Sphere3D>(coords, coords_stride, h, n_fit, b, m, mask, k);
      band_rows(s, o, k.delta, a);
      zero = s.degenerate;
    }
#pragma unroll
    for (int i = 0; i < kSphereRows; ++i) rows[i][threadIdx.x] = a[i];
    counts_zero[threadIdx.x] = zero;
  }
  __syncthreads();
  float a0[kHyp], a1[kHyp], a2[kHyp], a3[kHyp], a4[kHyp];
  int count[kHyp];
#pragma unroll
  for (int q = 0; q < kHyp; ++q) {
    const int i = 32 * q + lane;
    a0[q] = rows[0][i];
    a1[q] = rows[1][i];
    a2[q] = rows[2][i];
    a3[q] = rows[3][i];
    a4[q] = rows[4][i];
    count[q] = 0;
  }

  for (int t0 = 0; t0 < vote_cols; t0 += kSphereTile) {
    const int len = min(kSphereTile, vote_cols - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < len; i += kSplitThreads) {
      const int col = t0 + i;
      float4 pt = centred_point(p, p_stride, col, o);
      if (p[3 * p_stride + col] == 0.f) pt.x = __int_as_float(0x7fffffff);
      tile[i] = pt;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = warp; i < len; i += kSplitWarps) {
      const float4 pt = tile[i];
#pragma unroll
      for (int q = 0; q < kHyp; ++q) {
        const float e = __fmaf_rn(a4[q], pt.w, __fmaf_rn(a2[q], pt.z,
                        __fmaf_rn(a1[q], pt.y, __fmaf_rn(a0[q], pt.x, a3[q]))));
        count_below(count[q], fabsf(e), 1.f);
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

// coords f32[12, coords_stride] (coords_stride = 5 n_fit), p f32[5, p_stride],
// best_key u64[1] (scratch), best_out f32[5] = [cx, cy, cz, r, count],
// best_index i64[1]; all contiguous on the current device.  Evaluates
// num_groups * n_fit hypotheses (< 2^32) and enqueues three operations on
// `stream`; returns the first CUDA error, 0 on success.
extern "C" int fused_sweep_sphere3d_launch(
    const float* coords, long long coords_stride, const float* p, long long p_stride,
    int vote_cols, int n_fit, long long num_groups, int b, int m, unsigned mask,
    float delta, unsigned long long* best_key, float* best_out, long long* best_index,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Consts k{0.f, 0.f, delta, 0.f};
  return lsq_sweep::launch_with<Sphere3D>(
      coords, coords_stride, vote_cols, n_fit, num_groups, b, m, mask, k, best_key, best_out,
      best_index, s, [&](unsigned num_hyp) {
        sphere3d_kernel<<<lsq_sweep::ceil_div(num_hyp, kSphereHypPerBlock),
                          lsq_sweep::kSplitThreads, 0, s>>>(
            coords, coords_stride, p, p_stride, vote_cols, static_cast<unsigned>(n_fit),
            num_hyp, b, m, mask, k, best_key);
        return cudaGetLastError();
      });
}

// The sweep kernel's launch shape at num_hyp hypotheses on the current
// device, as lsq_sweep::kernel_shape gives it.
extern "C" int fused_sweep_sphere3d_shape(int num_hyp, int* out) {
  return lsq_sweep::kernel_shape(sphere3d_kernel, lsq_sweep::kSplitThreads,
                                 kSphereHypPerBlock, num_hyp, out);
}
