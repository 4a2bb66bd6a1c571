// Plane-phantom f32 subspace stage (QR + block inverse iteration),
// hand-written for Hopper (sm_90a).
//
// Replaces lsqrrecipes_tpu/ops/phantom_qr.py::_make_kernel (the pallas_call in
// _qr_invit_call).  For each hypothesis b it takes the float32 homogeneous
// 31x31 system of the k = 31 plane-phantom minimal fit and returns four
// orthonormal vectors whose span holds its null direction:
//   * the Householder R of A, step j: sigma = |col_j below j|^2,
//     alpha = -sign(a_jj) sqrt(sigma), vk = a_jj - alpha, inv_denom =
//     1 / (alpha vk) (0 where alpha vk == 0), v = col_j below j with vk in
//     row j, and every column c >= j takes col_c += v (inv_denom (v . col_c));
//   * the diagonal d_j = alpha_j clamped at max(FLT_EPS max|d|, 1e-6), sign
//     kept, so exact-null and duplicate-row pivots stay finite;
//   * two steps of z = R^{-1} R^{-T} v on four start vectors (a table made on
//     the host), the forward solve one masked-column reduction per step, the
//     backward solve one axpy per step, then normalisation (v rsqrt(max(|v|^2,
//     1e-30))) and Gram-Schmidt.
// Output per hypothesis: [4, 32] (the four vectors, row 31 zero).
//
// What bounds it on an H100: bytes.  Per hypothesis it reads the 31x31 system
// (3,844 bytes of data) and writes 496, against ~5.9e4 f32 operations (4.2e4
// in the QR, 1.6e4 in the eight triangular solves, 2.5e3 in the norms and
// Gram-Schmidt): at 65,536 hypotheses ~0.085 ms of memory time and ~0.058 ms
// of FP32 time.  The TPU kernel put hypotheses on lanes and each column in a
// 32-row sublane band; here:
//   * one warp per hypothesis, lane r holding row r of all 31 columns in
//     registers (lane 31 is the zero pad row), so the whole factorisation and
//     the solves run out of registers with every loop unrolled;
//   * the input is packed hypothesis-major, [B, 31 columns, 32 rows], so a
//     warp reads one column as 128 contiguous bytes;
//   * every sum over rows is a __shfl_xor_sync butterfly (16, 8, 4, 2, 1),
//     which leaves the same bits in every lane (a + b == b + a), so the
//     per-hypothesis scalars (alpha, inv_denom, d_j, the solve coefficients)
//     are warp-uniform with no broadcast; a_jj, y_c and acc_c come from lane c
//     by __shfl_sync;
//   * the four start vectors are solved together, four independent butterflies
//     per step.
// The butterfly shuffles (~4.5e3 per hypothesis) set this kernel's time, far
// above its byte bound; a first kernel that is right comes first.  Every
// product, sum, division and square root is its own correctly rounded
// intrinsic and masks are multiplied in as 0/1 factors, in the plain
// version's order (ops/phantom_qr.py), so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 31;          // columns, and live rows
constexpr int kQ = 4;           // subspace vectors
constexpr int kIters = 2;       // inverse-iteration steps
constexpr int kRows = 32;       // rows per band (row 31 is zero)
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kFltEps = 1.1920929e-07f;

// Sum over the 32 lanes in the order of rows_sum32: lane i adds lane i ^ h.
__device__ __forceinline__ float rsum(float x) {
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, h));
  return x;
}

// x < lo ? lo : x, keeping a NaN as torch.clamp_min does (fmaxf would drop it).
__device__ __forceinline__ float floor_at(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float rsqrt_rn(float x) { return __fdiv_rn(1.f, __fsqrt_rn(x)); }

__device__ __forceinline__ float normalized(float v) {
  return __fmul_rn(v, rsqrt_rn(floor_at(rsum(__fmul_rn(v, v)), 1e-30f)));
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
phantom_qr_kernel(const float* __restrict__ bands, const float* __restrict__ starts,
                  int num_hyp, float* __restrict__ out) {
  const int hyp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (hyp >= num_hyp) return;  // the whole warp leaves together
  const float* a = bands + static_cast<size_t>(hyp) * kN * kRows;

  float col[kN];
#pragma unroll
  for (int c = 0; c < kN; ++c) col[c] = __ldg(a + c * kRows + lane);
  const float live = lane < kN ? 1.f : 0.f;

  // ---- Householder R (columns updated in place; d[j] = alpha_j) ----------
  float d[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float ge = lane >= j ? live : 0.f;
    const float gt = lane > j ? live : 0.f;
    const float onehot = lane == j ? 1.f : 0.f;
    const float cg = __fmul_rn(col[j], ge);
    const float norm = __fsqrt_rn(rsum(__fmul_rn(cg, cg)));
    const float akk = __shfl_sync(kFull, col[j], j);
    const float alpha = akk >= 0.f ? -norm : norm;
    const float vk = __fsub_rn(akk, alpha);
    const float denom = __fmul_rn(alpha, vk);
    const float inv_denom = fabsf(denom) > 0.f ? __fdiv_rn(1.f, denom) : 0.f;
    const float v = __fadd_rn(__fmul_rn(col[j], gt), __fmul_rn(onehot, vk));
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      if (c >= j) {
        const float w = __fmul_rn(inv_denom, rsum(__fmul_rn(v, col[c])));
        col[c] = __fadd_rn(col[c], __fmul_rn(v, w));
      }
    }
    d[j] = alpha;
  }

  // ---- diagonal clamp: floor = max(FLT_EPS max|d|, 1e-6), sign kept -------
  float amax = fabsf(d[0]);
#pragma unroll
  for (int j = 1; j < kN; ++j) {
    const float m = fabsf(d[j]);
    amax = amax < m ? m : amax;
  }
  const float flo = floor_at(__fmul_rn(kFltEps, amax), 1e-6f);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float mag = floor_at(fabsf(d[j]), flo);
    d[j] = d[j] < 0.f ? -mag : mag;
  }

  // Rows above the diagonal of each column: R[0:c, c] (the spent reflectors
  // below it are masked off).
#pragma unroll
  for (int c = 0; c < kN; ++c) col[c] = __fmul_rn(col[c], lane < c ? 1.f : 0.f);

  // ---- block inverse iteration + Gram-Schmidt ----------------------------
  float vs[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) vs[q] = starts[q * kRows + lane];

#pragma unroll 1
  for (int it = 0; it < kIters; ++it) {
    float y[kQ], z[kQ], acc[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) y[q] = z[q] = acc[q] = 0.f;
    // Forward: R^T y = v.
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      const float onehot = lane == c ? 1.f : 0.f;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float s = rsum(__fmul_rn(col[c], y[q]));
        const float vc = __shfl_sync(kFull, vs[q], c);
        const float yc = __fdiv_rn(__fsub_rn(vc, s), d[c]);
        y[q] = __fadd_rn(y[q], __fmul_rn(onehot, yc));
      }
    }
    // Backward: R z = y; z_c's contributions land on rows < c.
#pragma unroll
    for (int c = kN - 1; c >= 0; --c) {
      const float onehot = lane == c ? 1.f : 0.f;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float yc = __shfl_sync(kFull, y[q], c);
        const float ac = __shfl_sync(kFull, acc[q], c);
        const float zc = __fdiv_rn(__fsub_rn(yc, ac), d[c]);
        z[q] = __fadd_rn(z[q], __fmul_rn(onehot, zc));
        acc[q] = __fadd_rn(acc[q], __fmul_rn(col[c], zc));
      }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) vs[q] = normalized(z[q]);
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      float c = vs[q];
#pragma unroll
      for (int p = 0; p < q; ++p) c = __fsub_rn(c, __fmul_rn(rsum(__fmul_rn(vs[p], c)), vs[p]));
      vs[q] = normalized(c);
    }
  }

  float* o = out + static_cast<size_t>(hyp) * kQ * kRows;
#pragma unroll
  for (int q = 0; q < kQ; ++q) o[q * kRows + lane] = vs[q];
}

}  // namespace

extern "C" const char* lsq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bands f32[B, 31, 32] (column c of hypothesis b in rows 0-30, row 31 zero),
// starts f32[4, 32] (row 31 zero), out f32[B, 4, 32]; all contiguous on the
// current device.  Enqueues on `stream` and returns cudaGetLastError().
extern "C" int phantom_qr_launch(const float* bands, const float* starts, int num_hyp,
                                 float* out, void* stream) {
  if (num_hyp <= 0) return 0;
  const int blocks = (num_hyp + kWarpsPerBlock - 1) / kWarpsPerBlock;
  phantom_qr_kernel<<<blocks, 32 * kWarpsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      bands, starts, num_hyp, out);
  return static_cast<int>(cudaGetLastError());
}
