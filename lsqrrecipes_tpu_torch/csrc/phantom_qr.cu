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
// What bounds it on an H100.  Per hypothesis it reads the 31x31 system
// (3,844 bytes of data) and writes 496, against ~5.9e4 f32 operations: at
// 65,536 hypotheses ~0.085 ms of memory time and ~0.058 ms of FP32 time, so
// bytes set the bound.  What sets this kernel's time is the cross-lane
// traffic: every sum over the 32 rows of a column is a reduction across
// lanes, every pivot of a row a broadcast, and a warp-wide shuffle issues
// about once per two clocks per SM (a warp per hypothesis, 5 shuffles per
// sum and ~4,800 per hypothesis, took 2.35 ms at 65,536, that rate's time).
// The design:
//   * a group of kGroup = 16 lanes per hypothesis, two per warp, lane l
//     holding rows l and l + 16 of all 31 columns in registers (row 31 is
//     the zero pad row), every loop unrolled;
//   * a 32-row sum adds in-lane first (halving level 16), then takes
//     log2(kGroup) __shfl_xor_sync steps inside the group: exactly the halving order of linalg.small.rows_sum32 (16, 8,
//     4, 2, 1), so every lane of the group ends with the plain version's
//     bits and the pivot scalars are group-uniform with no broadcast.  A sum
//     costs 4 shuffles shared by two hypotheses: ~2,100 per hypothesis;
//   * a broadcast of row j (a_jj, v_c, y_c, acc_c, d_c) is one
//     __shfl_sync(x[j / kGroup], j % kGroup, kGroup), its indices compile-time
//     constants; the diagonal is kept distributed like a column (d_j in row
//     j), two registers instead of 31;
//   * the four starts are solved two at a time (kQBlock), and
//     __launch_bounds__ asks for 16 one-warp blocks per SM: the column
//     registers, the solve state and the pivots then fit in 128 registers
//     without a spill.  Measured without that request, 16-lane versions got
//     153-165 registers (12 blocks per SM) and ran 1.3x slower at 65,536;
//   * the input is packed hypothesis-major, [B, 31 columns, 32 rows], so a
//     group reads a column's rows l + kGroup m as kGroup contiguous floats;
//   * a group past the last hypothesis computes on zeros and skips only its
//     store, since it must take part in every full-warp shuffle.
// Measured on an H100 80GB HBM3 at 700 W: 1.26-1.37 ms at 65,536 (1.72-1.87x
// faster than a warp per hypothesis, ~1.2x this layout's shuffle time) and
// 0.147-0.149 ms per 4,352-hypothesis chunk, whose 2,176 warps fill 1.03
// waves of 16 per SM.  Eight lanes per hypothesis need 3 shuffles per sum shared by four
// hypotheses but 255 registers, 8 warps per SM, and were slower (1.42-1.45
// ms); asked for 9 blocks per SM they spill but run a chunk in 0.69 waves,
// 0.095 ms, and 65,536 in 1.87 ms.
// Every product, sum, division and square root is its own correctly rounded
// intrinsic and masks are multiplied in as 0/1 factors, in the plain
// version's order (ops/phantom_qr.py), so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 31;          // columns, and live rows
constexpr int kQ = 4;           // subspace vectors
constexpr int kIters = 2;       // inverse-iteration steps
constexpr int kRows = 32;       // rows per band (row 31 is zero)
constexpr int kGroup = 16;      // lanes per hypothesis
constexpr int kPer = kRows / kGroup;  // rows per lane
constexpr int kQBlock = 2;      // starts solved together
constexpr int kThreads = 32;    // one warp per block
constexpr int kHypPerBlock = kThreads / kGroup;
constexpr int kMinBlocks = 16;  // __launch_bounds__' occupancy floor
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kFltEps = 1.1920929e-07f;

// Sums over the group's 32 rows in the order of rows_sum32.  x[m] holds row
// l + kGroup m, so halving level h >= kGroup adds x[m + h / kGroup] to x[m]
// in-lane: the lane's part of the sum.
__device__ __forceinline__ float lane_part(const float (&x)[kPer]) {
  float t[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) t[m] = x[m];
#pragma unroll
  for (int h = kPer / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int m = 0; m < h; ++m) t[m] = __fadd_rn(t[m], t[m + h]);
  }
  return t[0];
}

// The whole sum in every lane of the group: the levels below kGroup add lane
// l ^ h of the group.
__device__ __forceinline__ float rsum(const float (&x)[kPer]) {
  float s = lane_part(x);
#pragma unroll
  for (int h = kGroup / 2; h > 0; h >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, h, kGroup));
  return s;
}

// Row j of a group's vector, in every lane of the group (j a constant).
__device__ __forceinline__ float row(const float (&x)[kPer], int j) {
  return __shfl_sync(kFull, x[j / kGroup], j % kGroup, kGroup);
}

// x < lo ? lo : x, keeping a NaN as torch.clamp_min does (fmaxf would drop it).
__device__ __forceinline__ float floor_at(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float rsqrt_rn(float x) { return __fdiv_rn(1.f, __fsqrt_rn(x)); }

__device__ __forceinline__ void normalize(float (&v)[kPer]) {
  float sq[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) sq[m] = __fmul_rn(v[m], v[m]);
  const float k = rsqrt_rn(floor_at(rsum(sq), 1e-30f));
#pragma unroll
  for (int m = 0; m < kPer; ++m) v[m] = __fmul_rn(v[m], k);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
phantom_qr_kernel(const float* __restrict__ bands, const float* __restrict__ starts,
                  int num_hyp, float* __restrict__ out) {
  const int l = threadIdx.x % kGroup;
  const int hyp = blockIdx.x * kHypPerBlock + threadIdx.x / kGroup;
  const bool owner = hyp < num_hyp;  // else compute on zeros, store nothing
  int r[kPer];                       // the rows this lane holds
#pragma unroll
  for (int m = 0; m < kPer; ++m) r[m] = l + kGroup * m;

  float col[kN][kPer];
  const float* a = bands + static_cast<size_t>(owner ? hyp : 0) * kN * kRows;
#pragma unroll
  for (int c = 0; c < kN; ++c) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) col[c][m] = owner ? __ldg(a + c * kRows + r[m]) : 0.f;
  }

  // ---- Householder R (columns updated in place; dd holds alpha_j in row j)
  float dd[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) dd[m] = 0.f;
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    float sq[kPer], v[kPer];
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const float cg = __fmul_rn(col[j][m], r[m] >= j && r[m] < kN ? 1.f : 0.f);
      sq[m] = __fmul_rn(cg, cg);
    }
    const float norm = __fsqrt_rn(rsum(sq));
    const float akk = row(col[j], j);
    const float alpha = akk >= 0.f ? -norm : norm;
    const float vk = __fsub_rn(akk, alpha);
    const float denom = __fmul_rn(alpha, vk);
    const float inv_denom = fabsf(denom) > 0.f ? __fdiv_rn(1.f, denom) : 0.f;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      v[m] = __fadd_rn(__fmul_rn(col[j][m], r[m] > j && r[m] < kN ? 1.f : 0.f),
                       __fmul_rn(r[m] == j ? 1.f : 0.f, vk));
    }
#pragma unroll
    for (int c = j; c < kN; ++c) {
      float p[kPer];
#pragma unroll
      for (int m = 0; m < kPer; ++m) p[m] = __fmul_rn(v[m], col[c][m]);
      const float w = __fmul_rn(inv_denom, rsum(p));
#pragma unroll
      for (int m = 0; m < kPer; ++m) col[c][m] = __fadd_rn(col[c][m], __fmul_rn(v[m], w));
    }
#pragma unroll
    for (int m = 0; m < kPer; ++m) dd[m] = r[m] == j ? alpha : dd[m];
    const float mag = fabsf(alpha);
    amax = (j == 0 || amax < mag) ? mag : amax;
  }

  // ---- diagonal clamp: floor = max(FLT_EPS max|d|, 1e-6), sign kept -------
  const float flo = floor_at(__fmul_rn(kFltEps, amax), 1e-6f);
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const float mag = floor_at(fabsf(dd[m]), flo);
    dd[m] = dd[m] < 0.f ? -mag : mag;
  }

  // Rows above the diagonal of each column: R[0:c, c] (the spent reflectors
  // below it are masked off).
#pragma unroll
  for (int c = 0; c < kN; ++c) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) col[c][m] = __fmul_rn(col[c][m], r[m] < c ? 1.f : 0.f);
  }

  // ---- block inverse iteration + Gram-Schmidt ----------------------------
  float vs[kQ][kPer];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) vs[q][m] = starts[q * kRows + r[m]];
  }

#pragma unroll 1
  for (int it = 0; it < kIters; ++it) {
#pragma unroll
    for (int q0 = 0; q0 < kQ; q0 += kQBlock) {
      float y[kQBlock][kPer], z[kQBlock][kPer], acc[kQBlock][kPer];
#pragma unroll
      for (int q = 0; q < kQBlock; ++q) {
#pragma unroll
        for (int m = 0; m < kPer; ++m) y[q][m] = z[q][m] = acc[q][m] = 0.f;
      }
      // Forward: R^T y = v.
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        const float dc = row(dd, c);
#pragma unroll
        for (int q = 0; q < kQBlock; ++q) {
          float p[kPer];
#pragma unroll
          for (int m = 0; m < kPer; ++m) p[m] = __fmul_rn(col[c][m], y[q][m]);
          const float s = rsum(p);
          const float vc = row(vs[q0 + q], c);
          const float yc = __fdiv_rn(__fsub_rn(vc, s), dc);
#pragma unroll
          for (int m = 0; m < kPer; ++m) {
            y[q][m] = __fadd_rn(y[q][m], __fmul_rn(r[m] == c ? 1.f : 0.f, yc));
          }
        }
      }
      // Backward: R z = y; z_c's contributions land on rows < c.
#pragma unroll
      for (int c = kN - 1; c >= 0; --c) {
        const float dc = row(dd, c);
#pragma unroll
        for (int q = 0; q < kQBlock; ++q) {
          const float yc = row(y[q], c);
          const float ac = row(acc[q], c);
          const float zc = __fdiv_rn(__fsub_rn(yc, ac), dc);
#pragma unroll
          for (int m = 0; m < kPer; ++m) {
            z[q][m] = __fadd_rn(z[q][m], __fmul_rn(r[m] == c ? 1.f : 0.f, zc));
            acc[q][m] = __fadd_rn(acc[q][m], __fmul_rn(col[c][m], zc));
          }
        }
      }
      // This block's starts are spent: its solutions take their place.
#pragma unroll
      for (int q = 0; q < kQBlock; ++q) {
        normalize(z[q]);
#pragma unroll
        for (int m = 0; m < kPer; ++m) vs[q0 + q][m] = z[q][m];
      }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
#pragma unroll
      for (int p = 0; p < q; ++p) {
        float pc[kPer];
#pragma unroll
        for (int m = 0; m < kPer; ++m) pc[m] = __fmul_rn(vs[p][m], vs[q][m]);
        const float s = rsum(pc);
#pragma unroll
        for (int m = 0; m < kPer; ++m) vs[q][m] = __fsub_rn(vs[q][m], __fmul_rn(s, vs[p][m]));
      }
      normalize(vs[q]);
    }
  }

  if (owner) {
    float* o = out + static_cast<size_t>(hyp) * kQ * kRows;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
#pragma unroll
      for (int m = 0; m < kPer; ++m) o[q * kRows + r[m]] = vs[q][m];
    }
  }
}

int blocks_for(int num_hyp) { return (num_hyp + kHypPerBlock - 1) / kHypPerBlock; }

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
  phantom_qr_kernel<<<blocks_for(num_hyp), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bands, starts, num_hyp, out);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape at num_hyp hypotheses on the current device: out[0..5] =
// registers per thread, local (spill) bytes per thread, threads per block,
// hypotheses per block, blocks, resident blocks per SM.  Returns the CUDA
// error of the queries.
extern "C" int phantom_qr_shape(int num_hyp, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, phantom_qr_kernel);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, phantom_qr_kernel, kThreads, 0);
  }
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = kThreads;
  out[3] = kHypPerBlock;
  out[4] = blocks_for(num_hyp);
  out[5] = per_sm;
  return static_cast<int>(err);
}
