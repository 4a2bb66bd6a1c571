// The crosswire calibration's residual and Jacobian, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package takes the Jacobian of
// lsqrrecipes_tpu/estimators/us_calibration.py::_crosswire_residual by
// jax.jacfwd, and XLA fuses that under jit into a few kernels.  The port's
// Levenberg-Marquardt loop runs eagerly, where torch.func.jacfwd of the same
// residual was about 200 small launches a step.  This kernel evaluates the
// closed form of
// lsqrrecipes_tpu_torch/estimators/us_calibration.py::_crosswire_residual_plain
// and ::_crosswire_jacobian_plain instead.
//
// For x = [t1 3, t3 3, w_z, w_y, w_x, m_x, m_y], R = Rz(w_z) Ry(w_y) Rx(w_x)
// with columns c0, c1, c2, and image i's pixel (u, v) and tracked pose
// (R2_i, t2_i):
//   p_i = u m_x c0 + v m_y c1 + t3,   r_i = R2_i p_i + t2_i - t1   (3 rows);
//   dr_i/dt1 = -I, dr_i/dt3 = R2_i,
//   dr_i/dw_k = R2_i (u m_x dc0/dw_k + v m_y dc1/dw_k)  (dc0/dw_x = 0,
//   dc1/dw_x = c2), dr_i/dm_x = R2_i (u c0), dr_i/dm_y = R2_i (v c1).
//
// What bounds it: launch latency.  At n = 1,024 images it reads about
// 115 KB (R2, t2, q: 112 bytes an image in float64) and writes 270 KB
// (the 3n x 11 Jacobian) or 24 KB (the residual): 0.1 us at the card's
// bandwidth, against a few microseconds to launch.  So the design is one
// launch where there were about 200:
//   * one thread per image, 128 per block; a second grid axis over the
//     leading problems (lsq_fit_batched), so a batch launches once too;
//   * every thread builds R and its angle derivatives from x on the device,
//     so the host never reads x;
//   * templated on float and double: it computes in the data's dtype;
//   * one entry for both outputs: a null residual or Jacobian pointer
//     skips that output, so the LM's residual and Jacobian calls are one
//     launch each.
// Each thread writes its 3 x 11 rows of the row-major Jacobian in one
// stretch of 264 bytes.  Every product, sum and difference is rounded on
// its own (no FMA contraction), in the plain version's order, so on the
// card the two are equal bit for bit; on the host, sin and cos may round
// their last bit differently.  That matters beyond the last bit: the LM's
// stop tests at ftol 1e-15 read cost changes near the cost's own rounding,
// so another rounding of the residual (FMAs, another order of the 3 x 3
// sums) can end the refit a step earlier or later along a flat direction
// of the minimum: 3.4e-10 of a parameter's scale from the CPU's fit on one
// of eight data sets, where the card's other routes stayed within 5e-12.
// The float64 instantiation takes 72 registers and a 40-byte stack frame,
// which only the library's reduction of huge angles in sincos touches.

#include <cuda_runtime.h>
#include <math.h>

#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kParams = 11;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ void sin_cos(double a, double* s, double* c) { sincos(a, s, c); }
__device__ __forceinline__ void sin_cos(float a, float* s, float* c) { sincosf(a, s, c); }

// Rounded products, sums and differences that nvcc may not contract into
// FMAs: the plain version rounds each one.
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// (a0 b0 + a1 b1) + a2 b2, each step rounded.
template <typename T>
__device__ __forceinline__ T dot3(const T* a, T b0, T b1, T b2) {
  return add(add(mul(a[0], b0), mul(a[1], b1)), mul(a[2], b2));
}

// x[B, 11], r2[B, n, 3, 3], t2[B, n, 3], q[B, n, 2]; res[B, 3n] and
// jac[B, 3n, 11], either may be null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
crosswire_residual_kernel(const T* __restrict__ x, const T* __restrict__ r2,
                          const T* __restrict__ t2, const T* __restrict__ q, int num_problems,
                          int n, T* __restrict__ res, T* __restrict__ jac) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  for (long long b = blockIdx.y; b < num_problems; b += gridDim.y) {
    const T* xb = x + b * kParams;
    T sz, cz, sy, cy, sx, cx;
    sin_cos(xb[6], &sz, &cz);
    sin_cos(xb[7], &sy, &cy);
    sin_cos(xb[8], &sx, &cx);
    const T mx = xb[9], my = xb[10];
    // R's columns, in the plain version's order of operations.
    const T c0[3] = {mul(cz, cy), mul(sz, cy), -sy};
    const T c1[3] = {sub(mul(mul(cz, sy), sx), mul(sz, cx)),
                     add(mul(mul(sz, sy), sx), mul(cz, cx)), mul(cy, sx)};

    const long long img = b * n + i;
    const T* rb = r2 + img * 9;
    T rot[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) rot[k] = __ldg(rb + k);
    const T u = __ldg(q + img * 2), v = __ldg(q + img * 2 + 1);
    const long long row = img * 3;

    if (res != nullptr) {
      T p[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p[k] = add(add(mul(u, mul(mx, c0[k])), mul(v, mul(my, c1[k]))), xb[3 + k]);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        res[row + k] = sub(add(dot3(rot + 3 * k, p[0], p[1], p[2]), __ldg(t2 + img * 3 + k)),
                           xb[k]);
      }
    }
    if (jac != nullptr) {
      const T c2[3] = {add(mul(mul(cz, sy), cx), mul(sz, sx)),
                       sub(mul(mul(sz, sy), cx), mul(cz, sx)), mul(cy, cx)};
      const T dc0y[3] = {mul(-cz, sy), mul(-sz, sy), -cy};
      const T dc1y[3] = {mul(mul(cz, cy), sx), mul(mul(sz, cy), sx), mul(-sy, sx)};
      const T umx = mul(u, mx), vmy = mul(v, my);
      // The image point's derivative along w_z, w_y, w_x, m_x and m_y.
      T d[5][3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const T dc0z = k == 0 ? -c0[1] : (k == 1 ? c0[0] : T(0));
        const T dc1z = k == 0 ? -c1[1] : (k == 1 ? c1[0] : T(0));
        d[0][k] = add(mul(umx, dc0z), mul(vmy, dc1z));
        d[1][k] = add(mul(umx, dc0y[k]), mul(vmy, dc1y[k]));
        d[2][k] = mul(vmy, c2[k]);
        d[3][k] = mul(u, c0[k]);
        d[4][k] = mul(v, c1[k]);
      }
      T* jb = jac + row * kParams;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        T* out = jb + k * kParams;
        const T* rk = rot + 3 * k;
        out[0] = k == 0 ? T(-1) : T(0);
        out[1] = k == 1 ? T(-1) : T(0);
        out[2] = k == 2 ? T(-1) : T(0);
        out[3] = rk[0];
        out[4] = rk[1];
        out[5] = rk[2];
#pragma unroll
        for (int c = 0; c < 5; ++c) out[6 + c] = dot3(rk, d[c][0], d[c][1], d[c][2]);
      }
    }
  }
}

}  // namespace

extern "C" const char* lsq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x[B, 11], r2[B, n, 3, 3], t2[B, n, 3], q[B, n, 2], res[B, 3n] and
// jac[B, 3n, 11] (either null to skip it); all contiguous on the current
// device, float64 if is_double, else float32.  Enqueues on `stream` and
// returns cudaGetLastError().
extern "C" int us_crosswire_launch(const void* x, const void* r2, const void* t2, const void* q,
                                   int num_problems, int n, int is_double, void* res, void* jac,
                                   void* stream) {
  if (num_problems <= 0 || n <= 0 || (res == nullptr && jac == nullptr)) return 0;
  const dim3 grid((n + kThreads - 1) / kThreads,
                  num_problems < kMaxGridY ? num_problems : kMaxGridY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    crosswire_residual_kernel<double><<<grid, kThreads, 0, s>>>(
        static_cast<const double*>(x), static_cast<const double*>(r2),
        static_cast<const double*>(t2), static_cast<const double*>(q), num_problems, n,
        static_cast<double*>(res), static_cast<double*>(jac));
  } else {
    crosswire_residual_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(r2),
        static_cast<const float*>(t2), static_cast<const float*>(q), num_problems, n,
        static_cast<float*>(res), static_cast<float*>(jac));
  }
  return static_cast<int>(cudaGetLastError());
}

// The float64 kernel's launch shape at num_hyp images of one problem
// (lsq_sweep::kernel_shape: its "hypotheses" are images here).
extern "C" int us_crosswire_shape(int num_hyp, int* out) {
  return lsq_sweep::kernel_shape(crosswire_residual_kernel<double>, kThreads, kThreads, num_hyp,
                                 out);
}
