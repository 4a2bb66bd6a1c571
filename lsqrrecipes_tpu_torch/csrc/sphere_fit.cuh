// The Cramer circumsphere of four points and its affine vote band, shared by
// the sphere kernels (sm_90a): B1's sphere3d sweep
// (fused_sweep_sphere3d.cu) and the per-step sweep and planar fit-and-vote
// (sphere_ransac.cu).
//
// Both follow the TPU kernels' operation order (sphere3d_fit_vote in
// lsqrrecipes_tpu/ops/fused_sweep.py, _make_megakernel and _fused_kernel in
// lsqrrecipes_tpu/ops/sphere_ransac.py, which compute the same expressions)
// with explicit __f*_rn intrinsics, so no multiply-add is contracted and the
// fit is bit for bit the plain PyTorch version's
// (lsqrrecipes_tpu_torch/ops/fused_sweep.py::circumsphere, sphere3d_fit).
// The votes are not the TPU kernels': they expand |p - c|^2 about a point
// of the cloud (vote_origin), the fits about the origin as those do.

#pragma once

#include <cuda_runtime.h>

namespace lsq_sphere {

constexpr float kSphereEps = 1e-9f;

struct Hypothesis {
  float cx, cy, cz, r;
  bool degenerate;
};

// jnp.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Minor of rows with row i and column j removed, with the cofactor sign.
__device__ __forceinline__ float cofactor(const float rows[3][3], int i, int j) {
  const int i1 = i == 0 ? 1 : 0, i2 = i == 2 ? 1 : 2;
  const int j1 = j == 0 ? 1 : 0, j2 = j == 2 ? 1 : 2;
  const float v = __fsub_rn(__fmul_rn(rows[i1][j1], rows[i2][j2]),
                            __fmul_rn(rows[i1][j2], rows[i2][j1]));
  return ((i + j) & 1) ? -v : v;
}

// Circumsphere of p[0..3] from the equal-radius system row_i = p0 - p_(i+1),
// rhs_i = row_i . (p0 + p_(i+1)), centre = adj(rows) rhs / (2 det); lanes with
// |det| < 1e-9 are degenerate and divide by 1 instead.
__device__ __forceinline__ Hypothesis circumsphere(const float p[4][3]) {
  float rows[3][3], rhs[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) rows[i][c] = __fsub_rn(p[0][c], p[i + 1][c]);
    rhs[i] = __fadd_rn(
        __fadd_rn(__fmul_rn(rows[i][0], __fadd_rn(p[0][0], p[i + 1][0])),
                  __fmul_rn(rows[i][1], __fadd_rn(p[0][1], p[i + 1][1]))),
        __fmul_rn(rows[i][2], __fadd_rn(p[0][2], p[i + 1][2])));
  }
  float adj[3][3];  // adj[i][j] = cofactor(j, i)
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) adj[i][j] = cofactor(rows, j, i);
  }
  const float det = __fadd_rn(__fadd_rn(__fmul_rn(rows[0][0], adj[0][0]),
                                        __fmul_rn(rows[0][1], adj[1][0])),
                              __fmul_rn(rows[0][2], adj[2][0]));
  Hypothesis hyp;
  hyp.degenerate = fabsf(det) < kSphereEps;
  const float det2 = hyp.degenerate ? 1.f : __fmul_rn(2.f, det);
  float center[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    center[i] = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(adj[i][0], rhs[0]),
                                              __fmul_rn(adj[i][1], rhs[1])),
                                    __fmul_rn(adj[i][2], rhs[2])),
                          det2);
  }
  const float d0 = __fsub_rn(p[0][0], center[0]);
  const float d1 = __fsub_rn(p[0][1], center[1]);
  const float d2 = __fsub_rn(p[0][2], center[2]);
  hyp.cx = center[0];
  hyp.cy = center[1];
  hyp.cz = center[2];
  hyp.r = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                               __fmul_rn(d2, d2)));
  return hyp;
}

// The votes' centre o: column 0 of the point rows x, y, z at `rows`, each
// `stride` floats apart (a live point: the packers put padding columns
// last), or 0 where there is no column.  Every sphere vote expands |p - c|^2
// about o instead of the origin: 1e4 from the origin ulp(|p|^2) is 32, while
// the band (r + delta)^2 - (r - delta)^2 is 40 at r = 10, delta = 1; about
// a point of the cloud the terms scale with the cloud's extent.  Read on the
// device, so no host sync stalls the caller.
__device__ __forceinline__ float3 vote_origin(const float* __restrict__ rows, long long stride,
                                              long long cols) {
  return cols > 0 ? make_float3(rows[0], rows[stride], rows[2 * stride])
                  : make_float3(0.f, 0.f, 0.f);
}

// Point `col` relative to o as (x', y', z', |p'|^2), |p'|^2 = (x'^2 + y'^2) +
// z'^2 unfused in row order, as the plain versions form it.
__device__ __forceinline__ float4 centred_point(const float* __restrict__ rows, long long stride,
                                                long long col, float3 o) {
  const float x = __fsub_rn(rows[col], o.x);
  const float y = __fsub_rn(rows[stride + col], o.y);
  const float z = __fsub_rn(rows[2 * stride + col], o.z);
  const float pp = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
  return make_float4(x, y, z, pp);
}

// The hypothesis's centre relative to o, c' = c - o, one rounded
// subtraction per component.
__device__ __forceinline__ float3 centre_about(const Hypothesis& s, float3 o) {
  return make_float3(__fsub_rn(s.cx, o.x), __fsub_rn(s.cy, o.y), __fsub_rn(s.cz, o.z));
}

// |c|^2 in coordinate order.
__device__ __forceinline__ float norm_sq(float3 c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(c.x, c.x), __fmul_rn(c.y, c.y)), __fmul_rn(c.z, c.z));
}

// Band rows A = [w(-2c'x), w(-2c'y), w(-2c'z), w|c'|^2 + o, w] of |[x', y',
// z', 1, |p'|^2] . A| < 1 about `origin` (c' = c - origin, p' = p - origin),
// with hi = (r + delta)^2, lo = max(r - delta, 0)^2, w = 2 / (hi - lo),
// o = -(hi + lo) / (hi - lo); degenerate lanes get w = 0, o = 2, so they
// never agree.
__device__ __forceinline__ void band_rows(const Hypothesis& s, float3 origin, float delta,
                                          float a[5]) {
  const float3 c = centre_about(s, origin);
  const float cc = norm_sq(c);
  const float rp = __fadd_rn(s.r, delta);
  const float hi = __fmul_rn(rp, rp);
  const float lo_root = nan_max(__fsub_rn(s.r, delta), 0.f);
  const float lo = __fmul_rn(lo_root, lo_root);
  const float width = nan_max(__fsub_rn(hi, lo), 1e-30f);
  const float w = s.degenerate ? 0.f : __fdiv_rn(2.f, width);
  const float o = s.degenerate ? 2.f : __fdiv_rn(-__fadd_rn(hi, lo), width);
  a[0] = __fmul_rn(w, __fmul_rn(-2.f, c.x));
  a[1] = __fmul_rn(w, __fmul_rn(-2.f, c.y));
  a[2] = __fmul_rn(w, __fmul_rn(-2.f, c.z));
  a[3] = __fadd_rn(__fmul_rn(w, cc), o);
  a[4] = w;
}

}  // namespace lsq_sphere
