// One model of the scorers (csrc/score.cu): kernel rows 3 (homographies)
// and 4 (poses).
//
// The arithmetic of `_h_score_kernel` and `_pnp_score_kernel`
// (ransac_tpu/ops/pallas/score.py:53-75, :118-144) for one model, in the
// order of the plain versions `ransac_tpu_torch.ops.score._h_plain` and
// `_pnp_plain`.  The rounding comes from a policy (fp32_rn.cuh): `Exact` is
// the plain versions' arithmetic bit for bit; `Fused`, the kernels',
// rounds each product-sum once and takes MUFU's reciprocal.  Without
// __CUDACC__ it builds as host C++ (the CPU tests hold it).
//
// The TPU kernels score 16 rows: the n real points, then padding that is
// one and the same zero point (pixel (0, 0), weight 0).  A finite error
// there adds +0, which changes no bit, but a model with a non-finite entry
// that meets a zero coordinate (inf * 0) gives the padding a NaN error, and
// the TPU's MSAC is NaN.  So a score here reads `rows(n)` rows of its pool:
// the n real points and, when n < 16, that zero row; the pool is zero past
// n.  Counts cannot move (NaN <= thr^2 is false); under `Fused`,
// mad(min(e2, thr^2), 0, msac) is msac exactly for a finite e2, NaN else.

#pragma once

#include "sweep.cuh"
#include "sweep_pnp.cuh"

namespace score {

constexpr int kMaxPoints = 16;

// The rows a score reads: the n real points and the zero row if n < 16.
RT_FN int rows(int n) { return n < kMaxPoints ? n + 1 : n; }

// Inlier count and truncated MSAC of the row-major homography m over the
// rows(n) rows of p (sweep::Pool: (x, y, px, py) and a weight a point,
// zero past n): project (u, v, w) = m (x, y, 1), divide by w with the
// |w| < 1e-12 guard, add the weighted inlier test and the truncated
// squared transfer error.
template <class P>
RT_FN void homography(const float* m, const sweep::Pool& p, int n,
                      float thr_sq, float* count_out, float* msac_out) {
  float count = 0.0f, msac = 0.0f;
  for (int k = 0; k < rows(n); ++k) {
    float q[4];
    sweep::load_point(p.pts, k, q);
    const float u = P::dot_add(m[0], q[0], m[1], q[1], m[2]);
    const float v = P::dot_add(m[3], q[0], m[4], q[1], m[5]);
    const float w = P::dot_add(m[6], q[0], m[7], q[1], m[8]);
    const float inv_w = P::rcp(fabsf(w) < 1e-12f ? 1e-12f : w);
    const float du = P::mad(u, inv_w, -q[2]);  // u / w - px
    const float dv = P::mad(v, inv_w, -q[3]);
    const float e2 = P::prod_sum(du, du, dv, dv);
    count = P::add(count, P::mul(e2 <= thr_sq ? 1.0f : 0.0f, p.w[k]));
    msac = P::mad(P::min(e2, thr_sq), p.w[k], msac);
  }
  *count_out = count;
  *msac_out = msac;
}

// Inlier count and truncated MSAC of the pose m [12] (R row-major, then t)
// over the rows(n) rows of p (sweep_pnp::Table: (X, Y, Z, w) and a
// normalized pixel a point, zero past n): the camera point (xc, yc, zc),
// e^2 = 1e12 where zc <= 1e-6 (behind the camera), else the squared
// residual of (xc / zc, yc / zc).  The camera point and its test keep the
// plain order under either policy (sweep_pnp::row_dot: near the camera
// plane zc is a small difference of O(1) terms); the policy rounds from the
// reciprocal on.
template <class P>
RT_FN void pose(const float* m, const sweep_pnp::Table& p, int n, float thr_sq,
                float* count_out, float* msac_out) {
  const float r[3][4] = {{m[0], m[1], m[2], m[9]},
                         {m[3], m[4], m[5], m[10]},
                         {m[6], m[7], m[8], m[11]}};
  float count = 0.0f, msac = 0.0f;
  for (int k = 0; k < rows(n); ++k) {
    float q[6];
    sweep_pnp::load_point(p, k, q);
    const float xc = sweep_pnp::row_dot<P>(r[0], q);
    const float yc = sweep_pnp::row_dot<P>(r[1], q);
    const float zc = sweep_pnp::row_dot<P>(r[2], q);
    const bool behind = zc <= 1e-6f;
    const float inv_z = P::rcp(behind ? 1.0f : zc);
    const float du = P::mad(xc, inv_z, -q[4]);  // xc / zc - px
    const float dv = P::mad(yc, inv_z, -q[5]);
    const float e2 = behind ? 1e12f : P::prod_sum(du, du, dv, dv);
    count = P::add(count, P::mul(e2 <= thr_sq ? 1.0f : 0.0f, q[3]));
    msac = P::mad(P::min(e2, thr_sq), q[3], msac);
  }
  *count_out = count;
  *msac_out = msac;
}

}  // namespace score
