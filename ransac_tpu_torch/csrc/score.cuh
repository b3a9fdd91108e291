// One model of the homography scorer (csrc/score.cu, kernel row 3).
//
// The arithmetic of `_h_score_kernel` (ransac_tpu/ops/pallas/score.py:53-75)
// for one homography, in the order of the plain version
// `ransac_tpu_torch.ops.score._h_plain`: for each of the n real points,
// project (u, v, w) = m (x, y, 1), divide by w with the |w| < 1e-12 guard,
// and add the weighted inlier test and the truncated squared transfer error.
// The TPU divides exactly.  The rounding comes from a policy (fp32_rn.cuh):
// `Exact` is the plain version's arithmetic bit for bit; `Fused`, the
// kernel's, rounds each product-sum once and takes MUFU's reciprocal of w.
// Without __CUDACC__ it builds as host C++ (the CPU tests hold it).

#pragma once

#include "sweep.cuh"

namespace score {

constexpr int kMaxPoints = 16;

// Inlier count and truncated MSAC of the row-major homography m over the
// first n points of p (sweep::Pool: (x, y, px, py) and a weight a point).
template <class P>
RT_FN void homography(const float* m, const sweep::Pool& p, int n,
                      float thr_sq, float* count_out, float* msac_out) {
  float count = 0.0f, msac = 0.0f;
  for (int k = 0; k < n; ++k) {
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

}  // namespace score
