// One sample of one candidate in the candidate-axis homography sweep
// (csrc/sweep_multi.cu).
//
// The arithmetic of the Pallas kernel `multi_candidate_sweep`
// (ransac_tpu/ops/pallas/sweep_multi.py:44-148) in the order of the plain
// version `ransac_tpu_torch.ops.sweep_multi._sweep_plain`: the projective
// frames of the candidate's 4 plane points and of the 4 shared pixels and
// H = B adj(A) (sweep.cuh's det3 / frame / adjugate / solve_frames, whose
// `Exact` order is row 1's: (q - p)(r - p) - (r - p)(q - p)), then the
// division-deferred score of the n points: inlier iff r2 <= thr^2 w^2, MSAC
// term min(r2, thr^2 w^2) / w^2 times the point's weight.  The TPU took an
// approximate reciprocal of w^2.
//
// The policy P (fp32_rn.cuh) rounds the score, Solve the frames and H,
// Proj the projection (u, v, w).  Under `Exact` every operation rounds on its own,
// the quotient is an IEEE division, and the score sums into the plain
// version's 4 accumulator pairs (point p into pair p % 4, summed 0 + 1 + 2 +
// 3): the plain version bit for bit (host build).  The kernel's `Fused`
// issues each product-sum as one FMA, takes min(r2, t) times MUFU's
// reciprocal of w^2, and sums into one pair.

#pragma once

#include "sweep.cuh"

namespace sweep_multi {

constexpr int kMaxPoints = 16;
constexpr int kNAcc = 4;

// One candidate's plane points (sx, sy) and the shared normalized pixels
// (dx, dy) with their weights w, kMaxPoints each.
struct Points {
  const float* sx;
  const float* sy;
  const float* dx;
  const float* dy;
  const float* w;
};

// The score of H on the point (x, y) <-> (px, py) of weight pw, added to one
// accumulator pair.
template <class P, class Proj = P>
RT_FN void score_point(const float H[9], float x, float y, float px, float py,
                       float pw, float thr_sq, float* cnt, float* ms) {
  const float u = Proj::dot_add(H[0], x, H[1], y, H[2]);
  const float v = Proj::dot_add(H[3], x, H[4], y, H[5]);
  const float w = Proj::dot_add(H[6], x, H[7], y, H[8]);
  const float a = P::mad(-px, w, u);  // u - px w
  const float b = P::mad(-py, w, v);
  const float r2 = P::prod_sum(a, a, b, b);
  const float w2 = P::max(P::mul(w, w), 1e-30f);
  const float t = P::mul(thr_sq, w2);
  *cnt = P::add(*cnt, r2 <= t ? pw : 0.0f);
  *ms = P::mad(P::quot(P::min(r2, t), w2), pw, *ms);
}

// MSAC (normalized units), inlier count and packed sample i0 + 16 i1 + 256
// i2 + 4096 i3 of the sample idx of one candidate, scored over its first n
// points; an invalid sample (a frame determinant within 1e-7 of 0) gets
// MSAC 3.4e38 and keeps its count.
template <class P, class Solve = P, class Proj = P>
RT_FN void eval(const int idx[4], const Points& pt, int n, float thr_sq,
                float* msac_out, float* count_out, int* packed_out) {
  constexpr int kAcc = P::kFused ? 1 : kNAcc;
  float sx[4], sy[4], dx[4], dy[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sx[j] = pt.sx[idx[j]];
    sy[j] = pt.sy[idx[j]];
    dx[j] = pt.dx[idx[j]];
    dy[j] = pt.dy[idx[j]];
  }
  float H[9];
  const bool valid = sweep::solve_frames<Solve>(sx, sy, dx, dy, H);
  *packed_out = idx[0] + 16 * idx[1] + 256 * idx[2] + 4096 * idx[3];
  float cnt[kAcc], ms[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    cnt[a] = 0.0f;
    ms[a] = 0.0f;
  }
#pragma unroll
  for (int p = 0; p < kMaxPoints; ++p) {
    if (p < n) {
      score_point<P, Proj>(H, pt.sx[p], pt.sy[p], pt.dx[p], pt.dy[p], pt.w[p], thr_sq,
                           &cnt[p % kAcc], &ms[p % kAcc]);
    }
  }
  float count = cnt[0], msac = ms[0];
#pragma unroll
  for (int a = 1; a < kAcc; ++a) {
    count = P::add(count, cnt[a]);
    msac = P::add(msac, ms[a]);
  }
  *msac_out = valid ? msac : sweep::kInvalid;
  *count_out = count;
}

}  // namespace sweep_multi
