// One hypothesis of the fused homography-RANSAC sweep (csrc/sweep.cu).
//
// The arithmetic of the Pallas kernel `homography_ransac_sweep`
// (ransac_tpu/ops/pallas/sweep.py:78-208) for one flat hypothesis id, in the
// order of the plain version `ransac_tpu_torch.ops.sweep._sweep_plain`:
// counter-PRNG 4-point sample, sample-mask bit test, division-free
// projective-frame homography H = B adj(A), and division-deferred scoring
// (inlier iff |p' - p w|^2 <= thr^2 w^2; MSAC term min(r2, thr^2 w^2) *
// (1/w^2)).  The TPU took an approximate reciprocal of w^2.
//
// The frame algebra takes its rounding from a policy (fp32_rn.cuh): row 6
// (sweep_large.cuh) and row 8 (sweep_essential_large.cuh) share it with the
// default `Exact`, which rounds every operation in the plain version's
// order.  Row 2's kernel instantiates `Fused`: FMAs where the algebra is a
// product-sum, MUFU's reciprocal, and one accumulator pair per hypothesis
// where `Exact` keeps the plain version's N_ACC = 8 (point n into pair
// n % 8).  One template keeps one copy of the algebra for both.

#pragma once

#include "fp32_rn.cuh"

namespace sweep {

constexpr int kMaxPoints = 16;
constexpr int kNAcc = 8;
constexpr float kInvalid = 3.4e38f;

// The normalized pool of the <= 16-point sweeps (rows 2 and 7), padded with
// zeros to kMaxPoints: point n as (sx, sy, dx, dy) at pts[4n..4n+3], 16-byte
// aligned so that one vector load brings it, and its weight w[n].
struct Pool {
  const float* pts;
  const float* w;
};

RT_FN void load_point(const float* pts, int n, float q[4]) {
#ifdef __CUDACC__
  const float4 v = reinterpret_cast<const float4*>(pts)[n];
  q[0] = v.x;
  q[1] = v.y;
  q[2] = v.z;
  q[3] = v.w;
#else
  for (int c = 0; c < 4; ++c) q[c] = pts[4 * n + c];
#endif
}

template <class P = rt::Exact>
RT_FN float det3(float px, float py, float qx, float qy, float rx, float ry) {
  return P::prod_diff(P::sub(qx, px), P::sub(ry, py), P::sub(rx, px),
                      P::sub(qy, py));
}

// Projective frame of 4 points: M maps the canonical basis onto them.
// Valid when every determinant is above 1e-7 in magnitude.
template <class P = rt::Exact>
RT_FN bool frame(const float* x, const float* y, float M[3][3]) {
  const float d0 = det3<P>(x[0], y[0], x[1], y[1], x[2], y[2]);
  const float l1 = det3<P>(x[3], y[3], x[1], y[1], x[2], y[2]);
  const float l2 = det3<P>(x[0], y[0], x[3], y[3], x[2], y[2]);
  const float l3 = det3<P>(x[0], y[0], x[1], y[1], x[3], y[3]);
  const float l[3] = {l1, l2, l3};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    M[0][c] = P::mul(l[c], x[c]);
    M[1][c] = P::mul(l[c], y[c]);
    M[2][c] = l[c];
  }
  return fabsf(d0) > 1e-7f && fabsf(l1) > 1e-7f && fabsf(l2) > 1e-7f &&
         fabsf(l3) > 1e-7f;
}

// The adjugate T of a 3x3 matrix A (sweep.py:166-174).
template <class P = rt::Exact>
RT_FN void adjugate(const float A[3][3], float T[3][3]) {
  T[0][0] = P::prod_diff(A[1][1], A[2][2], A[1][2], A[2][1]);
  T[0][1] = P::prod_diff(A[0][2], A[2][1], A[0][1], A[2][2]);
  T[0][2] = P::prod_diff(A[0][1], A[1][2], A[0][2], A[1][1]);
  T[1][0] = P::prod_diff(A[1][2], A[2][0], A[1][0], A[2][2]);
  T[1][1] = P::prod_diff(A[0][0], A[2][2], A[0][2], A[2][0]);
  T[1][2] = P::prod_diff(A[0][2], A[1][0], A[0][0], A[1][2]);
  T[2][0] = P::prod_diff(A[1][0], A[2][1], A[1][1], A[2][0]);
  T[2][1] = P::prod_diff(A[0][1], A[2][0], A[0][0], A[2][1]);
  T[2][2] = P::prod_diff(A[0][0], A[1][1], A[0][1], A[1][0]);
}

// H = B adj(A) from the projective frames A of (sx, sy) and B of (dx, dy):
// the division-free 4-point homography; true when both frames are valid.
template <class P = rt::Exact>
RT_FN bool solve_frames(const float* sx, const float* sy, const float* dx,
                        const float* dy, float H[9]) {
  float A[3][3], B[3][3], adj[3][3];
  const bool ok_s = frame<P>(sx, sy, A);
  const bool ok_d = frame<P>(dx, dy, B);
  adjugate<P>(A, adj);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      H[3 * r + c] = P::dot_add(B[r][0], adj[0][c], B[r][1], adj[1][c],
                                P::mul(B[r][2], adj[2][c]));
    }
  }
  return ok_s && ok_d;
}

// Centroid of the first n_points rows of a [n, 2], unmasked, summed in row
// order, and the sum of the distances to it (correctly rounded square
// roots).  out = (centroid x, centroid y, distance sum).
RT_FN void centroid_dist(const float* a, int n_points, float out[3]) {
  using namespace rt;
  const float cnt = static_cast<float>(n_points);
  float sx = a[0], sy = a[1];
  for (int k = 1; k < n_points; ++k) {
    sx = add(sx, a[2 * k]);
    sy = add(sy, a[2 * k + 1]);
  }
  const float mx = div(sx, cnt), my = div(sy, cnt);
  float dsum = 0.0f;
  for (int k = 0; k < n_points; ++k) {
    const float qx = sub(a[2 * k], mx), qy = sub(a[2 * k + 1], my);
    const float d = sqrt_rn(add(mul(qx, qx), mul(qy, qy)));
    dsum = k == 0 ? d : add(dsum, d);
  }
  out[0] = mx;
  out[1] = my;
  out[2] = dsum;
}

// The JAX wrapper's normalization of one point set a [n, 2]
// (ransac_tpu/ops/pallas/sweep.py:279-285): centroid and mean distance over
// the first n_points rows (centroid_dist); scale sqrt(2) / mean distance.
// out = (centroid x, centroid y, scale).
RT_FN void norm_params(const float* a, int n_points, float out[3]) {
  using namespace rt;
  centroid_dist(a, n_points, out);
  out[2] = div(1.4142135623730951f,
               max_nan(div(out[2], static_cast<float>(n_points)), 1e-12f));
}

// Bit n set iff point n (of n) may be sampled.
RT_FN int sample_bitmask(const float* mask, int n) {
  int v = 0;
  for (int k = 0; k < n; ++k) v |= mask[k] > 0.0f ? 1 << k : 0;
  return v;
}

// (threshold * s_dst)^2: the inlier bound in normalized units.
RT_FN float threshold_sq(float threshold, float s_dst) {
  const float t = rt::mul(threshold, s_dst);
  return rt::mul(t, t);
}

// An MSAC record back in pixel^2 units (inv_s2 = 1 / s_dst^2); the invalid
// sentinel stays.
RT_FN float rescale(float msac, float inv_s2) {
  return msac >= 3e38f ? kInvalid : rt::mul(msac, inv_s2);
}

// The division-deferred score of H on pool point q = (sx, sy, dx, dy) of
// weight pw, added to one accumulator pair; the projection (u, v, w) under
// policy Proj, the rest under P.
template <class P, class Proj = P>
RT_FN void score_point(const float H[9], const float q[4], float pw,
                       float thr_sq, float* cnt, float* ms) {
  const float u = Proj::dot_add(H[0], q[0], H[1], q[1], H[2]);
  const float v = Proj::dot_add(H[3], q[0], H[4], q[1], H[5]);
  const float w = Proj::dot_add(H[6], q[0], H[7], q[1], H[8]);
  const float a = P::mad(-q[2], w, u);  // u - dx w
  const float b = P::mad(-q[3], w, v);
  const float r2 = P::prod_sum(a, a, b, b);
  const float w2 = P::max(P::mul(w, w), 1e-30f);
  const float t = P::mul(thr_sq, w2);
  const float iw2 = P::rcp(w2);
  *cnt = P::add(*cnt, r2 <= t ? pw : 0.0f);
  *ms = P::mad(P::mul(P::min(r2, t), iw2), pw, *ms);
}

// MSAC (normalized units), inlier count and packed sample of the K
// hypotheses flat0 + k * step (k < K), drawn with divs[j] = n_points - j;
// an invalid hypothesis gets (3.4e38, -1).  Each pool point is loaded once
// and scored against the K homographies.
template <class P, int K>
RT_FN void eval(unsigned flat0, unsigned step, const unsigned* seeds,
                const rt::Divider* divs, int vmask, int n_score, float thr_sq,
                const Pool& p, float* msac_out, float* count_out,
                int* packed_out) {
  constexpr int kAcc = P::kFused ? 1 : kNAcc;
  float H[K][9];
  bool valid[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int i[4];
    rt::draw_sample_fast<4>(flat0 + k * step, seeds, divs, i);
    const int ok_bits =
        (vmask >> i[0]) & (vmask >> i[1]) & (vmask >> i[2]) & (vmask >> i[3]);
    float sx[4], sy[4], dx[4], dy[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float q[4];
      load_point(p.pts, i[j], q);
      sx[j] = q[0];
      sy[j] = q[1];
      dx[j] = q[2];
      dy[j] = q[3];
    }
    const bool ok_h = solve_frames<P>(sx, sy, dx, dy, H[k]);
    valid[k] = (ok_bits & 1) == 1 && ok_h;
    packed_out[k] = i[0] + i[1] * 16 + i[2] * 256 + i[3] * 4096;
  }

  float cnt[K][kAcc], ms[K][kAcc];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      cnt[k][a] = 0.0f;
      ms[k][a] = 0.0f;
    }
  }
#pragma unroll
  for (int n = 0; n < kMaxPoints; ++n) {
    if (n < n_score) {
      float q[4];
      load_point(p.pts, n, q);
      const float pw = p.w[n];
#pragma unroll
      for (int k = 0; k < K; ++k)
        score_point<P>(H[k], q, pw, thr_sq, &cnt[k][n % kAcc], &ms[k][n % kAcc]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float count = cnt[k][0], msac = ms[k][0];
#pragma unroll
    for (int a = 1; a < kAcc; ++a) {
      count = P::add(count, cnt[k][a]);
      msac = P::add(msac, ms[k][a]);
    }
    msac_out[k] = valid[k] ? msac : kInvalid;
    count_out[k] = valid[k] ? count : -1.0f;
  }
}

}  // namespace sweep
