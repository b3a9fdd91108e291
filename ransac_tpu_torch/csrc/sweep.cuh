// One hypothesis of the fused homography-RANSAC sweep (csrc/sweep.cu).
//
// The arithmetic of the Pallas kernel `homography_ransac_sweep`
// (ransac_tpu/ops/pallas/sweep.py:78-208) for one flat hypothesis id, in the
// order of the plain version `ransac_tpu_torch.ops.sweep._sweep_plain`:
// counter-PRNG 4-point sample, sample-mask bit test, division-free
// projective-frame homography H = B adj(A), and division-deferred scoring
// (inlier iff |p' - p w|^2 <= thr^2 w^2; MSAC term min(r2, thr^2 w^2) *
// (1/w^2)) with N_ACC = 8 accumulator pairs, point n into pair n % 8.  The
// TPU took an approximate reciprocal of w^2; this one is exact.

#pragma once

#include "fp32_rn.cuh"

namespace sweep {

constexpr int kMaxPoints = 16;
constexpr int kNAcc = 8;
constexpr float kInvalid = 3.4e38f;

// Normalized points and mask, kMaxPoints each (padded with zeros).
struct Pool {
  const float* sx;
  const float* sy;
  const float* dx;
  const float* dy;
  const float* w;
};

RT_FN float det3(float px, float py, float qx, float qy, float rx, float ry) {
  using namespace rt;
  return sub(mul(sub(qx, px), sub(ry, py)), mul(sub(rx, px), sub(qy, py)));
}

// Projective frame of 4 points: M maps the canonical basis onto them.
// Valid when every determinant is above 1e-7 in magnitude.
RT_FN bool frame(const float* x, const float* y, float M[3][3]) {
  using namespace rt;
  const float d0 = det3(x[0], y[0], x[1], y[1], x[2], y[2]);
  const float l1 = det3(x[3], y[3], x[1], y[1], x[2], y[2]);
  const float l2 = det3(x[0], y[0], x[3], y[3], x[2], y[2]);
  const float l3 = det3(x[0], y[0], x[1], y[1], x[3], y[3]);
  M[0][0] = mul(l1, x[0]); M[0][1] = mul(l2, x[1]); M[0][2] = mul(l3, x[2]);
  M[1][0] = mul(l1, y[0]); M[1][1] = mul(l2, y[1]); M[1][2] = mul(l3, y[2]);
  M[2][0] = l1;            M[2][1] = l2;            M[2][2] = l3;
  return fabsf(d0) > 1e-7f && fabsf(l1) > 1e-7f && fabsf(l2) > 1e-7f &&
         fabsf(l3) > 1e-7f;
}

// The adjugate T of a 3x3 matrix A (sweep.py:166-174).
RT_FN void adjugate(const float A[3][3], float T[3][3]) {
  using namespace rt;
  T[0][0] = sub(mul(A[1][1], A[2][2]), mul(A[1][2], A[2][1]));
  T[0][1] = sub(mul(A[0][2], A[2][1]), mul(A[0][1], A[2][2]));
  T[0][2] = sub(mul(A[0][1], A[1][2]), mul(A[0][2], A[1][1]));
  T[1][0] = sub(mul(A[1][2], A[2][0]), mul(A[1][0], A[2][2]));
  T[1][1] = sub(mul(A[0][0], A[2][2]), mul(A[0][2], A[2][0]));
  T[1][2] = sub(mul(A[0][2], A[1][0]), mul(A[0][0], A[1][2]));
  T[2][0] = sub(mul(A[1][0], A[2][1]), mul(A[1][1], A[2][0]));
  T[2][1] = sub(mul(A[0][1], A[2][0]), mul(A[0][0], A[2][1]));
  T[2][2] = sub(mul(A[0][0], A[1][1]), mul(A[0][1], A[1][0]));
}

// H = B adj(A) from the projective frames A of (sx, sy) and B of (dx, dy):
// the division-free 4-point homography; true when both frames are valid.
RT_FN bool solve_frames(const float* sx, const float* sy, const float* dx,
                        const float* dy, float H[9]) {
  using namespace rt;
  float A[3][3], B[3][3], adj[3][3];
  const bool ok_s = frame(sx, sy, A);
  const bool ok_d = frame(dx, dy, B);
  adjugate(A, adj);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      H[3 * r + c] = add(add(mul(B[r][0], adj[0][c]), mul(B[r][1], adj[1][c])),
                         mul(B[r][2], adj[2][c]));
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

// MSAC (normalized units), inlier count and packed sample of hypothesis
// `flat`; an invalid hypothesis gets (3.4e38, -1).
RT_FN void eval(unsigned flat, const unsigned* seeds, int vmask, int n_points,
                int n_score, float thr_sq, const Pool& p, float* msac_out,
                float* count_out, int* packed_out) {
  using namespace rt;
  int i[4];
  draw_sample<4>(flat, seeds, n_points, i);
  const int ok_bits =
      (vmask >> i[0]) & (vmask >> i[1]) & (vmask >> i[2]) & (vmask >> i[3]);
  float sx[4], sy[4], dx[4], dy[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sx[j] = p.sx[i[j]];
    sy[j] = p.sy[i[j]];
    dx[j] = p.dx[i[j]];
    dy[j] = p.dy[i[j]];
  }
  float H[9];
  const bool ok_h = solve_frames(sx, sy, dx, dy, H);
  const bool valid = (ok_bits & 1) == 1 && ok_h;

  float cnt[kNAcc], ms[kNAcc];
#pragma unroll
  for (int k = 0; k < kNAcc; ++k) {
    cnt[k] = 0.0f;
    ms[k] = 0.0f;
  }
#pragma unroll
  for (int n = 0; n < kMaxPoints; ++n) {
    if (n < n_score) {
      const float x = p.sx[n], y = p.sy[n];
      const float u = add(add(mul(H[0], x), mul(H[1], y)), H[2]);
      const float v = add(add(mul(H[3], x), mul(H[4], y)), H[5]);
      const float w = add(add(mul(H[6], x), mul(H[7], y)), H[8]);
      const float a = sub(u, mul(p.dx[n], w));
      const float b = sub(v, mul(p.dy[n], w));
      const float r2 = add(mul(a, a), mul(b, b));
      const float w2 = max_nan(mul(w, w), 1e-30f);
      const float t = mul(thr_sq, w2);
      const float iw2 = rcp(w2);
      const int k = n % kNAcc;
      cnt[k] = add(cnt[k], r2 <= t ? p.w[n] : 0.0f);
      ms[k] = add(ms[k], mul(mul(min_nan(r2, t), iw2), p.w[n]));
    }
  }
  float count = cnt[0], msac = ms[0];
#pragma unroll
  for (int k = 1; k < kNAcc; ++k) {
    count = add(count, cnt[k]);
    msac = add(msac, ms[k]);
  }
  *msac_out = valid ? msac : kInvalid;
  *count_out = valid ? count : -1.0f;
  *packed_out = i[0] + i[1] * 16 + i[2] * 256 + i[3] * 4096;
}

}  // namespace sweep
