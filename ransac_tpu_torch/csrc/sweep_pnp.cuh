// One sample of the fused P3P-RANSAC sweep (csrc/sweep_pnp.cu).
//
// The arithmetic of the Pallas kernel `pnp_ransac_sweep`
// (ransac_tpu/ops/pallas/sweep_pnp.py:84-380) for one flat sample id, in the
// order of the plain version `ransac_tpu_torch.ops.sweep_pnp._sweep_plain`:
// counter-PRNG 3-point sample and mask bit test; Grunert's P3P (law of
// cosines, resultant quartic solved by a Newton resolvent cubic from a
// Fujiwara bound, Ferrari, 2 Newton polish steps per root); one Newton depth
// polish; the triad orientation with the world triad and its invariants
// computed once and shared by the four camera triads; and the
// division-deferred score of each of the four roots in fx-normalized,
// pixel-true units (the pool's y is pre-scaled by ay, the pose's y-row here).
// The TPU took approximate reciprocals; every reciprocal here is an exact
// division.  rsqrt is rsqrtf on the device; the plain version's torch.rsqrt
// is the same function there.

#pragma once

#include "fp32_rn.cuh"

namespace sweep_pnp {

constexpr int kMaxPoints = 16;
constexpr int kRoots = 4;
constexpr int kCubicNewton = 12;
constexpr int kQuarticPolish = 2;
constexpr int kDepthPolish = 1;
constexpr float kBig = 3.4e38f;
constexpr float kFar = 3.0e38f;

// World points, unit bearings, (x, ay * y) normalized pixels and mask,
// kMaxPoints each (padded with zeros).
struct Pool {
  const float* X;
  const float* Y;
  const float* Z;
  const float* fx;
  const float* fy;
  const float* fz;
  const float* px;
  const float* py;
  const float* w;
};

// Cheap upper bound on cbrt(x), x >= 0: exponent-third bit trick times 1.1
// (sweep_pnp.py:76-81).
RT_FN float cbrt_upper(float x) {
  using namespace rt;
  const int xi = as_int(max_nan(x, 1e-30f));
  return mul(as_float(xi / 3 + 0x2A514067), 1.1f);
}

RT_FN float guard(float x, float eps) { return fabsf(x) < eps ? eps : x; }

// Real roots of x^4 + b x^3 + c x^2 + d x + e (sweep_pnp.py:84-149).
RT_FN void solve_quartic(float b, float c, float d, float e, float* roots,
                         bool* ok) {
  using namespace rt;
  const float shift = div(b, 4.0f);
  const float b2 = mul(b, b);
  const float p = sub(c, div(mul(3.0f, b2), 8.0f));
  const float q = add(sub(d, div(mul(b, c), 2.0f)), div(mul(b2, b), 8.0f));
  const float r = sub(add(sub(e, div(mul(b, d), 4.0f)), div(mul(b2, c), 16.0f)),
                      div(mul(mul(3.0f, b2), b2), 256.0f));
  const float cb = p;
  const float cc = sub(div(mul(p, p), 4.0f), r);
  const float cd = div(mul(-q, q), 8.0f);
  float m = add(mul(2.0f, max_nan(fabsf(cb), max_nan(sqrt_rn(fabsf(cc)),
                                                      cbrt_upper(fabsf(cd))))),
                1e-6f);
#pragma unroll 1
  for (int it = 0; it < kCubicNewton; ++it) {
    const float f = add(mul(add(mul(add(m, cb), m), cc), m), cd);
    const float df = add(mul(add(mul(3.0f, m), mul(2.0f, cb)), m), cc);
    const float rdf = rcp(guard(df, 1e-20f));
    const float t = mul(f, rdf);
    m = sub(m, clip(t, -1e6f, 1e6f));
  }
  m = max_nan(m, 1e-12f);
  const float s = sqrt_rn(mul(2.0f, m));
  const float q_term = mul(mul(q, 0.5f), rcp(s));
  const float base = add(div(p, 2.0f), m);
#pragma unroll
  for (int si = 0; si < 2; ++si) {
    const float sign = si == 0 ? 1.0f : -1.0f;
    const float ccq = add(base, mul(sign, q_term));
    const float disc2 = sub(div(mul(s, s), 4.0f), ccq);
    const bool good = disc2 >= 0.0f;
    const float sq2 = sqrt_rn(max_nan(disc2, 0.0f));
#pragma unroll
    for (int pi = 0; pi < 2; ++pi) {
      const float pm = pi == 0 ? 1.0f : -1.0f;
      roots[2 * si + pi] =
          sub(add(div(mul(sign, s), 2.0f), mul(pm, sq2)), shift);
      ok[2 * si + pi] = good;
    }
  }
#pragma unroll
  for (int i = 0; i < kRoots; ++i) {
    float x = roots[i];
#pragma unroll
    for (int it = 0; it < kQuarticPolish; ++it) {
      const float f = add(mul(add(mul(add(mul(add(x, b), x), c), x), d), x), e);
      const float df =
          add(mul(add(mul(add(mul(4.0f, x), mul(3.0f, b)), x), mul(2.0f, c)), x), d);
      x = sub(x, mul(f, rcp(guard(df, 1e-20f))));
    }
    roots[i] = x;
  }
}

RT_FN float dot3(const float* a, const float* b) {
  using namespace rt;
  return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
}

RT_FN void sub3(const float* a, const float* b, float* o) {
  using namespace rt;
  o[0] = sub(a[0], b[0]);
  o[1] = sub(a[1], b[1]);
  o[2] = sub(a[2], b[2]);
}

RT_FN void cross3(const float* a, const float* b, float* o) {
  using namespace rt;
  o[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  o[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  o[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

// MSAC and count of each of the four roots of the sample of world points
// P[j] and unit bearings F[j], scored over the first n_score pool rows; an
// invalid root (or any root of an invalid sample) gets (3.4e38, -1).
RT_FN void solve_and_score(const float P[3][3], const float F[3][3],
                           bool sample_valid, int n_score, float thr_sq,
                           float ay, const Pool& pool, float* msac_out,
                           float* count_out) {
  using namespace rt;
  const float cos_a = dot3(F[1], F[2]);
  const float cos_b = dot3(F[0], F[2]);
  const float cos_g = dot3(F[0], F[1]);
  float d12[3], d02[3], d01[3];
  sub3(P[1], P[2], d12);
  sub3(P[0], P[2], d02);
  sub3(P[0], P[1], d01);
  const float a2 = dot3(d12, d12);
  const float b2 = max_nan(dot3(d02, d02), 1e-12f);
  const float c2 = dot3(d01, d01);
  const float rb2 = rcp(b2);
  const float ra = mul(a2, rb2);
  const float rc = mul(c2, rb2);

  const float qa2 = ra, qa1 = mul(mul(-2.0f, ra), cos_b), qa0 = ra;
  const float qc2 = rc, qc1 = mul(mul(-2.0f, rc), cos_b), qc0 = rc;
  const float n2 = add(sub(1.0f, qa2), qc2);
  const float n1 = add(-qa1, qc1);
  const float n0 = add(sub(-qa0, 1.0f), qc0);
  const float p2 = -qc2, p1 = -qc1, p0 = sub(1.0f, qc0);
  const float d1 = mul(2.0f, cos_a), d0 = mul(-2.0f, cos_g);
  const float g2 = mul(2.0f, cos_g);

  const float c4 = add(mul(n2, n2), mul(mul(p2, d1), d1));
  const float c3 = add(add(sub(mul(mul(2.0f, n2), n1), mul(g2, mul(n2, d1))),
                           mul(mul(mul(2.0f, p2), d1), d0)),
                       mul(mul(p1, d1), d1));
  const float c2q =
      add(add(add(sub(add(mul(mul(2.0f, n2), n0), mul(n1, n1)),
                      mul(g2, add(mul(n2, d0), mul(n1, d1)))),
                  mul(mul(p2, d0), d0)),
              mul(mul(mul(2.0f, p1), d1), d0)),
          mul(mul(p0, d1), d1));
  const float c1 = add(add(sub(mul(mul(2.0f, n1), n0),
                               mul(g2, add(mul(n1, d0), mul(n0, d1)))),
                           mul(mul(p1, d0), d0)),
                       mul(mul(mul(2.0f, p0), d1), d0));
  const float c0 = add(sub(mul(n0, n0), mul(g2, mul(n0, d0))),
                       mul(mul(p0, d0), d0));
  const float c4s = guard(c4, 1e-12f);
  float roots[kRoots];
  bool root_ok[kRoots];
  solve_quartic(div(c3, c4s), div(c2q, c4s), div(c1, c4s), div(c0, c4s),
                roots, root_ok);

  const float sb = sqrt_rn(b2);
  // World triad and its invariants, shared by the four camera triads.
  float u1w[3], v1w[3], e1w[3], e2w[3], e3w[3], vpw[3], cw[3];
  sub3(P[1], P[0], u1w);
  const float i1w = rsqrt32(add(dot3(u1w, u1w), 1e-30f));
#pragma unroll
  for (int c = 0; c < 3; ++c) e1w[c] = mul(u1w[c], i1w);
  sub3(P[2], P[0], v1w);
  const float dw = dot3(v1w, e1w);
#pragma unroll
  for (int c = 0; c < 3; ++c) vpw[c] = sub(v1w[c], mul(dw, e1w[c]));
  const float i2w = rsqrt32(add(dot3(vpw, vpw), 1e-30f));
#pragma unroll
  for (int c = 0; c < 3; ++c) e2w[c] = mul(vpw[c], i2w);
  cross3(e1w, e2w, e3w);
#pragma unroll
  for (int c = 0; c < 3; ++c) cw[c] = div(add(add(P[0][c], P[1][c]), P[2][c]), 3.0f);

#pragma unroll 1
  for (int k = 0; k < kRoots; ++k) {
    const float v = roots[k];
    const float D = add(mul(d1, v), d0);
    const float N = add(mul(add(mul(n2, v), n1), v), n0);
    const float u = mul(N, rcp(guard(D, 1e-9f)));
    float s1 = mul(sb, rsqrt32(max_nan(
        sub(add(1.0f, mul(v, v)), mul(mul(2.0f, v), cos_b)), 1e-12f)));
    float s2 = mul(u, s1);
    float s3 = mul(v, s1);
    bool valid = sample_valid && root_ok[k] && v > 1e-6f && u > 1e-6f &&
                 fabsf(D) > 1e-9f;
#pragma unroll
    for (int it = 0; it < kDepthPolish; ++it) {
      const float r1 = sub(sub(add(mul(s2, s2), mul(s3, s3)),
                               mul(mul(mul(2.0f, s2), s3), cos_a)), a2);
      const float r2 = sub(sub(add(mul(s1, s1), mul(s3, s3)),
                               mul(mul(mul(2.0f, s1), s3), cos_b)), b2);
      const float r3 = sub(sub(add(mul(s1, s1), mul(s2, s2)),
                               mul(mul(mul(2.0f, s1), s2), cos_g)), c2);
      const float j12 = sub(mul(2.0f, s2), mul(mul(2.0f, s3), cos_a));
      const float j13 = sub(mul(2.0f, s3), mul(mul(2.0f, s2), cos_a));
      const float j21 = sub(mul(2.0f, s1), mul(mul(2.0f, s3), cos_b));
      const float j23 = sub(mul(2.0f, s3), mul(mul(2.0f, s1), cos_b));
      const float j31 = sub(mul(2.0f, s1), mul(mul(2.0f, s2), cos_g));
      const float j32 = sub(mul(2.0f, s2), mul(mul(2.0f, s1), cos_g));
      const float det = add(mul(-j12, sub(0.0f, mul(j23, j31))),
                            mul(j13, sub(mul(j21, j32), 0.0f)));
      const float rdet = rcp(guard(det, 1e-9f));
      const float b1 = -r1, b2r = -r2, b3 = -r3;
      const float ds1 = mul(add(sub(mul(b1, sub(0.0f, mul(j23, j32))),
                                    mul(j12, sub(mul(b2r, 0.0f), mul(j23, b3)))),
                                mul(j13, sub(mul(b2r, j32), mul(0.0f, b3)))),
                            rdet);
      const float ds2 = mul(add(sub(0.0f, mul(b1, sub(mul(j21, 0.0f), mul(j23, j31)))),
                                mul(j13, sub(mul(j21, b3), mul(b2r, j31)))),
                            rdet);
      const float ds3 = mul(add(sub(0.0f, mul(j12, sub(mul(j21, b3), mul(b2r, j31)))),
                                mul(b1, sub(mul(j21, j32), 0.0f))),
                            rdet);
      const float lim = add(mul(0.1f, fabsf(s1)), 1e-6f);
      s1 = add(s1, clip(ds1, -lim, lim));
      s2 = add(s2, clip(ds2, -lim, lim));
      s3 = add(s3, clip(ds3, -lim, lim));
    }
    valid = valid && s1 > 0.0f && s2 > 0.0f && s3 > 0.0f;

    // Camera-frame points and the camera triad (world invariants reused).
    float C[3][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      C[0][c] = mul(F[0][c], s1);
      C[1][c] = mul(F[1][c], s2);
      C[2][c] = mul(F[2][c], s3);
    }
    float u1[3], v1[3], e1[3], e2[3], e3[3];
    sub3(C[1], C[0], u1);
#pragma unroll
    for (int c = 0; c < 3; ++c) e1[c] = mul(u1[c], i1w);
    sub3(C[2], C[0], v1);
#pragma unroll
    for (int c = 0; c < 3; ++c) e2[c] = mul(sub(v1[c], mul(dw, e1[c])), i2w);
    cross3(e1, e2, e3);
    float R[3][3], t[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        R[r][c] = add(add(mul(e1[r], e1w[c]), mul(e2[r], e2w[c])),
                      mul(e3[r], e3w[c]));
      }
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float ccm = div(add(add(C[0][r], C[1][r]), C[2][r]), 3.0f);
      t[r] = sub(ccm, add(add(mul(R[r][0], cw[0]), mul(R[r][1], cw[1])),
                          mul(R[r][2], cw[2])));
    }
    const float Ry0 = mul(R[1][0], ay), Ry1 = mul(R[1][1], ay);
    const float Ry2 = mul(R[1][2], ay), ty = mul(t[1], ay);

    float count = 0.0f, msac = 0.0f;
    for (int n = 0; n < n_score; ++n) {
      const float Xx = pool.X[n], Xy = pool.Y[n], Xz = pool.Z[n];
      const float xc = add(add(add(mul(R[0][0], Xx), mul(R[0][1], Xy)),
                               mul(R[0][2], Xz)), t[0]);
      const float yc = add(add(add(mul(Ry0, Xx), mul(Ry1, Xy)), mul(Ry2, Xz)), ty);
      const float zc = add(add(add(mul(R[2][0], Xx), mul(R[2][1], Xy)),
                               mul(R[2][2], Xz)), t[2]);
      const bool behind = zc <= 1e-6f;
      const float a_ = sub(xc, mul(pool.px[n], zc));
      const float b_ = sub(yc, mul(pool.py[n], zc));
      float r2 = add(mul(a_, a_), mul(b_, b_));
      const float z2 = max_nan(mul(zc, zc), 1e-30f);
      const float t2 = mul(thr_sq, z2);
      r2 = behind ? kFar : r2;
      count = add(count, r2 <= t2 ? pool.w[n] : 0.0f);
      msac = add(msac, mul(mul(min_nan(r2, t2), rcp(z2)), pool.w[n]));
    }
    msac_out[k] = valid ? msac : kBig;
    count_out[k] = valid ? count : -1.0f;
  }
}

// MSAC and count of each of the four roots of sample `flat`, and the
// packed sample i0 + 16 i1 + 256 i2; an invalid root gets (3.4e38, -1).
RT_FN void eval(unsigned flat, const unsigned* seeds, int vmask, int n_points,
                int n_score, float thr_sq, float ay, const Pool& pool,
                float* msac_out, float* count_out, int* packed_out) {
  int i[3];
  rt::draw_sample<3>(flat, seeds, n_points, i);
  const bool sample_valid =
      (((vmask >> i[0]) & (vmask >> i[1]) & (vmask >> i[2])) & 1) == 1;
  float P[3][3], F[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    P[j][0] = pool.X[i[j]];
    P[j][1] = pool.Y[i[j]];
    P[j][2] = pool.Z[i[j]];
    F[j][0] = pool.fx[i[j]];
    F[j][1] = pool.fy[i[j]];
    F[j][2] = pool.fz[i[j]];
  }
  *packed_out = i[0] + i[1] * 16 + i[2] * 256;
  solve_and_score(P, F, sample_valid, n_score, thr_sq, ay, pool, msac_out,
                  count_out);
}

// Best of the four roots under both rules, in root order (sweep_pnp.py:
// 387-395): A by min MSAC, B by (max count, min MSAC).
RT_FN void best_roots(const float* msac, const float* count, float* a_msac,
                      float* a_count, int* a_root, float* b_msac,
                      float* b_count, int* b_root) {
  *a_msac = kBig; *a_count = -1.0f; *a_root = 0;
  *b_msac = kBig; *b_count = -1.0f; *b_root = 0;
#pragma unroll
  for (int k = 0; k < kRoots; ++k) {
    if (msac[k] < *a_msac) {
      *a_count = count[k];
      *a_root = k;
    }
    *a_msac = rt::min_nan(msac[k], *a_msac);
    if (count[k] > *b_count || (count[k] == *b_count && msac[k] < *b_msac)) {
      *b_count = count[k];
      *b_msac = msac[k];
      *b_root = k;
    }
  }
}

}  // namespace sweep_pnp
