// One sample of the P3P-RANSAC sweeps (csrc/sweep_pnp.cu, and the large-pool
// csrc/sweep_pnp_large.cu), in two parts.
//
// `solve_poses` is the arithmetic of the Pallas kernel `pnp_ransac_sweep`
// (ransac_tpu/ops/pallas/sweep_pnp.py:84-380) up to the poses, in the order
// of the plain version `ransac_tpu_torch.ops.sweep_pnp.solve_poses`:
// Grunert's P3P (law of cosines, resultant quartic solved by a Newton
// resolvent cubic from a Fujiwara bound, Ferrari, 2 Newton polish steps per
// root); one Newton depth polish; the triad orientation with the world triad
// and its invariants computed once and shared by the four camera triads.
// Each root gives a pose (R, t with the y row scaled by ay) and a validity.
// `score_pose` is the division-deferred score of one pose over the pool in
// fx-normalized, pixel-true units (the pool's y is pre-scaled by ay).  The
// kernels score only the valid poses; an invalid one's record is the
// constant (3.4e38, -1) whatever its score.
//
// The solve rounds every operation on its own (one rounding per operation:
// Grunert's quartic is ill-conditioned, and the kernels' solve is the plain
// version's bit for bit); every reciprocal there is an exact division, and
// rsqrt is rsqrtf on the device (the plain version's torch.rsqrt is the same
// function there).  The TPU took approximate reciprocals.  The score takes
// its arithmetic from a policy of fp32_rn.cuh: `Exact` is the plain
// version's order, `Fused` (the kernels') one rounding per product-sum and
// MUFU's reciprocal from the residual on (the camera point keeps the plain
// order under both: `row_dot`).

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

// The pool as the score reads it (in shared memory on the card): point n's
// world point and weight (X, Y, Z, w) at xyzw[4n..4n+3], 16-byte aligned,
// and its pixel (x, ay * y) at pix[2n..2n+1].
struct Table {
  const float* xyzw;
  const float* pix;
};

// Cheap upper bound on cbrt(x), x >= 0: exponent-third bit trick times 1.1
// (sweep_pnp.py:76-81).
RT_FN float cbrt_upper(float x) {
  using namespace rt;
  const int xi = as_int(max_nan(x, 1e-30f));
  return mul(as_float(xi / 3 + 0x2A514067), 1.1f);
}

RT_FN float guard(float x, float eps) { return fabsf(x) < eps ? eps : x; }

// Real roots of x^4 + b x^3 + c x^2 + d x + e (sweep_pnp.py:84-149).  The
// resolvent cubic's Newton steps take their arithmetic from the policy C
// (the kernels' is `Exact`; tests/torch_host_build.py tries `Fused`).
template <class C = rt::Exact>
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
    const float f = C::mad(C::mad(C::add(m, cb), m, cc), m, cd);
    const float df = C::mad(C::prod_sum(3.0f, m, 2.0f, cb), m, cc);
    const float rdf = C::rcp(guard(df, 1e-20f));
    const float t = C::mul(f, rdf);
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

// What the four roots of one sample share: the quartic's roots and their
// flags, the law-of-cosines terms, and the world triad with its invariants.
struct Solve {
  float roots[kRoots];
  bool root_ok[kRoots];
  float cos_a, cos_b, cos_g, a2, b2, c2, n2, n1, n0, d1, d0, sb;
  float i1w, i2w, dw, e1w[3], e2w[3], e3w[3], cw[3];
};

// A root's pose as the score reads it: three rows (R_r0, R_r1, R_r2, t_r),
// the y row (R and t) scaled by ay.
struct Pose {
  float m[3][4];
};

// Grunert's quartic of the sampled world points P[j] and unit bearings
// F[j], and the world triad.
template <class C = rt::Exact>
RT_FN void solve(const float P[3][3], const float F[3][3], Solve* s) {
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
  solve_quartic<C>(div(c3, c4s), div(c2q, c4s), div(c1, c4s), div(c0, c4s),
                   s->roots, s->root_ok);
  s->cos_a = cos_a; s->cos_b = cos_b; s->cos_g = cos_g;
  s->a2 = a2; s->b2 = b2; s->c2 = c2;
  s->n2 = n2; s->n1 = n1; s->n0 = n0; s->d1 = d1; s->d0 = d0;

  s->sb = sqrt_rn(b2);
  float u1w[3], v1w[3], vpw[3];
  sub3(P[1], P[0], u1w);
  s->i1w = rsqrt32(add(dot3(u1w, u1w), 1e-30f));
#pragma unroll
  for (int c = 0; c < 3; ++c) s->e1w[c] = mul(u1w[c], s->i1w);
  sub3(P[2], P[0], v1w);
  s->dw = dot3(v1w, s->e1w);
#pragma unroll
  for (int c = 0; c < 3; ++c) vpw[c] = sub(v1w[c], mul(s->dw, s->e1w[c]));
  s->i2w = rsqrt32(add(dot3(vpw, vpw), 1e-30f));
#pragma unroll
  for (int c = 0; c < 3; ++c) s->e2w[c] = mul(vpw[c], s->i2w);
  cross3(s->e1w, s->e2w, s->e3w);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    s->cw[c] = div(add(add(P[0][c], P[1][c]), P[2][c]), 3.0f);
}

// The pose of root k (depth polish, camera triad, R and t, the y row scaled
// by ay) and whether it is valid: the sample valid, the root real and its
// depths positive.
RT_FN bool root_pose(const Solve& s, const float F[3][3], bool sample_valid,
                     int k, float ay, Pose* pose) {
  using namespace rt;
  const float cos_a = s.cos_a, cos_b = s.cos_b, cos_g = s.cos_g;
  // Root k by selects, not an index, so that `s` stays in registers.
  float v = s.roots[0];
  bool root_ok = s.root_ok[0];
#pragma unroll
  for (int j = 1; j < kRoots; ++j) {
    v = k == j ? s.roots[j] : v;
    root_ok = k == j ? s.root_ok[j] : root_ok;
  }
  const float D = add(mul(s.d1, v), s.d0);
  const float N = add(mul(add(mul(s.n2, v), s.n1), v), s.n0);
  const float u = mul(N, rcp(guard(D, 1e-9f)));
  float s1 = mul(s.sb, rsqrt32(max_nan(
      sub(add(1.0f, mul(v, v)), mul(mul(2.0f, v), cos_b)), 1e-12f)));
  float s2 = mul(u, s1);
  float s3 = mul(v, s1);
  bool valid = sample_valid && root_ok && v > 1e-6f && u > 1e-6f &&
               fabsf(D) > 1e-9f;
#pragma unroll
  for (int it = 0; it < kDepthPolish; ++it) {
    const float r1 = sub(sub(add(mul(s2, s2), mul(s3, s3)),
                             mul(mul(mul(2.0f, s2), s3), cos_a)), s.a2);
    const float r2 = sub(sub(add(mul(s1, s1), mul(s3, s3)),
                             mul(mul(mul(2.0f, s1), s3), cos_b)), s.b2);
    const float r3 = sub(sub(add(mul(s1, s1), mul(s2, s2)),
                             mul(mul(mul(2.0f, s1), s2), cos_g)), s.c2);
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
  float Cm[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    Cm[0][c] = mul(F[0][c], s1);
    Cm[1][c] = mul(F[1][c], s2);
    Cm[2][c] = mul(F[2][c], s3);
  }
  float u1[3], v1[3], e1[3], e2[3], e3[3];
  sub3(Cm[1], Cm[0], u1);
#pragma unroll
  for (int c = 0; c < 3; ++c) e1[c] = mul(u1[c], s.i1w);
  sub3(Cm[2], Cm[0], v1);
#pragma unroll
  for (int c = 0; c < 3; ++c) e2[c] = mul(sub(v1[c], mul(s.dw, e1[c])), s.i2w);
  cross3(e1, e2, e3);
  float R[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      R[r][c] = add(add(mul(e1[r], s.e1w[c]), mul(e2[r], s.e2w[c])),
                    mul(e3[r], s.e3w[c]));
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float ccm = div(add(add(Cm[0][r], Cm[1][r]), Cm[2][r]), 3.0f);
    const float t = sub(ccm, add(add(mul(R[r][0], s.cw[0]), mul(R[r][1], s.cw[1])),
                                 mul(R[r][2], s.cw[2])));
#pragma unroll
    for (int c = 0; c < 3; ++c) pose->m[r][c] = r == 1 ? mul(R[r][c], ay) : R[r][c];
    pose->m[r][3] = r == 1 ? mul(t, ay) : t;
  }
  return valid;
}

// The four roots' poses and validity of the sample (P, F).
template <class C = rt::Exact>
RT_FN void solve_poses(const float P[3][3], const float F[3][3],
                       bool sample_valid, float ay, Pose* pose, bool* valid) {
  Solve s;
  solve<C>(P, F, &s);
#pragma unroll 1
  for (int k = 0; k < kRoots; ++k) valid[k] = root_pose(s, F, sample_valid, k, ay, &pose[k]);
}

// Point n of the pool: (X, Y, Z, w, x, ay y); one 16-byte and one 8-byte
// load on the card.
RT_FN void load_point(const Table& t, int n, float q[6]) {
#ifdef __CUDACC__
  const float4 a = reinterpret_cast<const float4*>(t.xyzw)[n];
  const float2 b = reinterpret_cast<const float2*>(t.pix)[n];
  q[0] = a.x; q[1] = a.y; q[2] = a.z; q[3] = a.w; q[4] = b.x; q[5] = b.y;
#else
  for (int c = 0; c < 4; ++c) q[c] = t.xyzw[4 * n + c];
  q[4] = t.pix[2 * n];
  q[5] = t.pix[2 * n + 1];
#endif
}

// r . (X, Y, Z) + t of one pose row, in the plain version's order under
// either policy.  Under a bad pose a point near the camera plane has a
// camera coordinate that is a small difference of O(1) terms, and a
// residual and bound to match; FMAs there moved a count off the inlier cut
// and an MSAC by 1.4e-3 relative in 2^20 samples of a 256-point pool
// (tests/torch_host_build.py), so the camera point rounds as the plain
// version's does and the score fuses from the residual on.
template <class P>
RT_FN float row_dot(const float* r, const float* q) {
  using namespace rt;
  return add(add(add(mul(r[0], q[0]), mul(r[1], q[1])), mul(r[2], q[2])), r[3]);
}

// The division-deferred score of point q (weight q[3]) under one pose,
// added to (count, msac).
template <class P>
RT_FN void score_point(const Pose& pose, const float q[6], float thr_sq,
                       float* count, float* msac) {
  const float xc = row_dot<P>(pose.m[0], q);
  const float yc = row_dot<P>(pose.m[1], q);
  const float zc = row_dot<P>(pose.m[2], q);
  const bool behind = zc <= 1e-6f;
  const float a = P::mad(-q[4], zc, xc);  // xc - x zc
  const float b = P::mad(-q[5], zc, yc);
  float r2 = P::prod_sum(a, a, b, b);
  const float z2 = P::max(P::mul(zc, zc), 1e-30f);
  const float t2 = P::mul(thr_sq, z2);
  r2 = behind ? kFar : r2;
  *count = P::add(*count, r2 <= t2 ? q[3] : 0.0f);
  *msac = P::mad(P::mul(P::min(r2, t2), P::rcp(z2)), q[3], *msac);
}

// MSAC and count of K poses over the first n_score pool rows, each row
// loaded once for all K.
template <class P, int K>
RT_FN void score_poses(const Pose* pose, const Table& t, int n_score,
                       float thr_sq, float* msac, float* count) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    msac[j] = 0.0f;
    count[j] = 0.0f;
  }
  for (int n = 0; n < n_score; ++n) {
    float q[6];
    load_point(t, n, q);
#pragma unroll
    for (int j = 0; j < K; ++j) score_point<P>(pose[j], q, thr_sq, &count[j], &msac[j]);
  }
}

// score_poses of one pose.
template <class P>
RT_FN void score_pose(const Pose& pose, const Table& t, int n_score,
                      float thr_sq, float* msac, float* count) {
  score_poses<P, 1>(&pose, t, n_score, thr_sq, msac, count);
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
