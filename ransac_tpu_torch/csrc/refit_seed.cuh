// The engines' two refits, each from its inputs to its result in one warp
// (csrc/refit.cu):
// - `models.ransac.refit_homography`: the weighted DLT on the inlier set
//   (`ops.homography.dlt_homography` with `normalization_transform` and
//   `ops.linalg.nullspace_last_fast`), the homography LM (lm.cuh), then the
//   RANSAC winner where a value is not finite;
// - `models.ransac._pnp_refit`: the seeds DLT-PnP (`ops.pnp.dlt_pnp`) and
//   EPnP (`ops.pnp.epnp`) on the inlier set, truncated MSAC of them and the
//   RANSAC winner (`_pnp_refit_seed`), `log_so3`, the pose LM, `exp_so3`,
//   then the winner where a value is not finite.
//
// The arithmetic is the plain versions', in float32, every operation
// rounded on its own (fp32_rn.cuh) in their order wherever they fix one:
// torch's `c / t` of a number by a tensor is its reciprocal times c
// (`rdiv`); a matrix product adds its terms in index order.  Sums over the
// points are the lanes' (lane l takes points l, l + 32, ..., then the
// butterfly: `sum` of lm.cuh's lanes policies), where torch adds in its own
// order.  Two steps have no plain twin:
// - `torch.linalg.det` (an LU factorisation) is the cofactor expansion;
// - `torch.linalg.eigh` of EPnP's 12 x 12 M^T M is a cyclic Jacobi
//   eigensolver run until every off-diagonal entry is below the float32
//   rounding of its two diagonal entries (`jacobi_eigh`), its rows updated
//   by the lanes in parallel (`rows`); the two smallest eigenvalues' vectors
//   are EPnP's, whose sign EPnP's cases do not see.
// So a refit agrees with the plain one to float32 rounding, not bit for bit.
//
// Without __CUDACC__ this builds as host C++ (the CPU tests hold it against
// the plain versions).

#pragma once

#include "lm.cuh"

namespace seed {

using lm::kLanes;
using rt::add;
using rt::div;
using rt::mul;
using rt::sub;

constexpr float kSqrt2 = 1.41421356237309515f;     // math.sqrt(2.0)
constexpr float kTwoPi3 = 2.09439510239319526f;    // eigh3x3's two_pi_3
constexpr int kMaxSweeps = 50;                     // jacobi_eigh's cap

// torch's `c / a` for a number c and a tensor a: reciprocal, then product.
RT_FN float rdiv(float c, float a) { return mul(div(1.0f, a), c); }
RT_FN float clamp_min(float x, float lo) { return rt::max_nan(x, lo); }
RT_FN float clamp_max(float x, float hi) { return rt::min_nan(x, hi); }
RT_FN float guard(float x, float eps) { return fabsf(x) < eps ? eps : x; }
RT_FN float sq(float x) { return mul(x, x); }
RT_FN bool finite(float x) { return fabsf(x) <= 3.40282347e38f; }
RT_FN float wt(bool inlier) { return inlier ? 1.0f : 0.0f; }
RT_FN float inf() { return rt::as_float(0x7f800000); }

// ------------------------------------------------------------- 3-vectors
RT_FN float dot3(const float* a, const float* b) {
  return add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2]));
}
RT_FN void cross3(const float* u, const float* v, float* o) {  // linalg._cross
  o[0] = sub(mul(u[1], v[2]), mul(u[2], v[1]));
  o[1] = sub(mul(u[2], v[0]), mul(u[0], v[2]));
  o[2] = sub(mul(u[0], v[1]), mul(u[1], v[0]));
}
RT_FN void unit3(float* v) {  // linalg._unit
  const float n = clamp_min(rt::sqrt_rn(dot3(v, v)), 1e-30f);
  for (int k = 0; k < 3; ++k) v[k] = div(v[k], n);
}
// First maximum (minimum) of three, a NaN the maximum (minimum), as
// torch.argmax (argmin) takes them.
RT_FN int argmax3(float a, float b, float c) {
  int i = 0;
  float best = a;
  if (best == best && (b != b || b > best)) { i = 1; best = b; }
  if (best == best && (c != c || c > best)) i = 2;
  return i;
}
RT_FN int argmin3(float a, float b, float c) {
  int i = 0;
  float best = a;
  if (best == best && (b != b || b < best)) { i = 1; best = b; }
  if (best == best && (c != c || c < best)) i = 2;
  return i;
}

// ------------------------------------------------- 3 x 3, row-major [9]
RT_FN void matmul3(const float* A, const float* B, float* C) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = add(add(mul(A[3 * i], B[j]), mul(A[3 * i + 1], B[3 + j])),
                         mul(A[3 * i + 2], B[6 + j]));
}
RT_FN void matvec3(const float* A, const float* x, float* y) {
  for (int i = 0; i < 3; ++i) y[i] = dot3(A + 3 * i, x);
}
RT_FN float det3(const float* A) {
  return add(sub(mul(A[0], sub(mul(A[4], A[8]), mul(A[5], A[7]))),
                 mul(A[1], sub(mul(A[3], A[8]), mul(A[5], A[6])))),
             mul(A[2], sub(mul(A[3], A[7]), mul(A[4], A[6]))));
}
// linalg.inv3x3: eps added to the diagonal, then adjugate / det.
RT_FN void inv3x3(const float* A_in, float eps, float* out) {
  float A[9];
  for (int k = 0; k < 9; ++k) A[k] = A_in[k];
  if (eps != 0.0f)
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) A[3 * i + j] = add(A[3 * i + j], mul(eps, i == j ? 1.0f : 0.0f));
  const float a = A[0], b = A[1], c = A[2], d = A[3], e = A[4], f = A[5], g = A[6], h = A[7],
              i = A[8];
  const float adj[9] = {sub(mul(e, i), mul(f, h)), sub(mul(c, h), mul(b, i)),
                        sub(mul(b, f), mul(c, e)), sub(mul(f, g), mul(d, i)),
                        sub(mul(a, i), mul(c, g)), sub(mul(c, d), mul(a, f)),
                        sub(mul(d, h), mul(e, g)), sub(mul(b, g), mul(a, h)),
                        sub(mul(a, e), mul(b, d))};
  const float det = add(add(mul(a, adj[0]), mul(b, adj[3])), mul(c, adj[6]));
  const float inv_det = rdiv(1.0f, guard(det, 1e-30f));
  for (int k = 0; k < 9; ++k) out[k] = mul(adj[k], inv_det);
}

// linalg.eigh3x3 of the symmetric A: vals ascending [3], V [9] with the
// eigenvectors as columns.
RT_FN void eigh3x3(const float* A_in, float* vals, float* V) {
  float m = fabsf(A_in[0]);
  for (int k = 1; k < 9; ++k) m = rt::max_nan(m, fabsf(A_in[k]));
  const float scale = clamp_min(m, 1e-30f);
  float A[9];
  for (int k = 0; k < 9; ++k) A[k] = div(A_in[k], scale);
  const float a00 = A[0], a01 = A[1], a02 = A[2], a11 = A[4], a12 = A[5], a22 = A[8];
  const float q = div(add(add(a00, a11), a22), 3.0f);
  const float p1 = add(add(sq(a01), sq(a02)), sq(a12));
  const float b00 = sub(a00, q), b11 = sub(a11, q), b22 = sub(a22, q);
  const float p2 = add(add(add(sq(b00), sq(b11)), sq(b22)), mul(2.0f, p1));
  const float p = rt::sqrt_rn(clamp_min(div(p2, 6.0f), 1e-30f));
  const float detb = sub(sub(sub(add(mul(mul(b00, sub(a11, q)), sub(a22, q)),
                                     mul(mul(mul(2.0f, a01), a12), a02)),
                                 mul(mul(b00, a12), a12)),
                             mul(mul(b11, a02), a02)),
                         mul(mul(b22, a01), a01));
  const float r = rt::clip(div(detb, mul(mul(mul(2.0f, p), p), p)), -1.0f, 1.0f);
  const float phi = div(acosf(r), 3.0f);
  const float l2 = add(q, mul(mul(2.0f, p), cosf(phi)));
  const float l0 = add(q, mul(mul(2.0f, p), cosf(add(phi, kTwoPi3))));
  const float l1 = sub(sub(mul(3.0f, q), l0), l2);

  const bool iso_low = sub(l1, l0) > sub(l2, l1);
  const float lam = iso_low ? l0 : l2;
  float B[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) B[3 * i + j] = sub(A[3 * i + j], mul(lam, i == j ? 1.0f : 0.0f));
  float c01[3], c02[3], c12[3];
  cross3(B, B + 3, c01);
  cross3(B, B + 6, c02);
  cross3(B + 3, B + 6, c12);
  const float n01 = dot3(c01, c01), n02 = dot3(c02, c02), n12 = dot3(c12, c12);
  const int pk = argmax3(n01, n02, n12);
  const float s0 = pk == 0 ? 1.0f : 0.0f, s1 = pk == 1 ? 1.0f : 0.0f, s2 = pk == 2 ? 1.0f : 0.0f;
  float v_iso[3];
  for (int k = 0; k < 3; ++k)
    v_iso[k] = add(add(mul(s0, c01[k]), mul(s1, c02[k])), mul(s2, c12[k]));
  unit3(v_iso);
  if (rt::max_nan(rt::max_nan(n01, n02), n12) < 1e-24f) {  // (near-)spherical: e0
    v_iso[0] = 1.0f;
    v_iso[1] = 0.0f;
    v_iso[2] = 0.0f;
  }
  const int ak = argmin3(fabsf(v_iso[0]), fabsf(v_iso[1]), fabsf(v_iso[2]));
  const float axis[3] = {ak == 0 ? 1.0f : 0.0f, ak == 1 ? 1.0f : 0.0f, ak == 2 ? 1.0f : 0.0f};
  float w1[3], w2[3], Aw1[3], Aw2[3];
  cross3(v_iso, axis, w1);
  unit3(w1);
  cross3(v_iso, w1, w2);
  matvec3(A, w1, Aw1);
  matvec3(A, w2, Aw2);
  const float ra = dot3(w1, Aw1), rb = dot3(w1, Aw2), rc = dot3(w2, Aw2);
  const float theta = mul(0.5f, atan2f(mul(2.0f, rb), sub(ra, rc)));
  const float ct = cosf(theta), st = sinf(theta);
  float vp[3], vq[3];
  for (int k = 0; k < 3; ++k) {
    vp[k] = add(mul(ct, w1[k]), mul(st, w2[k]));
    vq[k] = add(mul(-st, w1[k]), mul(ct, w2[k]));
  }
  const float cs2 = mul(mul(2.0f, ct), st);
  const float lp = add(add(mul(mul(ct, ct), ra), mul(cs2, rb)), mul(mul(st, st), rc));
  const float lq = add(sub(mul(mul(st, st), ra), mul(cs2, rb)), mul(mul(ct, ct), rc));
  const bool swap = lp > lq;
  const float m_lo = swap ? lq : lp, m_hi = swap ? lp : lq;
  const float* v_lo = swap ? vq : vp;
  const float* v_hi = swap ? vp : vq;
  vals[0] = mul(iso_low ? lam : m_lo, scale);
  vals[1] = mul(iso_low ? m_lo : m_hi, scale);
  vals[2] = mul(iso_low ? m_hi : lam, scale);
  const float* cols[3] = {iso_low ? v_iso : v_lo, iso_low ? v_lo : v_hi, iso_low ? v_hi : v_iso};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) V[3 * i + j] = cols[j][i];
}

// linalg.svd3x3 then rotation.project_to_so3: the rotation nearest M.
RT_FN void project_to_so3(const float* F, float* R) {
  float FtF[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      FtF[3 * i + j] = add(add(mul(F[i], F[j]), mul(F[3 + i], F[3 + j])),
                           mul(F[6 + i], F[6 + j]));
  float lam[3], E[9];
  eigh3x3(FtF, lam, E);
  float Vc[3][3], S[3];  // V's columns and S, descending
  for (int k = 0; k < 3; ++k) {
    for (int i = 0; i < 3; ++i) Vc[k][i] = E[3 * i + 2 - k];
    S[k] = rt::sqrt_rn(clamp_min(lam[2 - k], 0.0f));
  }
  float u0[3], u1[3], u2[3], fv2[3];
  matvec3(F, Vc[0], u0);
  matvec3(F, Vc[1], u1);
  for (int k = 0; k < 3; ++k) {
    u0[k] = div(u0[k], clamp_min(S[0], 1e-30f));
    u1[k] = div(u1[k], clamp_min(S[1], 1e-30f));
  }
  unit3(u0);
  const float d = dot3(u0, u1);
  for (int k = 0; k < 3; ++k) u1[k] = sub(u1[k], mul(d, u0[k]));
  unit3(u1);
  cross3(u0, u1, u2);
  matvec3(F, Vc[2], fv2);
  if (dot3(u2, fv2) < 0.0f && S[2] > mul(1e-6f, clamp_min(S[0], 1e-30f)))
    for (int k = 0; k < 3; ++k) u2[k] = -u2[k];
  float U[9], Vt[9], UVt[9];
  for (int i = 0; i < 3; ++i) {
    U[3 * i] = u0[i];
    U[3 * i + 1] = u1[i];
    U[3 * i + 2] = u2[i];
    for (int k = 0; k < 3; ++k) Vt[3 * k + i] = Vc[k][i];
  }
  matmul3(U, Vt, UVt);
  const float det = det3(UVt);
  for (int i = 0; i < 3; ++i) {
    U[3 * i] = mul(U[3 * i], 1.0f);
    U[3 * i + 1] = mul(U[3 * i + 1], 1.0f);
    U[3 * i + 2] = mul(U[3 * i + 2], det);
  }
  matmul3(U, Vt, R);
}

// rotation.log_so3: the quaternion of R (quat_from_matrix), then its
// rotation vector (rvec_from_quat).
RT_FN void log_so3(const float* R, float* rvec) {
  const float m00 = R[0], m01 = R[1], m02 = R[2], m10 = R[3], m11 = R[4], m12 = R[5],
              m20 = R[6], m21 = R[7], m22 = R[8];
  const float tr = add(add(m00, m11), m22);
  const float d[4] = {add(1.0f, tr), sub(sub(add(1.0f, m00), m11), m22),
                      sub(add(sub(1.0f, m00), m11), m22), add(sub(sub(1.0f, m00), m11), m22)};
  const float cand[4][4] = {{d[0], sub(m21, m12), sub(m02, m20), sub(m10, m01)},
                            {sub(m21, m12), d[1], add(m01, m10), add(m02, m20)},
                            {sub(m02, m20), add(m01, m10), d[2], add(m12, m21)},
                            {sub(m10, m01), add(m02, m20), add(m12, m21), d[3]}};
  int best = 0;
  for (int k = 1; k < 4; ++k)
    if (d[best] == d[best] && (d[k] != d[k] || d[k] > d[best])) best = k;
  float q[4];
  for (int k = 0; k < 4; ++k) q[k] = cand[best][k];
  const float nq = rt::sqrt_rn(add(add(add(sq(q[0]), sq(q[1])), sq(q[2])), sq(q[3])));
  for (int k = 0; k < 4; ++k) q[k] = div(q[k], nq);
  const float sgn = q[0] < 0.0f ? -1.0f : 1.0f;
  for (int k = 0; k < 4; ++k) q[k] = mul(q[k], sgn);
  const float w = rt::clip(q[0], -1.0f, 1.0f);
  const float vnorm = rt::sqrt_rn(dot3(q + 1, q + 1));
  const float theta = mul(2.0f, atan2f(vnorm, w));
  const float scale = vnorm < 1e-8f ? rdiv(2.0f, clamp_min(w, 1e-8f)) : div(theta, vnorm);
  for (int k = 0; k < 3; ++k) rvec[k] = mul(q[1 + k], scale);
}

// ------------------------------------------------------ linear algebra
// The inverse iteration of linalg.nullspace_last_fast on the N x N normal
// matrix M (its upper triangle row by row, `upper`): the shift 1e-6 tr / N
// + 1e-30, 4 elimination passes from each of e_{N-1} and 1 / sqrt(N) each
// entry, each pass normalised, the lower Rayleigh quotient's vector (the
// first start's on a tie) into h [N].
template <int N> RT_FN void nullspace(const float* upper, float* h) {
  float M[N][N];
  int t = 0;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int l = j; l < N; ++l, ++t) {
      M[j][l] = upper[t];
      M[l][j] = upper[t];
    }
  float tr = M[0][0];
#pragma unroll
  for (int j = 1; j < N; ++j) tr = add(tr, M[j][j]);
  const float shift = add(div(mul(1e-6f, tr), static_cast<float>(N)), 1e-30f);
  float x[2][N], rq[2];
  const float start = static_cast<float>(1.0 / sqrt(static_cast<double>(N)));
#pragma unroll 1
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int j = 0; j < N; ++j) x[s][j] = s == 0 ? (j == N - 1 ? 1.0f : 0.0f) : start;
#pragma unroll 1
    for (int it = 0; it < 4; ++it) {
      float Ms[N][N + 1];
#pragma unroll
      for (int j = 0; j < N; ++j) {
#pragma unroll
        for (int l = 0; l < N; ++l) Ms[j][l] = add(M[j][l], mul(shift, j == l ? 1.0f : 0.0f));
        Ms[j][N] = x[s][j];
      }
      lm::eliminate<N>(Ms, x[s]);
      float n2 = sq(x[s][0]);
#pragma unroll
      for (int j = 1; j < N; ++j) n2 = add(n2, sq(x[s][j]));
      const float nrm = clamp_min(rt::sqrt_rn(n2), 1e-30f);
#pragma unroll
      for (int j = 0; j < N; ++j) x[s][j] = div(x[s][j], nrm);
    }
    float r = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int l = 0; l < N; ++l) r = add(r, mul(mul(x[s][j], M[j][l]), x[s][l]));
    rq[s] = r;
  }
  const int pick = rq[0] <= rq[1] ? 0 : 1;
#pragma unroll
  for (int j = 0; j < N; ++j) h[j] = x[pick][j];
}

// Add the products of row a [N] into the upper triangle acc [N (N + 1) / 2].
template <int N> RT_FN void add_outer(const float* a, float* acc) {
  int t = 0;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int l = j; l < N; ++l, ++t) acc[t] = add(acc[t], mul(a[j], a[l]));
}

// The eigendecomposition of the symmetric N x N A (row-major, overwritten:
// its diagonal ends as the eigenvalues) into V, the eigenvectors as its
// columns, by cyclic Jacobi rotations (Numerical Recipes' `jacobi`, on the
// full matrix): in each sweep, every pair p < q in order, an entry whose
// 100-fold still vanishes beside both diagonal entries in float32 is set to
// 0, any other nonzero one rotated away; it stops after a sweep with no
// rotation (every off-diagonal entry 0), or after kMaxSweeps.  Row r of A
// and V is updated by lane r % 32 (`rows`); every lane reads the pivot
// entries before any writes them (`sync`), so A and V, in shared memory on
// the card, are the host build's bit for bit.  Returns the rotations made
// (what the operation count of utils/profiling.py's `refit_pose` row reads).
template <int N, class L> RT_FN int jacobi_eigh(float* A, float* V, const L& lanes) {
  int rotations = 0;
  lanes.rows(N, [&](int r) {
    for (int c = 0; c < N; ++c) V[r * N + c] = r == c ? 1.0f : 0.0f;
  });
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
    for (int p = 0; p < N - 1; ++p) {
      for (int q = p + 1; q < N; ++q) {
        const float apq = A[p * N + q], app = A[p * N + p], aqq = A[q * N + q];
        lanes.sync();
        if (apq == 0.0f) continue;
        const float g = mul(100.0f, fabsf(apq));
        if (add(fabsf(app), g) == fabsf(app) && add(fabsf(aqq), g) == fabsf(aqq)) {
          lanes.rows(1, [&](int) {
            A[p * N + q] = 0.0f;
            A[q * N + p] = 0.0f;
          });
          continue;
        }
        rotated = true;
        ++rotations;
        const float h = sub(aqq, app);
        float t;
        if (add(fabsf(h), g) == fabsf(h)) {
          t = div(apq, h);
        } else {
          const float theta = div(mul(0.5f, h), apq);
          t = div(1.0f, add(fabsf(theta), rt::sqrt_rn(add(1.0f, sq(theta)))));
          if (theta < 0.0f) t = -t;
        }
        const float c = div(1.0f, rt::sqrt_rn(add(1.0f, sq(t))));
        const float s = mul(t, c);
        const float tau = div(s, add(1.0f, c));
        const float ht = mul(t, apq);
        lanes.rows(N, [&](int r) {
          if (r == p) {
            A[p * N + p] = sub(app, ht);
          } else if (r == q) {
            A[q * N + q] = add(aqq, ht);
            A[p * N + q] = 0.0f;
            A[q * N + p] = 0.0f;
          } else {
            const float arp = A[r * N + p], arq = A[r * N + q];
            const float np = sub(arp, mul(s, add(arq, mul(arp, tau))));
            const float nq = add(arq, mul(s, sub(arp, mul(arq, tau))));
            A[r * N + p] = np;
            A[p * N + r] = np;
            A[r * N + q] = nq;
            A[q * N + r] = nq;
          }
          const float vp = V[r * N + p], vq = V[r * N + q];
          V[r * N + p] = sub(vp, mul(s, add(vq, mul(vp, tau))));
          V[r * N + q] = add(vq, mul(s, sub(vp, mul(vq, tau))));
        });
      }
    }
    if (!rotated) break;
  }
  return rotations;
}

// ------------------------------------------------------------ homography
// normalization_transform of weighted points: T = [[s, 0, tx], [0, s, ty],
// [0, 0, 1]].
struct Similarity {
  float s, tx, ty;
  RT_FN void matrix(float* T) const {
    const float m[9] = {s, 0.0f, tx, 0.0f, s, ty, 0.0f, 0.0f, 1.0f};
    for (int k = 0; k < 9; ++k) T[k] = m[k];
  }
  // The first two entries of T [x, y, 1] (`_normalized_rows`).
  RT_FN void apply(float x, float y, float* o) const {
    o[0] = add(add(mul(x, s), mul(y, 0.0f)), mul(1.0f, tx));
    o[1] = add(add(mul(x, 0.0f), mul(y, s)), mul(1.0f, ty));
  }
};

// One homography refit problem: src, dst [n, 2], the inlier mask [n].
struct HomographyProblem {
  const float* src;
  const float* dst;
  const bool* inl;
  int n;
};

// dlt_homography of the inliers: Hartley frames of src and dst under the
// weights, the weighted 2n x 9 rows' normal matrix, its nullspace, then
// Td^-1 Hn Ts over its h33 (1 where |h33| < 1e-12): H [9].
template <class L> RT_FN void dlt_homography(const HomographyProblem& p, const L& lanes, float* H) {
  float m1[5];  // sum w, sum w src, sum w dst
  lanes.template sum<5>([&](int l, float* a) {
    for (int i = l; i < p.n; i += kLanes) {
      const float w = wt(p.inl[i]);
      a[0] = add(a[0], w);
      a[1] = add(a[1], mul(p.src[2 * i], w));
      a[2] = add(a[2], mul(p.src[2 * i + 1], w));
      a[3] = add(a[3], mul(p.dst[2 * i], w));
      a[4] = add(a[4], mul(p.dst[2 * i + 1], w));
    }
  }, m1);
  const float wsum = clamp_min(m1[0], 1e-12f);
  const float ms[2] = {div(m1[1], wsum), div(m1[2], wsum)};
  const float md[2] = {div(m1[3], wsum), div(m1[4], wsum)};
  float m2[2];  // sum w |p - mean| of src and dst
  lanes.template sum<2>([&](int l, float* a) {
    for (int i = l; i < p.n; i += kLanes) {
      const float w = wt(p.inl[i]);
      const float ds = rt::sqrt_rn(add(sq(sub(p.src[2 * i], ms[0])), sq(sub(p.src[2 * i + 1], ms[1]))));
      const float dd = rt::sqrt_rn(add(sq(sub(p.dst[2 * i], md[0])), sq(sub(p.dst[2 * i + 1], md[1]))));
      a[0] = add(a[0], mul(ds, w));
      a[1] = add(a[1], mul(dd, w));
    }
  }, m2);
  const float ss = rdiv(kSqrt2, clamp_min(div(m2[0], wsum), 1e-12f));
  const float sd = rdiv(kSqrt2, clamp_min(div(m2[1], wsum), 1e-12f));
  const Similarity Ts{ss, mul(-ss, ms[0]), mul(-ss, ms[1])};
  const Similarity Td{sd, mul(-sd, md[0]), mul(-sd, md[1])};

  float upper[45];
  lanes.template sum<45>([&](int l, float* a) {
    for (int i = l; i < p.n; i += kLanes) {
      const float w = wt(p.inl[i]);
      float xs[2], ud[2];
      Ts.apply(p.src[2 * i], p.src[2 * i + 1], xs);
      Td.apply(p.dst[2 * i], p.dst[2 * i + 1], ud);
      const float x = xs[0], y = xs[1], u = ud[0], v = ud[1];
      const float r1[9] = {x, y, 1.0f, 0.0f, 0.0f, 0.0f, mul(-u, x), mul(-u, y), -u};
      const float r2[9] = {0.0f, 0.0f, 0.0f, x, y, 1.0f, mul(-v, x), mul(-v, y), -v};
      float a1[9], a2[9];
      for (int k = 0; k < 9; ++k) {
        a1[k] = mul(r1[k], w);
        a2[k] = mul(r2[k], w);
      }
      add_outer<9>(a1, a);
      add_outer<9>(a2, a);
    }
  }, upper);
  float Hn[9], TsM[9], TdM[9], Td_inv[9], HT[9];
  nullspace<9>(upper, Hn);
  Ts.matrix(TsM);
  Td.matrix(TdM);
  inv3x3(TdM, 0.0f, Td_inv);
  matmul3(Hn, TsM, HT);
  matmul3(Td_inv, HT, H);
  const float h33 = fabsf(H[8]) < 1e-12f ? 1.0f : H[8];
  for (int k = 0; k < 9; ++k) H[k] = div(H[k], h33);
}

// refit_homography of one problem: the DLT seed, then max_iters LM passes
// (none at 0), then H_best [9] where an entry is not finite: H_out [9].
template <class L>
RT_FN void refit_homography(const HomographyProblem& p, const float* H_best, int max_iters,
                            const L& lanes, float* H_out) {
  float H[9];
  dlt_homography(p, lanes, H);
  if (max_iters > 0) {
    float x[8];
    lm::homography_start(H, x);
    lm::run(lm::HomographyOf<bool>{p.src, p.dst, p.inl, p.n}, x, max_iters, lanes);
    for (int k = 0; k < 8; ++k) H[k] = x[k];
    H[8] = 1.0f;
  }
  bool ok = true;
  for (int k = 0; k < 9; ++k) ok = ok && finite(H[k]);
  for (int k = 0; k < 9; ++k) H_out[k] = ok ? H[k] : H_best[k];
}

// ------------------------------------------------------------------ pose
// One PnP refit problem: world points X [n, 3], pixels [n, 2] and their
// normalized coordinates pix_n [n, 2], K [9], the RANSAC winner's inliers
// [n] (the seeds' and the LM's weights), the point mask [n] (MSAC's), the
// normalized threshold and fy / fx.
struct PoseProblem {
  const float* X;
  const float* pix;
  const float* pix_n;
  const float* K;
  const bool* inl;
  const float* mask;
  float thr_n, ay;
  int n;
};

// What the seed choice saw (the host build's tests read it).
struct PoseSeedTrace {
  float cands[4][12];  // winner, DLT-PnP, EPnP case 1, case 2: R row-major, t
  float scores[4];     // truncated MSAC
  float n_inl;
  int choice;
  float mtm[144];      // EPnP's M^T M
  float evals[12];     // its eigenvalues (jacobi_eigh's diagonal)
  float kernel[2][12]; // the eigenvectors of the two smallest
  int rotations;       // the Jacobi rotations that found them
};

// dlt_pnp: the weighted 2n x 12 rows' nullspace P [3, 4], its sign and
// scale from det P[:, :3], R = project_to_so3(P[:, :3] / s), t = P[:, 3] / s.
template <class L> RT_FN void dlt_pnp(const PoseProblem& p, const L& lanes, float* model) {
  float upper[78];
  lanes.template sum<78>([&](int l, float* a) {
    for (int i = l; i < p.n; i += kLanes) {
      const float w = wt(p.inl[i]);
      const float X = p.X[3 * i], Y = p.X[3 * i + 1], Z = p.X[3 * i + 2];
      const float u = p.pix_n[2 * i], v = p.pix_n[2 * i + 1];
      const float r1[12] = {X, Y, Z, 1.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                            mul(-u, X), mul(-u, Y), mul(-u, Z), -u};
      const float r2[12] = {0.0f, 0.0f, 0.0f, 0.0f, X, Y, Z, 1.0f,
                            mul(-v, X), mul(-v, Y), mul(-v, Z), -v};
      float a1[12], a2[12];
      for (int k = 0; k < 12; ++k) {
        a1[k] = mul(r1[k], w);
        a2[k] = mul(r2[k], w);
      }
      add_outer<12>(a1, a);
      add_outer<12>(a2, a);
    }
  }, upper);
  float P[12];
  nullspace<12>(upper, P);
  float P3[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) P3[3 * i + j] = P[4 * i + j];
  const float sign = det3(P3) < 0.0f ? -1.0f : 1.0f;
  for (int k = 0; k < 12; ++k) P[k] = mul(P[k], sign);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) P3[3 * i + j] = P[4 * i + j];
  const float s = clamp_min(powf(fabsf(det3(P3)), 1.0f / 3.0f), 1e-12f);
  for (int k = 0; k < 9; ++k) P3[k] = div(P3[k], s);
  project_to_so3(P3, model);
  for (int i = 0; i < 3; ++i) model[9 + i] = div(P[4 * i + 3], s);
}

// EPnP's control points and barycentrics.
struct Controls {
  float ctrl[4][3];  // centroid, then centroid + sqrt(eigenvalue) axis
  float CT[4][4];    // [ctrl^T; 1]
  float c0[3];       // the weighted centroid
  float wsum;

  // Point i's barycentric coordinates: CT alpha = [X_i, 1] by
  // solve_unrolled's elimination.
  RT_FN void alphas(const float* X, float* al) const {
    float M[4][5];
    for (int j = 0; j < 4; ++j) {
      for (int c = 0; c < 4; ++c) M[j][c] = CT[j][c];
      M[j][4] = j < 3 ? X[j] : 1.0f;
    }
    lm::eliminate<4>(M, al);
  }
  // Point i in the camera frame of control points cc [4][3]: alpha cc.
  RT_FN void camera(const float* X, const float (*cc)[3], float* xc) const {
    float al[4];
    alphas(X, al);
    for (int k = 0; k < 3; ++k)
      xc[k] = add(add(add(mul(al[0], cc[0][k]), mul(al[1], cc[1][k])), mul(al[2], cc[2][k])),
                  mul(al[3], cc[3][k]));
  }
};

// EPnP's pose from camera control points cc: `signed` (the sign that puts
// most weighted depth in front), then absolute_orientation of X onto the
// camera points: R, t into model [12].
template <class L>
RT_FN void epnp_pose(const PoseProblem& p, const Controls& C, const float (*cc)[3],
                     const L& lanes, float* model) {
  float zs[1];
  lanes.template sum<1>([&](int l, float* a) {
    for (int i = l; i < p.n; i += kLanes) {
      float xc[3];
      C.camera(p.X + 3 * i, cc, xc);
      a[0] = add(a[0], mul(xc[2], wt(p.inl[i])));
    }
  }, zs);
  const float sign = zs[0] < 0.0f ? -1.0f : 1.0f;
  float m[3];
  lanes.template sum<3>([&](int l, float* a) {
    for (int i = l; i < p.n; i += kLanes) {
      float xc[3];
      C.camera(p.X + 3 * i, cc, xc);
      const float w = wt(p.inl[i]);
      for (int k = 0; k < 3; ++k) a[k] = add(a[k], mul(mul(xc[k], sign), w));
    }
  }, m);
  float ccen[3];
  for (int k = 0; k < 3; ++k) ccen[k] = div(m[k], C.wsum);
  float H[9];
  lanes.template sum<9>([&](int l, float* a) {
    for (int i = l; i < p.n; i += kLanes) {
      float xc[3], ac[3], aw[3];
      C.camera(p.X + 3 * i, cc, xc);
      const float w = wt(p.inl[i]);
      for (int k = 0; k < 3; ++k) {
        ac[k] = mul(sub(mul(xc[k], sign), ccen[k]), w);
        aw[k] = sub(p.X[3 * i + k], C.c0[k]);
      }
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) a[3 * r + c] = add(a[3 * r + c], mul(ac[r], aw[c]));
    }
  }, H);
  project_to_so3(H, model);
  float Rc[3];
  matvec3(model, C.c0, Rc);
  for (int k = 0; k < 3; ++k) model[9 + k] = sub(ccen[k], Rc[k]);
}

// epnp of the inliers: control points from the weighted centroid and
// eigh3x3 of the covariance, M^T M of the weighted 2n x 12 rows, its two
// smallest eigenvectors (jacobi_eigh over A and V [144], shared on the
// card), then cases 1 and 2: models [2][12].
template <class L>
RT_FN void epnp(const PoseProblem& p, float* A, float* V, const L& lanes, float (*models)[12],
                PoseSeedTrace* trace) {
  Controls C;
  float m1[4];
  lanes.template sum<4>([&](int l, float* a) {
    for (int i = l; i < p.n; i += kLanes) {
      const float w = wt(p.inl[i]);
      a[0] = add(a[0], w);
      for (int k = 0; k < 3; ++k) a[1 + k] = add(a[1 + k], mul(p.X[3 * i + k], w));
    }
  }, m1);
  C.wsum = clamp_min(m1[0], 1e-12f);
  for (int k = 0; k < 3; ++k) C.c0[k] = div(m1[1 + k], C.wsum);
  float cv[6];
  lanes.template sum<6>([&](int l, float* a) {
    for (int i = l; i < p.n; i += kLanes) {
      const float w = wt(p.inl[i]);
      float d[3];
      for (int k = 0; k < 3; ++k) d[k] = mul(sub(p.X[3 * i + k], C.c0[k]), w);
      add_outer<3>(d, a);
    }
  }, cv);
  const float cov[9] = {div(cv[0], C.wsum), div(cv[1], C.wsum), div(cv[2], C.wsum),
                        div(cv[1], C.wsum), div(cv[3], C.wsum), div(cv[4], C.wsum),
                        div(cv[2], C.wsum), div(cv[4], C.wsum), div(cv[5], C.wsum)};
  float ev[3], E[9];
  eigh3x3(cov, ev, E);
  for (int k = 0; k < 3; ++k) {
    C.ctrl[0][k] = C.c0[k];
    const float sc = rt::sqrt_rn(clamp_min(ev[k], 1e-10f));
    for (int j = 0; j < 3; ++j) C.ctrl[1 + k][j] = add(C.c0[j], mul(sc, E[3 * j + k]));
  }
  for (int c = 0; c < 4; ++c) {
    for (int j = 0; j < 3; ++j) C.CT[j][c] = C.ctrl[c][j];
    C.CT[3][c] = 1.0f;
  }

  float upper[78];
  lanes.template sum<78>([&](int l, float* a) {
    for (int i = l; i < p.n; i += kLanes) {
      const float w = wt(p.inl[i]);
      const float u = p.pix_n[2 * i], v = p.pix_n[2 * i + 1];
      float al[4], rx[12], ry[12];
      C.alphas(p.X + 3 * i, al);
      for (int j = 0; j < 4; ++j) {
        rx[3 * j] = mul(al[j], w);
        rx[3 * j + 1] = mul(0.0f, w);
        rx[3 * j + 2] = mul(mul(-u, al[j]), w);
        ry[3 * j] = mul(0.0f, w);
        ry[3 * j + 1] = mul(al[j], w);
        ry[3 * j + 2] = mul(mul(-v, al[j]), w);
      }
      add_outer<12>(rx, a);
      add_outer<12>(ry, a);
    }
  }, upper);
  lanes.rows(12, [&](int r) {
    for (int c = 0; c < 12; ++c) {
      const int j = r < c ? r : c, k = r < c ? c : r;
      A[12 * r + c] = upper[12 * j - j * (j - 1) / 2 + (k - j)];
    }
  });
  if (trace)
    for (int k = 0; k < 144; ++k) trace->mtm[k] = A[k];
  const int rotations = jacobi_eigh<12>(A, V, lanes);
  if (trace) trace->rotations = rotations;
  int i0 = 0;
  for (int k = 1; k < 12; ++k)
    if (A[13 * k] < A[13 * i0]) i0 = k;
  int i1 = i0 == 0 ? 1 : 0;
  for (int k = i1 + 1; k < 12; ++k)
    if (k != i0 && A[13 * k] < A[13 * i1]) i1 = k;
  float cc1[4][3], cc2[4][3];
  for (int j = 0; j < 4; ++j)
    for (int k = 0; k < 3; ++k) {
      cc1[j][k] = V[12 * (3 * j + k) + i0];
      cc2[j][k] = V[12 * (3 * j + k) + i1];
    }
  if (trace)
    for (int k = 0; k < 12; ++k) {
      trace->evals[k] = A[13 * k];
      trace->kernel[0][k] = cc1[k / 3][k % 3];
      trace->kernel[1][k] = cc2[k / 3][k % 3];
    }
  lanes.sync();  // every lane has read V before A and V are used again

  // The six control-point distances, pairs (0, 1), (0, 2), (0, 3), (1, 2),
  // (1, 3), (2, 3).
  const int pi[6] = {0, 0, 0, 1, 1, 2}, pj[6] = {1, 2, 3, 2, 3, 3};
  float dist_w[6], dist_c[6], d1[6][3], d2[6][3];
  for (int e = 0; e < 6; ++e) {
    float dw[3];
    for (int k = 0; k < 3; ++k) {
      dw[k] = sub(C.ctrl[pj[e]][k], C.ctrl[pi[e]][k]);
      d1[e][k] = sub(cc1[pj[e]][k], cc1[pi[e]][k]);
      d2[e][k] = sub(cc2[pj[e]][k], cc2[pi[e]][k]);
    }
    dist_w[e] = rt::sqrt_rn(clamp_min(dot3(dw, dw), 1e-12f));
    dist_c[e] = rt::sqrt_rn(clamp_min(dot3(d1[e], d1[e]), 1e-20f));
  }
  // Case 1: the smallest eigenvector, scaled to the world's distances.
  float num = mul(dist_w[0], dist_c[0]), den = sq(dist_c[0]);
  for (int e = 1; e < 6; ++e) {
    num = add(num, mul(dist_w[e], dist_c[e]));
    den = add(den, sq(dist_c[e]));
  }
  const float beta = div(num, clamp_min(den, 1e-20f));
  float cam[4][3];
  for (int j = 0; j < 4; ++j)
    for (int k = 0; k < 3; ++k) cam[j][k] = mul(beta, cc1[j][k]);
  epnp_pose(p, C, cam, lanes, models[0]);
  // Case 2: b1 v1 + b2 v2 by least squares in (b1^2, b1 b2, b2^2).
  float Am[6][3], rhs[6];
  for (int e = 0; e < 6; ++e) {
    Am[e][0] = dot3(d1[e], d1[e]);
    Am[e][1] = mul(2.0f, dot3(d1[e], d2[e]));
    Am[e][2] = dot3(d2[e], d2[e]);
    rhs[e] = sq(dist_w[e]);
  }
  float AtA[9], Atb[3], inv[9], sol[3];
  for (int a = 0; a < 3; ++a) {
    for (int b = 0; b < 3; ++b) {
      float s = mul(Am[0][a], Am[0][b]);
      for (int e = 1; e < 6; ++e) s = add(s, mul(Am[e][a], Am[e][b]));
      AtA[3 * a + b] = s;
    }
    float s = mul(Am[0][a], rhs[0]);
    for (int e = 1; e < 6; ++e) s = add(s, mul(Am[e][a], rhs[e]));
    Atb[a] = s;
  }
  inv3x3(AtA, 1e-9f, inv);
  matvec3(inv, Atb, sol);
  const float b1 = rt::sqrt_rn(clamp_min(sol[0], 1e-20f));
  const float b2 = div(sol[1], clamp_min(b1, 1e-10f));
  for (int j = 0; j < 4; ++j)
    for (int k = 0; k < 3; ++k) cam[j][k] = add(mul(b1, cc1[j][k]), mul(b2, cc2[j][k]));
  epnp_pose(p, C, cam, lanes, models[1]);
}

// _pnp_residual of model m at point i, in fx-normalized units (inf behind
// the camera).
RT_FN float pose_residual(const float* m, const float* X, const float* pn, float ay) {
  float xc[3];
  for (int k = 0; k < 3; ++k)
    xc[k] = add(add(add(mul(X[0], m[3 * k]), mul(X[1], m[3 * k + 1])), mul(X[2], m[3 * k + 2])),
                m[9 + k]);
  const bool good = xc[2] > 1e-6f;
  const float z = good ? xc[2] : 1.0f;
  const float d0 = sub(div(xc[0], z), pn[0]), d1 = sub(div(xc[1], z), pn[1]);
  const float err = rt::sqrt_rn(add(sq(d0), sq(mul(ay, d1))));
  return good ? err : inf();
}

// _pnp_refit of one problem: the seed of least truncated MSAC among the
// RANSAC winner and the gated linear seeds (DLT-PnP at >= 6 inliers, EPnP
// at >= 4; the first on a tie), its rotation vector, max_iters LM passes,
// then exp_so3: out [12], the winner where a value is not finite.  A and V
// [144] are the Jacobi solver's (shared on the card); trace, where not
// null, gets what the choice saw.
template <class L>
RT_FN void refit_pose(const PoseProblem& p, const float* model_best, int max_iters, float* A,
                      float* V, const L& lanes, float* out, PoseSeedTrace* trace) {
  float cands[4][12];
  for (int k = 0; k < 12; ++k) cands[0][k] = model_best[k];
  dlt_pnp(p, lanes, cands[1]);
  epnp(p, A, V, lanes, cands + 2, trace);

  const float thr2 = mul(p.thr_n, p.thr_n);
  float acc[5];  // the inliers, then each candidate's MSAC
  lanes.template sum<5>([&](int l, float* a) {
    for (int i = l; i < p.n; i += kLanes) {
      a[0] = add(a[0], wt(p.inl[i]));
      for (int c = 0; c < 4; ++c) {
        const float r = pose_residual(cands[c], p.X + 3 * i, p.pix_n + 2 * i, p.ay);
        const float r2 = finite(r) ? mul(r, r) : inf();
        a[1 + c] = add(a[1 + c], mul(clamp_max(r2, thr2), p.mask[i]));
      }
    }
  }, acc);
  const bool gate[4] = {true, acc[0] >= 6.0f, acc[0] >= 4.0f, acc[0] >= 4.0f};
  float scores[4];
  int choice = 0;
  for (int c = 0; c < 4; ++c) {
    bool ok = true;
    for (int k = 0; k < 12; ++k) ok = ok && finite(cands[c][k]);
    scores[c] = ok ? acc[1 + c] : inf();
    const float gated = gate[c] ? scores[c] : inf();
    const float best = gate[choice] ? scores[choice] : inf();
    if (c > 0 && gated < best) choice = c;
  }
  if (trace) {
    for (int c = 0; c < 4; ++c) {
      for (int k = 0; k < 12; ++k) trace->cands[c][k] = cands[c][k];
      trace->scores[c] = scores[c];
    }
    trace->n_inl = acc[0];
    trace->choice = choice;
  }

  float x[6];
  log_so3(cands[choice], x);
  for (int k = 0; k < 3; ++k) x[3 + k] = cands[choice][9 + k];
  lm::run(lm::PoseOf<bool>{p.X, p.pix, p.K, p.inl, p.n}, x, max_iters, lanes);
  bool ok = true;
  for (int k = 0; k < 6; ++k) ok = ok && finite(x[k]);
  if (ok) {
    lm::exp_so3(x, out);
    for (int k = 0; k < 3; ++k) out[9 + k] = x[3 + k];
  } else {
    for (int k = 0; k < 12; ++k) out[k] = model_best[k];
  }
}

}  // namespace seed
