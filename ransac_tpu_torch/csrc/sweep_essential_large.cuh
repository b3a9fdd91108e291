// One hypothesis of the large-pool 8-point essential sweep
// (csrc/sweep_essential_large.cu).
//
// The arithmetic of the Pallas kernel `essential_ransac_sweep_large`
// (ransac_tpu/ops/pallas/sweep_essential_large.py:151-339) and of its plain
// replica `minimal_f_canonical` (:63-148), in the order of the plain version
// `ransac_tpu_torch.ops.sweep_essential_large`: 8 windowed counter draws;
// the canonical adjugate frames T1, T2 of the first four points of each
// image (sweep.cuh's frame and adjugate, each scaled to unit Frobenius norm
// by rsqrt); the 4 x 5 system of the other four points in that frame and
// its generalized cross product by 2 x 2 minors; F = T2^T P of unit norm;
// and the division-deferred Sampson score of every table row (inlier iff
// (x2' F x1)^2 <= thr^2 * max(denom, 1e-12); MSAC term min(num, thr^2 *
// dmax) / dmax).  `eval` sums the rows as the plain version does, into N_ACC
// = 4 accumulator pairs, row r into pair r % 4; the kernel solves a
// hypothesis once (`solve`) and scores it with a warp, lane l summing rows
// l, l + 32, ... (`score_lane`), the 32 partial pairs then added by a fixed
// tree (`score_grouped` is that tree one lane after another).
// Under `Exact` each row's terms are the same either way; only the
// association of the sums differs.  The TPU took an approximate reciprocal
// of dmax; `Exact` divides.  rsqrt is rsqrtf on the card (torch.rsqrt
// there).  sampson takes its rounding from a policy (fp32_rn.cuh): the
// solve and `eval` are `Exact`; the kernels' scores (this sweep's
// score_lane and the <= 16-point sweep, sweep_essential.cuh) take `Fused`.

#pragma once

#include "sampler_large.cuh"
#include "sweep.cuh"

namespace sweep_essential_large {

constexpr int kMaxPoints = 1024;
constexpr int kLanes = 32;  // the kernel's lanes a hypothesis: a warp

// The table in valid-first pool order: (u1, v1, u2, v2, w) columns.
struct Table {
  const float* u1;
  const float* v1;
  const float* u2;
  const float* v2;
  const float* w;
};

// The adjugate frame of 4 points scaled to unit Frobenius norm, and its
// validity (every frame determinant above 1e-7 in magnitude).
RT_FN bool frame_adj(const float* xs, const float* ys, float T[3][3]) {
  using namespace rt;
  float A[3][3];
  const bool ok = sweep::frame(xs, ys, A);
  sweep::adjugate(A, T);
  float n2 = mul(T[0][0], T[0][0]);
#pragma unroll
  for (int k = 1; k < 9; ++k) n2 = add(n2, mul(T[k / 3][k % 3], T[k / 3][k % 3]));
  const float inv = rsqrt32(max_nan(n2, 1e-30f));
#pragma unroll
  for (int k = 0; k < 9; ++k) T[k / 3][k % 3] = mul(T[k / 3][k % 3], inv);
  return ok;
}

// The canonical-frame 8-point solve of the normalized sample (u1, v1) <->
// (u2, v2): F (row-major, unit Frobenius norm, not rank-2) and its validity.
RT_FN bool canonical_f(const float* u1, const float* v1, const float* u2,
                       const float* v2, float F[9]) {
  using namespace rt;
  float T1[3][3], T2[3][3];
  const bool ok1 = frame_adj(u1, v1, T1);
  const bool ok2 = frame_adj(u2, v2, T2);
  float rows[4][5];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float a = u1[4 + j], b = v1[4 + j], c = u2[4 + j], d = v2[4 + j];
    const float p = add(add(mul(T1[0][0], a), mul(T1[0][1], b)), T1[0][2]);
    const float q = add(add(mul(T1[1][0], a), mul(T1[1][1], b)), T1[1][2]);
    const float r = add(add(mul(T1[2][0], a), mul(T1[2][1], b)), T1[2][2]);
    const float s = add(add(mul(T2[0][0], c), mul(T2[0][1], d)), T2[0][2]);
    const float t = add(add(mul(T2[1][0], c), mul(T2[1][1], d)), T2[1][2]);
    const float w = add(add(mul(T2[2][0], c), mul(T2[2][1], d)), T2[2][2]);
    const float c0 = mul(s, q);
    rows[j][0] = sub(mul(s, r), c0);
    rows[j][1] = sub(mul(t, p), c0);
    rows[j][2] = sub(mul(t, r), c0);
    rows[j][3] = sub(mul(w, p), c0);
    rows[j][4] = sub(mul(w, q), c0);
  }
  // 2 x 2 minors of rows (0, 1) and (2, 3), m[i][j] for i < j.
  float m01[5][5], m23[5][5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = i + 1; j < 5; ++j) {
      m01[i][j] = sub(mul(rows[0][i], rows[1][j]), mul(rows[0][j], rows[1][i]));
      m23[i][j] = sub(mul(rows[2][i], rows[3][j]), mul(rows[2][j], rows[3][i]));
    }
  }
  auto det4 = [&](int a, int b, int c, int d) {
    return add(sub(add(add(sub(mul(m01[a][b], m23[c][d]), mul(m01[a][c], m23[b][d])),
                           mul(m01[a][d], m23[b][c])),
                       mul(m01[b][c], m23[a][d])),
                   mul(m01[b][d], m23[a][c])),
               mul(m01[c][d], m23[a][b]));
  };
  const float f13 = det4(1, 2, 3, 4);
  const float f21 = -det4(0, 2, 3, 4);
  const float f23 = det4(0, 1, 3, 4);
  const float f31 = -det4(0, 1, 2, 4);
  const float f32 = det4(0, 1, 2, 3);
  const float f12 = -add(add(add(add(f13, f21), f23), f31), f32);
  float P[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    P[0][c] = add(mul(f12, T1[1][c]), mul(f13, T1[2][c]));
    P[1][c] = add(mul(f21, T1[0][c]), mul(f23, T1[2][c]));
    P[2][c] = add(mul(f31, T1[0][c]), mul(f32, T1[1][c]));
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      F[3 * r + c] = add(add(mul(T2[0][r], P[0][c]), mul(T2[1][r], P[1][c])),
                         mul(T2[2][r], P[2][c]));
    }
  }
  float fn2 = mul(F[0], F[0]);
#pragma unroll
  for (int k = 1; k < 9; ++k) fn2 = add(fn2, mul(F[k], F[k]));
  const float finv = rsqrt32(max_nan(fn2, 1e-36f));
#pragma unroll
  for (int k = 0; k < 9; ++k) F[k] = mul(F[k], finv);
  return ok1 && ok2 && fn2 > 1e-30f;
}

// The division-deferred Sampson test of F on one correspondence (a, b) <->
// (c, d) of weight w, added to one accumulator pair: inlier iff
// (x2' F x1)^2 <= thr^2 * max(denom, 1e-12); MSAC term min(num, thr^2 *
// dmax) / dmax.
template <class P = rt::Exact>
RT_FN void sampson(const float F[9], float a, float b, float c, float d,
                   float w, float thr_sq, float* cnt, float* ms) {
  const float fx0 = P::dot_add(F[0], a, F[1], b, F[2]);
  const float fx1 = P::dot_add(F[3], a, F[4], b, F[5]);
  const float fx2 = P::dot_add(F[6], a, F[7], b, F[8]);
  const float ft0 = P::dot_add(F[0], c, F[3], d, F[6]);
  const float ft1 = P::dot_add(F[1], c, F[4], d, F[7]);
  const float e = P::dot_add(c, fx0, d, fx1, fx2);
  const float denom =
      P::mad(ft1, ft1, P::mad(ft0, ft0, P::prod_sum(fx0, fx0, fx1, fx1)));
  const float dmax = P::max(denom, 1e-12f);
  const float n2 = P::mul(e, e);
  const float t2 = P::mul(thr_sq, dmax);
  *cnt = P::add(*cnt, n2 <= t2 ? w : 0.0f);
  *ms = P::mad(P::mul(P::min(n2, t2), P::rcp(dmax)), w, *ms);
}

// The windowed sample of hypothesis `flat` (seeds[0..7] draw, seeds[8]
// places the windows of block_h-hypothesis blocks) and its canonical F;
// false for an invalid hypothesis, and for any with fewer than 8 valid
// points.
RT_FN bool solve(unsigned flat, const unsigned* seeds, int n_valid,
                 int block_h, const Table& t, float F[9]) {
  int slot[8];
  large::sample_slots<8>(flat, seeds, seeds[8], n_valid, block_h, slot);
  float u1[8], v1[8], u2[8], v2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    u1[j] = t.u1[slot[j]];
    v1[j] = t.v1[slot[j]];
    u2[j] = t.u2[slot[j]];
    v2[j] = t.v2[slot[j]];
  }
  return canonical_f(u1, v1, u2, v2, F) && n_valid >= 8;
}

// Lane `lane` of the kLanes lanes scoring F: the Sampson terms of rows
// lane, lane + kLanes, ... (< n_rows) in one accumulator pair, from zero.
template <class P = rt::Exact>
RT_FN void score_lane(const float F[9], const Table& t, int lane, int n_rows,
                      float thr_sq, float* cnt, float* ms) {
  *cnt = 0.0f;
  *ms = 0.0f;
  for (int n = lane; n < n_rows; n += kLanes)
    sampson<P>(F, t.u1[n], t.v1[n], t.u2[n], t.v2[n], t.w[n], thr_sq, cnt, ms);
}

#ifndef __CUDACC__
// The kernel's score one lane after another: every lane's pair
// (score_lane), then lane l adds lane l + h for h = 16, 8, ..., 1, as the
// kernel's shuffles do.  count and MSAC in lane 0's pair.
template <class P = rt::Exact>
inline void score_grouped(const float F[9], const Table& t, int n_rows,
                          float thr_sq, float* msac, float* count) {
  float c[kLanes], m[kLanes];
  for (int l = 0; l < kLanes; ++l) score_lane<P>(F, t, l, n_rows, thr_sq, &c[l], &m[l]);
  for (int h = kLanes / 2; h >= 1; h >>= 1) {
    for (int l = 0; l < h; ++l) {
      c[l] = rt::add(c[l], c[l + h]);
      m[l] = rt::add(m[l], m[l + h]);
    }
  }
  *count = c[0];
  *msac = m[0];
}
#endif

// MSAC (normalized units) and inlier count of hypothesis `flat` in the
// plain version's order (`solve`, then N_ACC = 4 accumulator pairs).  An
// invalid hypothesis gets (3.4e38, -1).
RT_FN void eval(unsigned flat, const unsigned* seeds, int n_valid,
                int block_h, int n_rows, float thr_sq, const Table& t,
                float* msac_out, float* count_out) {
  using namespace rt;
  float F[9];
  const bool valid = solve(flat, seeds, n_valid, block_h, t, F);

  float cnt[large::kNAcc], ms[large::kNAcc];
#pragma unroll
  for (int k = 0; k < large::kNAcc; ++k) {
    cnt[k] = 0.0f;
    ms[k] = 0.0f;
  }
  for (int n0 = 0; n0 < n_rows; n0 += large::kNAcc) {
#pragma unroll
    for (int k = 0; k < large::kNAcc; ++k) {
      const int n = n0 + k;
      sampson(F, t.u1[n], t.v1[n], t.u2[n], t.v2[n], t.w[n], thr_sq, &cnt[k], &ms[k]);
    }
  }
  float count = cnt[0], msac = ms[0];
#pragma unroll
  for (int k = 1; k < large::kNAcc; ++k) {
    count = add(count, cnt[k]);
    msac = add(msac, ms[k]);
  }
  *msac_out = valid ? msac : large::kBig;
  *count_out = valid ? count : -1.0f;
}

}  // namespace sweep_essential_large
