// One hypothesis of the <= 16-point 8-point essential sweep
// (csrc/sweep_essential.cu).
//
// The arithmetic of the Pallas kernel `essential_ransac_sweep`
// (ransac_tpu/ops/pallas/sweep_essential.py:74-261) for one flat hypothesis
// id, in the order of the plain version `ransac_tpu_torch.ops.sweep_essential`:
// the 8-draw counter-PRNG sample of rows 2 and 5 (fp32_rn.cuh
// draw_sample_fast, unsigned modulus by multiply-high, draws from the first
// n_points rows), the sample-mask bit test, the canonical-frame F of the
// large-pool sweep (its JAX solve is a copy of this kernel's:
// sweep_essential_large.cuh canonical_f), and the Sampson score of the
// n_score rows.  The TPU took an approximate reciprocal of the Sampson
// denominator.  The policy P rounds the score only: the canonical solve
// rounds every operation on its own under both, so F is the plain
// version's bit for bit (fused, the solve's last-place differences grew on
// ill-conditioned samples until the winner's count changed).  With the
// `Exact` policy the score sums into N_ACC = 4 accumulator pairs, row n into
// pair n % 4, summed 0 + 1 + 2 + 3 (the plain version's order); the
// kernel's `Fused` policy sums into one pair per hypothesis.

#pragma once

#include "sweep.cuh"
#include "sweep_essential_large.cuh"

namespace sweep_essential {

constexpr int kMaxPoints = 16;
constexpr int kNAcc = 4;

// The JAX wrapper's shared normalization (sweep_essential.py:331-335): the
// centroid of each image over the first n_points rows, unmasked, and one
// scale sqrt(2) / (the mean distance over both images).
// out = (m1 x, m1 y, m2 x, m2 y, s).
RT_FN void norm_params(const float* x1, const float* x2, int n_points,
                       float out[5]) {
  using namespace rt;
  float c1[3], c2[3];
  sweep::centroid_dist(x1, n_points, c1);
  sweep::centroid_dist(x2, n_points, c2);
  out[0] = c1[0];
  out[1] = c1[1];
  out[2] = c2[0];
  out[3] = c2[1];
  out[4] = div(1.4142135623730951f,
               max_nan(div(add(c1[2], c2[2]), static_cast<float>(2 * n_points)),
                       1e-12f));
}

// MSAC (normalized units), inlier count and packed sample of the K
// hypotheses flat0 + k * step (k < K), drawn with divs[j] = n_points - j;
// the pool's (sx, sy) are image 1, (dx, dy) image 2.  An invalid hypothesis
// (a masked point in the sample, a degenerate frame, a vanishing F) gets
// (3.4e38, -1).  The packed sample holds index j in bits 4j..4j+3, so its
// sign bit is the top bit of the last index.  Each pool point is loaded once
// and scored against the K F's.
template <class P, int K>
RT_FN void eval(unsigned flat0, unsigned step, const unsigned* seeds,
                const rt::Divider* divs, int vmask, int n_score, float thr_sq,
                const sweep::Pool& p, float* msac_out, float* count_out,
                int* packed_out) {
  constexpr int kAcc = P::kFused ? 1 : kNAcc;
  float F[K][9];
  bool valid[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int idx[8];
    rt::draw_sample_fast<8>(flat0 + k * step, seeds, divs, idx);
    int ok_bits = vmask >> idx[0];
#pragma unroll
    for (int j = 1; j < 8; ++j) ok_bits &= vmask >> idx[j];
    float u1[8], v1[8], u2[8], v2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float q[4];
      sweep::load_point(p.pts, idx[j], q);
      u1[j] = q[0];
      v1[j] = q[1];
      u2[j] = q[2];
      v2[j] = q[3];
    }
    const bool ok_f = sweep_essential_large::canonical_f(u1, v1, u2, v2, F[k]);
    valid[k] = (ok_bits & 1) == 1 && ok_f;
    unsigned packed = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) packed |= static_cast<unsigned>(idx[j]) << (4 * j);
    packed_out[k] = static_cast<int>(packed);
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
      sweep::load_point(p.pts, n, q);
      const float pw = p.w[n];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        sweep_essential_large::sampson<P>(F[k], q[0], q[1], q[2], q[3], pw, thr_sq,
                                          &cnt[k][n % kAcc], &ms[k][n % kAcc]);
      }
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
    msac_out[k] = valid[k] ? msac : sweep::kInvalid;
    count_out[k] = valid[k] ? count : -1.0f;
  }
}

}  // namespace sweep_essential
