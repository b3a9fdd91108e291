// One hypothesis of the <= 16-point 8-point essential sweep
// (csrc/sweep_essential.cu).
//
// The arithmetic of the Pallas kernel `essential_ransac_sweep`
// (ransac_tpu/ops/pallas/sweep_essential.py:74-261) for one flat hypothesis
// id, in the order of the plain version `ransac_tpu_torch.ops.sweep_essential`:
// the 8-draw counter-PRNG sample of rows 2 and 5 (fp32_rn.cuh draw_sample,
// unsigned modulus, draws from the first n_points rows), the sample-mask bit
// test, the canonical-frame F of the large-pool sweep (its JAX solve is a
// copy of this kernel's: sweep_essential_large.cuh canonical_f), and the
// Sampson score of the n_score rows with N_ACC = 4 accumulator pairs, row n
// into pair n % 4, summed 0 + 1 + 2 + 3.  The TPU took an approximate
// reciprocal of the Sampson denominator; this one is exact.

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

// MSAC (normalized units), inlier count and packed sample of hypothesis
// `flat`; the pool's (sx, sy) are image 1, (dx, dy) image 2.  An invalid
// hypothesis (a masked point in the sample, a degenerate frame, a vanishing
// F) gets (3.4e38, -1).  The packed sample holds index j in bits 4j..4j+3,
// so its sign bit is the top bit of the last index.
RT_FN void eval(unsigned flat, const unsigned* seeds, int vmask, int n_points,
                int n_score, float thr_sq, const sweep::Pool& p, float* msac_out,
                float* count_out, int* packed_out) {
  using namespace rt;
  int idx[8];
  draw_sample<8>(flat, seeds, n_points, idx);
  int ok_bits = vmask >> idx[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) ok_bits &= vmask >> idx[j];
  float u1[8], v1[8], u2[8], v2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    u1[j] = p.sx[idx[j]];
    v1[j] = p.sy[idx[j]];
    u2[j] = p.dx[idx[j]];
    v2[j] = p.dy[idx[j]];
  }
  float F[9];
  const bool ok_f = sweep_essential_large::canonical_f(u1, v1, u2, v2, F);
  const bool valid = (ok_bits & 1) == 1 && ok_f;

  float cnt[kNAcc], ms[kNAcc];
#pragma unroll
  for (int k = 0; k < kNAcc; ++k) {
    cnt[k] = 0.0f;
    ms[k] = 0.0f;
  }
#pragma unroll
  for (int n = 0; n < kMaxPoints; ++n) {
    if (n < n_score) {
      sweep_essential_large::sampson(F, p.sx[n], p.sy[n], p.dx[n], p.dy[n],
                                     p.w[n], thr_sq, &cnt[n % kNAcc],
                                     &ms[n % kNAcc]);
    }
  }
  float count = cnt[0], msac = ms[0];
#pragma unroll
  for (int k = 1; k < kNAcc; ++k) {
    count = add(count, cnt[k]);
    msac = add(msac, ms[k]);
  }
  *msac_out = valid ? msac : sweep::kInvalid;
  *count_out = valid ? count : -1.0f;
  unsigned packed = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) packed |= static_cast<unsigned>(idx[j]) << (4 * j);
  *packed_out = static_cast<int>(packed);
}

}  // namespace sweep_essential
