// K hypotheses of the large-pool homography sweep (csrc/sweep_large.cu).
//
// The arithmetic of the Pallas kernel `homography_ransac_sweep_large`
// (ransac_tpu/ops/pallas/sweep_large.py:188-342) for K flat hypothesis ids,
// in the order of the plain version
// `ransac_tpu_torch.ops.sweep_large._score_plain`: the windowed counter
// sample of 4 pool slots (sampler_large.cuh), the rows read from the table
// directly (the TPU kernel's one-hot gather loop picks the same values), the
// projective-frame homography of sweep.cuh, and the division-deferred score
// of every table row (padded rows carry weight 0) with N_ACC = 4 accumulator
// pairs a hypothesis, row r into pair r % 4, summed 0 + 1 + 2 + 3.  Each
// table row is loaded once and scored against the K homographies.
//
// The score takes its rounding from a policy (fp32_rn.cuh): `Exact` is the
// plain version's arithmetic bit for bit, `Fused` (the kernel's) rounds each
// product-sum once from the residual on and takes MUFU's reciprocal of w^2,
// where the TPU took an approximate one.  Under both the projection (u, v,
// w) = H (x, y, 1) keeps the plain order: near the line at infinity of a
// near-degenerate H, w is a small difference of O(1) terms, and fused there
// it moved a count off the inlier cut and an MSAC by 7.3e-3 on a 90-point
// check case (host build; float64 sided with the fused order there, but the
// hold is to the plain version's decisions).
// The frame solve is `Exact` too: ~93 operations against ~19 a row (under
// 1% of a hypothesis at 1024 rows), and every hypothesis' validity stays
// the plain version's.

#pragma once

#include "sampler_large.cuh"
#include "sweep.cuh"

namespace sweep_large {

constexpr int kBlockH = 2048;
constexpr int kMaxPoints = 1024;

// The table in valid-first pool order, n_rows rows: row n as (x, y, px, py)
// at pts[4n..4n+3] (16-byte aligned: one vector load) and its weight w[n].
using Table = sweep::Pool;

// MSAC (normalized units) and inlier count of the K hypotheses flat0 + k *
// step (k < K, all in one block of kBlockH); seeds[0..3] draw, seeds[4]
// places the windows.  An invalid hypothesis (a degenerate frame, or fewer
// than 4 valid points) gets (3.4e38, -1).
template <class P, int K>
RT_FN void eval(unsigned flat0, unsigned step, const unsigned* seeds,
                int n_valid, int n_rows, float thr_sq, const Table& t,
                float* msac_out, float* count_out) {
  float H[K][9];
  bool valid[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int slot[4];
    large::sample_slots<4>(flat0 + k * step, seeds, seeds[4], n_valid, kBlockH,
                           slot);
    float sx[4], sy[4], dx[4], dy[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float q[4];
      sweep::load_point(t.pts, slot[j], q);
      sx[j] = q[0];
      sy[j] = q[1];
      dx[j] = q[2];
      dy[j] = q[3];
    }
    valid[k] = sweep::solve_frames<rt::Exact>(sx, sy, dx, dy, H[k]) &&
               n_valid >= 4;
  }

  float cnt[K][large::kNAcc], ms[K][large::kNAcc];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int a = 0; a < large::kNAcc; ++a) {
      cnt[k][a] = 0.0f;
      ms[k][a] = 0.0f;
    }
  }
  for (int n0 = 0; n0 < n_rows; n0 += large::kNAcc) {
#pragma unroll
    for (int a = 0; a < large::kNAcc; ++a) {
      float q[4];
      sweep::load_point(t.pts, n0 + a, q);
      const float pw = t.w[n0 + a];
#pragma unroll
      for (int k = 0; k < K; ++k)
        sweep::score_point<P, rt::Exact>(H[k], q, pw, thr_sq, &cnt[k][a],
                                         &ms[k][a]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float count = cnt[k][0], msac = ms[k][0];
#pragma unroll
    for (int a = 1; a < large::kNAcc; ++a) {
      count = P::add(count, cnt[k][a]);
      msac = P::add(msac, ms[k][a]);
    }
    msac_out[k] = valid[k] ? msac : large::kBig;
    count_out[k] = valid[k] ? count : -1.0f;
  }
}

}  // namespace sweep_large
