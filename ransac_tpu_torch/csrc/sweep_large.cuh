// One hypothesis of the large-pool homography sweep (csrc/sweep_large.cu).
//
// The arithmetic of the Pallas kernel `homography_ransac_sweep_large`
// (ransac_tpu/ops/pallas/sweep_large.py:188-342) for one flat hypothesis id,
// in the order of the plain version
// `ransac_tpu_torch.ops.sweep_large._score_plain`: the windowed counter
// sample of 4 pool slots (sampler_large.cuh), the rows read from the table
// directly (the TPU kernel's one-hot gather loop picks the same values), the
// projective-frame homography of sweep.cuh, and the division-deferred score
// of every table row (padded rows carry weight 0) with N_ACC = 4 accumulator
// pairs, row r into pair r % 4, summed 0 + 1 + 2 + 3.  The TPU took an
// approximate reciprocal of w^2; this one is exact.

#pragma once

#include "sampler_large.cuh"
#include "sweep.cuh"

namespace sweep_large {

constexpr int kBlockH = 2048;
constexpr int kMaxPoints = 1024;

// The table in valid-first pool order, one column per field, n_rows rows.
struct Table {
  const float* x;
  const float* y;
  const float* px;
  const float* py;
  const float* w;
};

// MSAC (normalized units) and inlier count of hypothesis `flat`; seeds[0..3]
// draw, seeds[4] places the windows.  An invalid hypothesis (a degenerate
// frame, or fewer than 4 valid points) gets (3.4e38, -1).
RT_FN void eval(unsigned flat, const unsigned* seeds, int n_valid, int n_rows,
                float thr_sq, const Table& t, float* msac_out,
                float* count_out) {
  using namespace rt;
  int slot[4];
  large::sample_slots<4>(flat, seeds, seeds[4], n_valid, kBlockH, slot);
  float sx[4], sy[4], dx[4], dy[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sx[j] = t.x[slot[j]];
    sy[j] = t.y[slot[j]];
    dx[j] = t.px[slot[j]];
    dy[j] = t.py[slot[j]];
  }
  float H[9];
  const bool valid = sweep::solve_frames(sx, sy, dx, dy, H) && n_valid >= 4;

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
      const float x = t.x[n], y = t.y[n];
      const float u = add(add(mul(H[0], x), mul(H[1], y)), H[2]);
      const float v = add(add(mul(H[3], x), mul(H[4], y)), H[5]);
      const float w = add(add(mul(H[6], x), mul(H[7], y)), H[8]);
      const float a = sub(u, mul(t.px[n], w));
      const float b = sub(v, mul(t.py[n], w));
      const float r2 = add(mul(a, a), mul(b, b));
      const float w2 = max_nan(mul(w, w), 1e-30f);
      const float tt = mul(thr_sq, w2);
      const float iw2 = rcp(w2);
      cnt[k] = add(cnt[k], r2 <= tt ? t.w[n] : 0.0f);
      ms[k] = add(ms[k], mul(mul(min_nan(r2, tt), iw2), t.w[n]));
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

}  // namespace sweep_large
