"""Host build of the port's per-hypothesis kernel arithmetic.

``ransac_tpu_torch/csrc/sweep.cuh``, ``sweep_pnp.cuh``,
``sweep_essential.cuh``, ``score.cuh`` and the large-pool headers
(``sampler_large.cuh``, ``sweep_large.cuh``, ``sweep_essential_large.cuh``)
hold the arithmetic of one hypothesis (one model) of the sweep and scoring
kernels; without ``__CUDACC__`` they compile as plain C++.
``load()`` builds them with the host C++ compiler (``-ffp-contract=off``:
every operation rounded on its own, as on the card, and an FMA only where
the source writes ``fmaf``) into a small library that evaluates every
hypothesis, so the CPU tests can hold the kernels' arithmetic against the
plain PyTorch versions: bit for bit under the ``Exact`` policy, by the
kernels' decision-level criteria under ``Fused`` (whose host build divides
where the card takes MUFU's reciprocal).  The
large-pool entries also run the prep kernels' steps one thread after
another (the same pairwise sums in the same pairing, the same ranks).
Returns None where there is no C++ compiler.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parents[1] / "ransac_tpu_torch" / "csrc"

SHIM = r"""
#include "sweep.cuh"
#include "sweep_pnp.cuh"
#include "sweep_large.cuh"
#include "sweep_essential_large.cuh"
#include "sweep_essential.cuh"
#include "sweep_multi.cuh"
#include "score.cuh"
#include "lm.cuh"

// The prep kernels' order of n keys: slot[i] = the rank of row i's word key
// << 32 | i (large::count_below over the 32 lanes' shares, as the warp of
// large::pool_slot counts them), order its inverse.
extern "C" void pool_sort(const unsigned* keys, int n, int* slot, int* order) {
  unsigned long long w[1024];
  for (int i = 0; i < n; ++i) w[i] = large::pool_word(i, keys[i]);
  for (int i = 0; i < n; ++i) {
    int rank = 0;
    for (int lane = 0; lane < 32; ++lane) rank += large::count_below(w[i], w, n, lane, 32);
    slot[i] = rank;
    order[rank] = i;
  }
}

// The prep kernels' pool order: the rows sorted by their shuffle keys.
static void pool_order(const float* mask, int n, unsigned seed, int* slot,
                       int* order) {
  unsigned keys[1024];
  for (int i = 0; i < n; ++i) keys[i] = large::shuffle_key(i, seed, mask[i] > 0.0f);
  pool_sort(keys, n, slot, order);
}

// Row 3: count and MSAC of H models [H, 9] over the n raw points (the pool
// zero past n, as the kernel's prologue writes it), the Exact (fused = 0)
// or Fused policy.
extern "C" void homography_scores_host(const float* models, const float* src,
    const float* dst, const float* mask, int n, float thr_sq, int H, int fused,
    float* count, float* msac) {
  alignas(16) float pts[4 * score::kMaxPoints] = {};
  float w[score::kMaxPoints] = {};
  for (int k = 0; k < n; ++k) {
    pts[4 * k] = src[2 * k];
    pts[4 * k + 1] = src[2 * k + 1];
    pts[4 * k + 2] = dst[2 * k];
    pts[4 * k + 3] = dst[2 * k + 1];
    w[k] = mask[k];
  }
  const sweep::Pool p{pts, w};
  for (int h = 0; h < H; ++h) {
    if (fused) score::homography<rt::Fused>(models + 9 * h, p, n, thr_sq, &count[h], &msac[h]);
    else score::homography<rt::Exact>(models + 9 * h, p, n, thr_sq, &count[h], &msac[h]);
  }
}

// Row 4: count and MSAC of H poses [H, 12] over the n raw points X [n, 3],
// pix [n, 2] (the pool zero past n), the Exact (fused = 0) or Fused policy.
extern "C" void pnp_scores_host(const float* models, const float* X,
    const float* pix, const float* mask, int n, float thr_sq, int H, int fused,
    float* count, float* msac) {
  alignas(16) float xyzw[4 * score::kMaxPoints] = {};
  float px[2 * score::kMaxPoints] = {};
  for (int k = 0; k < n; ++k) {
    for (int c = 0; c < 3; ++c) xyzw[4 * k + c] = X[3 * k + c];
    xyzw[4 * k + 3] = mask[k];
    px[2 * k] = pix[2 * k];
    px[2 * k + 1] = pix[2 * k + 1];
  }
  const sweep_pnp::Table p{xyzw, px};
  for (int h = 0; h < H; ++h) {
    if (fused) score::pose<rt::Fused>(models + 12 * h, p, n, thr_sq, &count[h], &msac[h]);
    else score::pose<rt::Exact>(models + 12 * h, p, n, thr_sq, &count[h], &msac[h]);
  }
}

// The prep kernels' pairwise tree sum of x[0..n) in their column order
// (large::tree_sums), one addition after another.
static float tsum(const float* x, int n) { return large::tree_sum_cols(x, n); }

extern "C" float tree_sum_cols(const float* x, int n) { return tsum(x, n); }

// Masked centroid of a [n, 2] and the sum of masked distances to it.
static void centroid_dist(const float* a, const float* m, int n, float cnt,
                          float out[3]) {
  using namespace rt;
  float t[1024];
  for (int i = 0; i < n; ++i) t[i] = mul(a[2 * i], m[i]);
  out[0] = div(tsum(t, n), cnt);
  for (int i = 0; i < n; ++i) t[i] = mul(a[2 * i + 1], m[i]);
  out[1] = div(tsum(t, n), cnt);
  for (int i = 0; i < n; ++i) {
    const float qx = sub(a[2 * i], out[0]), qy = sub(a[2 * i + 1], out[1]);
    t[i] = mul(sqrt_rn(add(mul(qx, qx), mul(qy, qy))), m[i]);
  }
  out[2] = tsum(t, n);
}

static int n_valid_of(const float* mask, int n) {
  int v = 0;
  for (int i = 0; i < n; ++i) v += mask[i] > 0.0f;
  return v;
}

// The kernels' thread mapping of rows 2, 6 and 7: thread g of n_hyp / K holds
// the K hypotheses s = c * K + k of record r = g / (8 / K), c = g % (8 / K);
// eval(r, c) runs one thread.
template <int K, class Eval>
static void each_thread(int n_hyp, Eval eval) {
  for (int g = 0; g < n_hyp / K; ++g) eval(g / (8 / K), g % (8 / K));
}

// Row 6: table [n_rows, 5] (pool order), order [n], and msac / count of
// every flat id (normalized units); the score under policy P, K hypotheses
// a thread as the kernel maps them (thread (r, c) holds the flat ids of
// s = c * K + k, record r).
template <class P, int K>
static void sweep_large_full_k(const float* src, const float* dst,
    const float* mask, int n, float threshold, const unsigned* seeds,
    int n_hyp, float* table, int* order, float* msac, float* count) {
  using namespace rt;
  int slot[1024];
  pool_order(mask, n, seeds[5], slot, order);
  const float cnt = max_nan(tsum(mask, n), 1.0f);
  float ps[3], pd[3];
  centroid_dist(src, mask, n, cnt, ps);
  centroid_dist(dst, mask, n, cnt, pd);
  const float s_src = div(1.4142135623730951f, max_nan(div(ps[2], cnt), 1e-12f));
  const float s_dst = div(1.4142135623730951f, max_nan(div(pd[2], cnt), 1e-12f));
  const int n_rows = large::table_rows(n);
  alignas(16) static float pts[4 * 1024];
  static float w[1024];
  for (int k = 0; k < 4 * n_rows; ++k) pts[k] = 0.0f;
  for (int k = 0; k < n_rows; ++k) w[k] = 0.0f;
  for (int i = 0; i < n; ++i) {
    pts[4 * slot[i]] = mul(sub(src[2 * i], ps[0]), s_src);
    pts[4 * slot[i] + 1] = mul(sub(src[2 * i + 1], ps[1]), s_src);
    pts[4 * slot[i] + 2] = mul(sub(dst[2 * i], pd[0]), s_dst);
    pts[4 * slot[i] + 3] = mul(sub(dst[2 * i + 1], pd[1]), s_dst);
    w[slot[i]] = mask[i];
  }
  for (int k = 0; k < n_rows; ++k) {
    for (int c = 0; c < 4; ++c) table[5 * k + c] = pts[4 * k + c];
    table[5 * k + 4] = w[k];
  }
  const sweep_large::Table t{pts, w};
  const float thr_sq = sweep::threshold_sq(threshold, s_dst);
  const int nv = n_valid_of(mask, n);
  each_thread<K>(n_hyp, [&](int r, int c) {
    const unsigned flat0 = (unsigned)((r >> 8) * 2048 + c * K * 256 + (r & 255));
    float m[K], cn[K];
    sweep_large::eval<P, K>(flat0, 256, seeds, nv, n_rows, thr_sq, t, m, cn);
    for (int k = 0; k < K; ++k) {
      msac[flat0 + k * 256] = m[k];
      count[flat0 + k * 256] = cn[k];
    }
  });
}

// Row 9: table [n_rows, 9] (X Y Z, bearing, x, ay y, w), order [n],
// msac / count [4, n_hyp] by flat id; the score under policy Pol (every
// valid pose scored, an invalid one (3.4e38, -1)).
template <class Pol>
static void sweep_pnp_large_full_k(const float* X, const float* pix,
    const float* mask, int n, float thr_sq, float ay, const unsigned* seeds,
    int n_hyp, int block_h, float* table, int* order, float* msac, float* count) {
  using namespace rt;
  int slot[1024];
  pool_order(mask, n, seeds[4], slot, order);
  const int n_rows = large::table_rows(n);
  static float col[9][1024];
  static float xyzw[4 * 1024], px[2 * 1024];
  for (int c = 0; c < 9; ++c)
    for (int k = 0; k < n_rows; ++k) col[c][k] = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float p0 = pix[2 * i], p1 = pix[2 * i + 1];
    const float nrm = sqrt_rn(add(add(mul(p0, p0), mul(p1, p1)), 1.0f));
    const float v[9] = {X[3 * i], X[3 * i + 1], X[3 * i + 2], div(p0, nrm),
                        div(p1, nrm), div(1.0f, nrm), p0, mul(p1, ay), mask[i]};
    for (int c = 0; c < 9; ++c) col[c][slot[i]] = v[c];
  }
  for (int k = 0; k < n_rows; ++k) {
    for (int c = 0; c < 9; ++c) table[9 * k + c] = col[c][k];
    const float q[6] = {col[0][k], col[1][k], col[2][k], col[8][k], col[6][k], col[7][k]};
    for (int c = 0; c < 4; ++c) xyzw[4 * k + c] = q[c];
    px[2 * k] = q[4];
    px[2 * k + 1] = q[5];
  }
  const sweep_pnp::Table t{xyzw, px};
  const int nv = n_valid_of(mask, n);
  for (int f = 0; f < n_hyp; ++f) {
    int sl[3];
    large::sample_slots<3>((unsigned)f, seeds, seeds[3], nv, block_h, sl);
    float P[3][3], F[3][3];
    for (int j = 0; j < 3; ++j)
      for (int q = 0; q < 3; ++q) {
        P[j][q] = col[q][sl[j]];
        F[j][q] = col[3 + q][sl[j]];
      }
    sweep_pnp::Pose pose[4];
    bool valid[4];
    sweep_pnp::solve_poses(P, F, nv >= 3, ay, pose, valid);
    for (int k = 0; k < 4; ++k) {
      float m = sweep_pnp::kBig, c = -1.0f;
      if (valid[k]) sweep_pnp::score_pose<Pol>(pose[k], t, n_rows, thr_sq, &m, &c);
      msac[(long)k * n_hyp + f] = m;
      count[(long)k * n_hyp + f] = c;
    }
  }
}

extern "C" void sweep_pnp_large_full(const float* X, const float* pix,
    const float* mask, int n, float thr_sq, float ay, const unsigned* seeds,
    int n_hyp, int block_h, int fused, float* table, int* order, float* msac,
    float* count) {
  if (fused)
    sweep_pnp_large_full_k<rt::Fused>(X, pix, mask, n, thr_sq, ay, seeds, n_hyp,
                                      block_h, table, order, msac, count);
  else
    sweep_pnp_large_full_k<rt::Exact>(X, pix, mask, n, thr_sq, ay, seeds, n_hyp,
                                      block_h, table, order, msac, count);
}

// Row 8: table [n_rows, 5], order [n], norm (m1x, m1y, m2x, m2y, s, thr),
// msac / count by flat id (normalized units); grouped = 0 sums the rows as
// the plain version (eval), grouped = 1 as the kernel's 32 lanes (solve,
// then score_grouped), the score under Exact or (fused) Fused.
extern "C" void sweep_essential_large_full(const float* x1, const float* x2,
    const float* mask, int n, float threshold_sq, const unsigned* seeds,
    int n_hyp, int block_h, int grouped, int fused, float* table, int* order,
    float* norm, float* msac, float* count) {
  using namespace rt;
  int slot[1024];
  pool_order(mask, n, seeds[9], slot, order);
  const float wsum = max_nan(tsum(mask, n), 1.0f);
  float c1[3], c2[3];
  centroid_dist(x1, mask, n, wsum, c1);
  centroid_dist(x2, mask, n, wsum, c2);
  const float s = div(1.4142135623730951f,
                      max_nan(div(add(c1[2], c2[2]), mul(2.0f, wsum)), 1e-12f));
  const int n_rows = large::table_rows(n);
  static float col[5][1024];
  for (int c = 0; c < 5; ++c)
    for (int k = 0; k < n_rows; ++k) col[c][k] = 0.0f;
  for (int i = 0; i < n; ++i) {
    col[0][slot[i]] = mul(sub(x1[2 * i], c1[0]), s);
    col[1][slot[i]] = mul(sub(x1[2 * i + 1], c1[1]), s);
    col[2][slot[i]] = mul(sub(x2[2 * i], c2[0]), s);
    col[3][slot[i]] = mul(sub(x2[2 * i + 1], c2[1]), s);
    col[4][slot[i]] = mask[i];
  }
  for (int k = 0; k < n_rows; ++k)
    for (int c = 0; c < 5; ++c) table[5 * k + c] = col[c][k];
  const float thr = mul(mul(threshold_sq, s), s);
  const float vals[6] = {c1[0], c1[1], c2[0], c2[1], s, thr};
  for (int k = 0; k < 6; ++k) norm[k] = vals[k];
  const sweep_essential_large::Table t{col[0], col[1], col[2], col[3], col[4]};
  const int nv = n_valid_of(mask, n);
  for (int f = 0; f < n_hyp; ++f) {
    if (!grouped) {
      sweep_essential_large::eval((unsigned)f, seeds, nv, block_h, n_rows, thr, t,
                                  &msac[f], &count[f]);
      continue;
    }
    float F[9];
    const bool ok = sweep_essential_large::solve((unsigned)f, seeds, nv, block_h, t, F);
    if (fused)
      sweep_essential_large::score_grouped<rt::Fused>(F, t, n_rows, thr, &msac[f], &count[f]);
    else
      sweep_essential_large::score_grouped<rt::Exact>(F, t, n_rows, thr, &msac[f], &count[f]);
    if (!ok) {
      msac[f] = large::kBig;
      count[f] = -1.0f;
    }
  }
}

// Row 1: every sample's (msac, count) [C, H] (normalized units) of the
// normalized inputs src [C, 16, 2], dst [16, 2], mask [16] and the sample
// table idx [4, H], a sample at a time as the kernel takes them; the score
// under Exact (fused = 0) or Fused, the solve and the projection under Exact
// unless solve_fused (and fused).
template <class P, class Solve, class Proj>
static void sweep_multi_full_p(const float* src, const float* dst,
    const float* mask, float thr_sq, const int* idx, int C, int H, int n,
    float* msac, float* count) {
  float pts[5][16];
  for (int p = 0; p < 16; ++p) {
    pts[2][p] = dst[2 * p];
    pts[3][p] = dst[2 * p + 1];
    pts[4][p] = mask[p];
  }
  const sweep_multi::Points pt{pts[0], pts[1], pts[2], pts[3], pts[4]};
  for (int c = 0; c < C; ++c) {
    for (int p = 0; p < 16; ++p) {
      pts[0][p] = src[(c * 16 + p) * 2];
      pts[1][p] = src[(c * 16 + p) * 2 + 1];
    }
    for (int h = 0; h < H; ++h) {
      const int i[4] = {idx[h], idx[H + h], idx[2 * H + h], idx[3 * H + h]};
      int packed;
      sweep_multi::eval<P, Solve, Proj>(i, pt, n, thr_sq, &msac[(long)c * H + h],
                                        &count[(long)c * H + h], &packed);
    }
  }
}

extern "C" void sweep_multi_full(const float* src, const float* dst,
    const float* mask, float thr_sq, const int* idx, int C, int H, int n,
    int fused, int solve_fused, float* msac, float* count) {
  using rt::Exact;
  using rt::Fused;
#define MULTI_ARGS src, dst, mask, thr_sq, idx, C, H, n, msac, count
  if (!fused) sweep_multi_full_p<Exact, Exact, Exact>(MULTI_ARGS);
  else if (solve_fused) sweep_multi_full_p<Fused, Fused, Fused>(MULTI_ARGS);
  else sweep_multi_full_p<Fused, Exact, Exact>(MULTI_ARGS);
#undef MULTI_ARGS
}

// Row 2 on raw points: full records (f [2, n_hyp] = rescaled msac, counts;
// i [n_hyp]) in s * B + r order, the prep kernel's normalization included;
// the Exact (fused = 0) or Fused policy, K hypotheses a thread.
template <class P, int K>
static void sweep_full_k(const float* src, const float* dst, const float* mask,
    float threshold, const unsigned* seeds, int n_points, int n_score,
    int n_hyp, float* f_out, int* i_out) {
  float ps[3], pd[3];
  sweep::norm_params(src, n_points, ps);
  sweep::norm_params(dst, n_points, pd);
  alignas(16) float pts[64] = {};
  float w[16] = {};
  for (int i = 0; i < n_score; ++i) {
    pts[4 * i] = rt::mul(rt::sub(src[2 * i], ps[0]), ps[2]);
    pts[4 * i + 1] = rt::mul(rt::sub(src[2 * i + 1], ps[1]), ps[2]);
    pts[4 * i + 2] = rt::mul(rt::sub(dst[2 * i], pd[0]), pd[2]);
    pts[4 * i + 3] = rt::mul(rt::sub(dst[2 * i + 1], pd[1]), pd[2]);
    w[i] = mask[i];
  }
  const sweep::Pool p{pts, w};
  rt::Divider divs[4];
  for (int j = 0; j < 4; ++j) divs[j] = rt::make_divider(n_points - j);
  const int vmask = sweep::sample_bitmask(mask, n_score);
  const float thr_sq = sweep::threshold_sq(threshold, pd[2]);
  const float inv_s2 = rt::rcp(rt::mul(pd[2], pd[2]));
  const int B = n_hyp / 8;
  each_thread<K>(n_hyp, [&](int r, int c) {
    const unsigned flat0 = (unsigned)((r >> 8) * 2048 + c * K * 256 + (r & 255));
    float m[K], cnt[K];
    int pk[K];
    sweep::eval<P, K>(flat0, 256, seeds, divs, vmask, n_score, thr_sq, p, m, cnt, pk);
    for (int k = 0; k < K; ++k) {
      const long o = (long)(c * K + k) * B + r;
      f_out[o] = sweep::rescale(m[k], inv_s2);
      f_out[n_hyp + o] = cnt[k];
      i_out[o] = pk[k];
    }
  });
}

// Row 7 on raw points: full records as sweep_full, its prep included.
template <class P, int K>
static void sweep_essential_full_k(const float* x1, const float* x2,
    const float* mask, float threshold_sq, const unsigned* seeds, int n_points,
    int n_score, int n_hyp, int block_h, float* f_out, int* i_out) {
  using namespace rt;
  float par[5];
  sweep_essential::norm_params(x1, x2, n_points, par);
  const float s = par[4];
  alignas(16) float pts[64] = {};
  float w[16] = {};
  for (int i = 0; i < n_score; ++i) {
    pts[4 * i] = mul(sub(x1[2 * i], par[0]), s);
    pts[4 * i + 1] = mul(sub(x1[2 * i + 1], par[1]), s);
    pts[4 * i + 2] = mul(sub(x2[2 * i], par[2]), s);
    pts[4 * i + 3] = mul(sub(x2[2 * i + 1], par[3]), s);
    w[i] = mask[i];
  }
  const sweep::Pool p{pts, w};
  rt::Divider divs[8];
  for (int j = 0; j < 8; ++j) divs[j] = rt::make_divider(n_points - j);
  const rt::Divider lan_div = rt::make_divider(block_h / 8);
  const int vmask = sweep::sample_bitmask(mask, n_score);
  const float thr = mul(mul(threshold_sq, s), s);
  const float inv_s2 = rcp(mul(s, s));
  const int B = n_hyp / 8, lan = block_h / 8;
  each_thread<K>(n_hyp, [&](int r, int c) {
    const unsigned rb = udiv((unsigned)r, lan_div);
    const unsigned flat0 = (rb * 8 + c * K) * (unsigned)lan + ((unsigned)r - rb * lan);
    float m[K], cnt[K];
    int pk[K];
    sweep_essential::eval<P, K>(flat0, lan, seeds, divs, vmask, n_score, thr, p, m,
                                cnt, pk);
    for (int k = 0; k < K; ++k) {
      const long o = (long)(c * K + k) * B + r;
      f_out[o] = sweep::rescale(m[k], inv_s2);
      f_out[n_hyp + o] = cnt[k];
      i_out[o] = pk[k];
    }
  });
}

// k = 2 or 4 hypotheses a thread.
#define DISPATCH(fn, P, k, ...) \
  if (k == 2) fn<P, 2>(__VA_ARGS__); else fn<P, 4>(__VA_ARGS__);

extern "C" void sweep_large_full(const float* src, const float* dst,
    const float* mask, int n, float threshold, const unsigned* seeds,
    int n_hyp, int fused, int k, float* table, int* order, float* msac,
    float* count) {
#define LARGE_ARGS src, dst, mask, n, threshold, seeds, n_hyp, table, order, msac, count
  if (k == 1) {
    if (fused) sweep_large_full_k<rt::Fused, 1>(LARGE_ARGS);
    else sweep_large_full_k<rt::Exact, 1>(LARGE_ARGS);
  } else if (fused) {
    DISPATCH(sweep_large_full_k, rt::Fused, k, LARGE_ARGS)
  } else {
    DISPATCH(sweep_large_full_k, rt::Exact, k, LARGE_ARGS)
  }
#undef LARGE_ARGS
}

extern "C" void sweep_full(const float* src, const float* dst,
    const float* mask, float threshold, const unsigned* seeds, int n_points,
    int n_score, int n_hyp, int fused, int k, float* f_out, int* i_out) {
  if (fused) {
    DISPATCH(sweep_full_k, rt::Fused, k, src, dst, mask, threshold, seeds,
             n_points, n_score, n_hyp, f_out, i_out)
  } else {
    DISPATCH(sweep_full_k, rt::Exact, k, src, dst, mask, threshold, seeds,
             n_points, n_score, n_hyp, f_out, i_out)
  }
}

extern "C" void sweep_essential_full(const float* x1, const float* x2,
    const float* mask, float threshold_sq, const unsigned* seeds, int n_points,
    int n_score, int n_hyp, int block_h, int fused, int k, float* f_out,
    int* i_out) {
  if (fused) {
    DISPATCH(sweep_essential_full_k, rt::Fused, k, x1, x2, mask, threshold_sq,
             seeds, n_points, n_score, n_hyp, block_h, f_out, i_out)
  } else {
    DISPATCH(sweep_essential_full_k, rt::Exact, k, x1, x2, mask, threshold_sq,
             seeds, n_points, n_score, n_hyp, block_h, f_out, i_out)
  }
}

// n mod d by rt::Divider for each of n numerators.
extern "C" void umod_many(unsigned d, const unsigned* num, int n, unsigned* out) {
  const rt::Divider v = rt::make_divider(d);
  for (int i = 0; i < n; ++i) out[i] = rt::umod(num[i], v);
}

// draw_sample_fast<K> of each flat id: idx [n, K].
extern "C" void draw_fast_many(int k, const unsigned* flat, int n,
    const unsigned* seeds, int n_points, int* idx) {
  rt::Divider divs[8];
  for (int j = 0; j < k; ++j) divs[j] = rt::make_divider(n_points - j);
  for (int i = 0; i < n; ++i) {
    if (k == 3) rt::draw_sample_fast<3>(flat[i], seeds, divs, idx + 3 * i);
    else if (k == 4) rt::draw_sample_fast<4>(flat[i], seeds, divs, idx + 4 * i);
    else rt::draw_sample_fast<8>(flat[i], seeds, divs, idx + 8 * i);
  }
}

// Row 5: full records (f [8, n_hyp] = 4 roots' msac, then counts; i
// [n_hyp] packed samples) in s * B + r order, drawn as the kernel draws
// (rt::draw_sample_fast); the score under policy Pol, the resolvent cubic's
// Newton steps under C.
template <class Pol, class C>
static void sweep_pnp_full_k(const float* X, const float* f, const float* pix,
    const float* mask, float thr_sq, float ay, int vmask, const unsigned* seeds,
    int n_points, int n_score, int n_hyp, int block_h, float* f_out, int* i_out) {
  alignas(16) float xyzw[64];
  float px[32], fc[3][16];
  for (int i = 0; i < 16; ++i) {
    for (int c = 0; c < 3; ++c) { xyzw[4 * i + c] = X[3 * i + c]; fc[c][i] = f[3 * i + c]; }
    xyzw[4 * i + 3] = mask[i];
    px[2 * i] = pix[2 * i];
    px[2 * i + 1] = pix[2 * i + 1];
  }
  const sweep_pnp::Table t{xyzw, px};
  rt::Divider divs[3];
  for (int j = 0; j < 3; ++j) divs[j] = rt::make_divider(n_points - j);
  const int B = n_hyp / 8, lan = block_h / 8;
  for (int g = 0; g < n_hyp; ++g) {
    const int r = g >> 3, s = g & 7;
    const unsigned flat = (unsigned)((r / lan) * 8 * lan + s * lan + r % lan);
    const long o = (long)s * B + r;
    int i[3];
    rt::draw_sample_fast<3>(flat, seeds, divs, i);
    const bool sample_valid = (((vmask >> i[0]) & (vmask >> i[1]) & (vmask >> i[2])) & 1) == 1;
    float P[3][3], F[3][3];
    for (int j = 0; j < 3; ++j)
      for (int c = 0; c < 3; ++c) {
        P[j][c] = xyzw[4 * i[j] + c];
        F[j][c] = fc[c][i[j]];
      }
    sweep_pnp::Pose pose[4];
    bool valid[4];
    sweep_pnp::solve_poses<C>(P, F, sample_valid, ay, pose, valid);
    for (int k = 0; k < 4; ++k) {
      float m = sweep_pnp::kBig, c = -1.0f;
      if (valid[k]) sweep_pnp::score_pose<Pol>(pose[k], t, n_score, thr_sq, &m, &c);
      f_out[(long)k * n_hyp + o] = m;
      f_out[(long)(4 + k) * n_hyp + o] = c;
    }
    i_out[o] = i[0] + i[1] * 16 + i[2] * 256;
  }
}

extern "C" void sweep_pnp_full(const float* X, const float* f,
    const float* pix, const float* mask, float thr_sq, float ay, int vmask,
    const unsigned* seeds, int n_points, int n_score, int n_hyp, int block_h,
    int fused, int cubic_fused, float* f_out, int* i_out) {
#define PNP_ARGS X, f, pix, mask, thr_sq, ay, vmask, seeds, n_points, n_score, \
                 n_hyp, block_h, f_out, i_out
  if (fused && cubic_fused) sweep_pnp_full_k<rt::Fused, rt::Fused>(PNP_ARGS);
  else if (fused) sweep_pnp_full_k<rt::Fused, rt::Exact>(PNP_ARGS);
  else if (cubic_fused) sweep_pnp_full_k<rt::Exact, rt::Fused>(PNP_ARGS);
  else sweep_pnp_full_k<rt::Exact, rt::Exact>(PNP_ARGS);
#undef PNP_ARGS
}

// The LM kernel's problems (lm.cuh), each by lm::run over lm::SerialLanes:
// homographies H0 [B, 9] over src, dst [B, n, 2] and w [B, n] -> H [B, 9];
// poses x0 = (rvec0, tvec0) [B, 6] over X [B, n, 3], pix [B, n, 2], K [B, 9]
// and w [B, n] -> x [B, 6]; and the cost, passes run and done of each.
template <class M>
static void lm_finish(const M& m, float* x, int max_iters, float* cost,
                      long long* iterations, unsigned char* converged) {
  const lm::State s = lm::run(m, x, max_iters, lm::SerialLanes{});
  *cost = s.cost;
  *iterations = s.iterations;
  *converged = s.done;
}

extern "C" void lm_homography_host(const float* H0, const float* src,
    const float* dst, const float* w, int B, int n, int max_iters, float* H,
    float* cost, long long* iterations, unsigned char* converged) {
  for (int b = 0; b < B; ++b) {
    const lm::HomographyOf<float> m{src + 2 * n * b, dst + 2 * n * b, w + n * b, n};
    float* x = H + 9 * b;
    lm::homography_start(H0 + 9 * b, x);
    lm_finish(m, x, max_iters, cost + b, iterations + b, converged + b);
    x[8] = 1.0f;
  }
}

extern "C" void lm_pose_host(const float* x0, const float* X, const float* pix,
    const float* K, const float* w, int B, int n, int max_iters, float* x,
    float* cost, long long* iterations, unsigned char* converged) {
  for (int b = 0; b < B; ++b) {
    const lm::Pose m{X + 3 * n * b, pix + 2 * n * b, K + 9 * b, w + n * b, n};
    for (int k = 0; k < 6; ++k) x[6 * b + k] = x0[6 * b + k];
    lm_finish(m, x + 6 * b, max_iters, cost + b, iterations + b, converged + b);
  }
}

// One problem's residuals r [2n] and their tangent Jacobian J [2n, p] at x.
template <class M>
static void lm_jacobian(const M& m, const float* x, float* r, float* J) {
  constexpr int P = M::kParams;
  lm::Dual<P> f[M::kFrame];
  lm::dual_frame(m, x, f);
  for (int i = 0; i < m.n; ++i) {
    float rows[2][P];
    lm::jacobian_rows(m, f, i, r + 2 * i, rows);
    for (int c = 0; c < 2; ++c)
      for (int k = 0; k < P; ++k) J[(2 * i + c) * P + k] = rows[c][k];
  }
}

extern "C" void lm_homography_jacobian(const float* x, const float* src,
    const float* dst, const float* w, int n, float* r, float* J) {
  lm_jacobian(lm::HomographyOf<float>{src, dst, w, n}, x, r, J);
}

extern "C" void lm_pose_jacobian(const float* x, const float* X, const float* pix,
    const float* K, const float* w, int n, float* r, float* J) {
  lm_jacobian(lm::Pose{X, pix, K, w, n}, x, r, J);
}
"""


REFIT_SHIM = r"""
#include <string.h>

#include "refit_seed.cuh"

// The fused refits (refit_seed.cuh), each problem by lm::SerialLanes:
// homographies H_best [B, 9] over src, dst [B, n, 2] and the inlier masks
// [B, n] -> H [B, 9]; one pose (model_best [12], X [n, 3], pixels and
// pix_n [n, 2], K [9], inliers and point mask [n]) -> [12], with what its
// seed choice saw (seed::PoseSeedTrace: the 4 candidates [48], their MSAC
// [4], the inliers counted [1], EPnP's M^T M [144], its eigenvalues [12]
// and two smallest eigenvectors [24]; the choice; the Jacobi rotations).
extern "C" void refit_homography_host(const float* H_best, const float* src,
    const float* dst, const bool* inl, int B, int n, int max_iters, float* H) {
  for (int b = 0; b < B; ++b) {
    const seed::HomographyProblem p{src + 2 * n * b, dst + 2 * n * b, inl + n * b, n};
    seed::refit_homography(p, H_best + 9 * b, max_iters, lm::SerialLanes{}, H + 9 * b);
  }
}

extern "C" void refit_pose_host(const float* model_best, const float* X, const float* pix,
    const float* pix_n, const float* K, const bool* inl, const float* mask, float thr_n,
    float ay, int n, int max_iters, float* out, float* trace, int* choice, int* rotations) {
  float A[144], V[144];
  seed::PoseSeedTrace t;
  const seed::PoseProblem p{X, pix, pix_n, K, inl, mask, thr_n, ay, n};
  seed::refit_pose(p, model_best, max_iters, A, V, lm::SerialLanes{}, out, &t);
  memcpy(trace, t.cands, sizeof t.cands);
  memcpy(trace + 48, t.scores, sizeof t.scores);
  trace[52] = t.n_inl;
  memcpy(trace + 53, t.mtm, sizeof t.mtm);
  memcpy(trace + 197, t.evals, sizeof t.evals);
  memcpy(trace + 209, t.kernel, sizeof t.kernel);
  *choice = t.choice;
  *rotations = t.rotations;
}
"""


def load(tmp_dir: Path, shim: str = SHIM):
    """Build ``shim`` (the sweeps' and the LM's, or ``REFIT_SHIM``) into
    ``tmp_dir`` and load it (None without g++)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    src = tmp_dir / "kernel_host_shim.cpp"
    lib = tmp_dir / "libkernel_host_shim.so"
    src.write_text(shim)
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(CSRC), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _p(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def sweep_full(lib, src, dst, mask, threshold: float, seeds, n_points,
               n_hyp, fused=True, k=4):
    """Full records (f [2, n_hyp] = rescaled msac, counts; i [n_hyp]) of
    the homography sweep on raw points, the kernel's prologue included:
    the `Fused` policy (the kernel's) or `Exact`, k (2 or 4) hypotheses a
    thread."""
    f = torch.empty((2, n_hyp), dtype=torch.float32)
    i = torch.empty((n_hyp,), dtype=torch.int32)
    s, sp = _seeds(seeds)
    lib.sweep_full(_p(src), _p(dst), _p(mask), ctypes.c_float(threshold), sp,
                   n_points, src.shape[0], n_hyp, int(fused), k, _p(f), _p(i))
    return f, i


def sweep_essential_full(lib, x1, x2, mask, threshold_sq: float, seeds,
                         n_points, n_hyp, block_h, fused=True, k=4):
    """Full records (f [2, n_hyp] = rescaled msac, counts; i [n_hyp]) of
    the <= 16-point essential sweep on raw points, its prep included:
    the `Fused` policy (the kernel's) or `Exact`, k (2 or 4) hypotheses a
    thread."""
    f = torch.empty((2, n_hyp), dtype=torch.float32)
    i = torch.empty((n_hyp,), dtype=torch.int32)
    s, sp = _seeds(seeds)
    lib.sweep_essential_full(_p(x1), _p(x2), _p(mask), ctypes.c_float(threshold_sq),
                             sp, n_points, x1.shape[0], n_hyp, block_h, int(fused),
                             k, _p(f), _p(i))
    return f, i


def umod(lib, d: int, numerators: np.ndarray) -> np.ndarray:
    """numerators mod d (uint32) by ``rt::Divider``."""
    num = np.ascontiguousarray(numerators, dtype=np.uint32)
    out = np.empty_like(num)
    lib.umod_many(ctypes.c_uint32(d), num.ctypes.data_as(ctypes.c_void_p), len(num),
                  out.ctypes.data_as(ctypes.c_void_p))
    return out


def draw_fast(lib, k: int, flat: np.ndarray, seeds, n_points: int) -> np.ndarray:
    """``rt::draw_sample_fast<k>`` of each flat id: [n, k] int32."""
    fl = np.ascontiguousarray(flat, dtype=np.uint32)
    idx = np.empty((len(fl), k), dtype=np.int32)
    s, sp = _seeds(seeds)
    lib.draw_fast_many(k, fl.ctypes.data_as(ctypes.c_void_p), len(fl), sp, n_points,
                       idx.ctypes.data_as(ctypes.c_void_p))
    return idx


def sweep_pnp_full(lib, X_p, f_p, pix_p, mask_p, thr_sq: float, ay: float,
                   vmask: int, seeds, n_points, n_score, n_hyp, block_h,
                   fused=False, cubic_fused=False):
    """Full records (f [8, n_hyp], i [n_hyp]) of the P3P sweep: the score
    under the `Exact` policy or the kernel's `Fused`; ``cubic_fused`` fuses
    the resolvent cubic's Newton steps too (an experiment; the kernels'
    solve is exact)."""
    f = torch.empty((8, n_hyp), dtype=torch.float32)
    i = torch.empty((n_hyp,), dtype=torch.int32)
    s = np.array(seeds, dtype=np.uint32)
    lib.sweep_pnp_full(_p(X_p), _p(f_p), _p(pix_p), _p(mask_p),
                       ctypes.c_float(thr_sq), ctypes.c_float(ay),
                       ctypes.c_int(vmask), s.ctypes.data_as(ctypes.c_void_p),
                       n_points, n_score, n_hyp, block_h, int(fused),
                       int(cubic_fused), _p(f), _p(i))
    return f, i


def _c(*tensors):
    return [t.to(torch.float32).contiguous() for t in tensors]


def _lm_outputs(B: int):
    return (torch.empty(B, dtype=torch.float32), torch.empty(B, dtype=torch.int64),
            torch.empty(B, dtype=torch.bool))


def lm_homography(lib, H0, src, dst, w, max_iters: int):
    """``csrc/lm.cuh``'s homography LM of each problem (H0 [B, 3, 3], src /
    dst [B, n, 2], w [B, n]): (H [B, 3, 3], LMResult-like (x [B, 8], cost,
    iterations, converged))."""
    H0, src, dst, w = _c(H0, src, dst, w)
    B, n = src.shape[:2]
    H = torch.empty((B, 3, 3), dtype=torch.float32)
    cost, it, conv = _lm_outputs(B)
    lib.lm_homography_host(_p(H0), _p(src), _p(dst), _p(w), B, n, max_iters, _p(H),
                           _p(cost), _p(it), _p(conv))
    return H, (H.reshape(B, 9)[:, :8], cost, it, conv)


def lm_pose(lib, rvec0, tvec0, X, pix, K, w, max_iters: int):
    """``csrc/lm.cuh``'s pose LM of each problem (rvec0 / tvec0 [B, 3], X
    [B, n, 3], pix [B, n, 2], K [B, 3, 3], w [B, n]): (x [B, 6], cost,
    iterations, converged)."""
    x0, X, pix, K, w = _c(torch.cat([rvec0, tvec0], -1), X, pix, K, w)
    B, n = X.shape[:2]
    x = torch.empty((B, 6), dtype=torch.float32)
    cost, it, conv = _lm_outputs(B)
    lib.lm_pose_host(_p(x0), _p(X), _p(pix), _p(K), _p(w), B, n, max_iters, _p(x),
                     _p(cost), _p(it), _p(conv))
    return x, cost, it, conv


def lm_jacobian(lib, model: str, x, *inputs):
    """One problem's residuals r [2n] and tangent Jacobian J [2n, p] at x
    (``lm::jacobian_rows``): model "homography" (x [8], src, dst [n, 2], w
    [n]) or "pose" (x [6], X [n, 3], pix [n, 2], K [3, 3], w [n])."""
    x, *inputs = _c(x, *inputs)
    n, p = inputs[-1].shape[0], x.shape[0]
    r = torch.empty(2 * n, dtype=torch.float32)
    J = torch.empty((2 * n, p), dtype=torch.float32)
    getattr(lib, f"lm_{model}_jacobian")(_p(x), *(_p(t) for t in inputs), n, _p(r), _p(J))
    return r, J


def refit_homography(lib, H_best, src, dst, inl, max_iters: int):
    """``csrc/refit_seed.cuh``'s homography refit of each problem (H_best
    [B, 3, 3], src / dst [B, n, 2], inl [B, n] bool): H [B, 3, 3]."""
    H_best, src, dst = _c(H_best, src, dst)
    inl = inl.to(torch.bool).contiguous()
    B, n = src.shape[:2]
    H = torch.empty((B, 3, 3), dtype=torch.float32)
    lib.refit_homography_host(_p(H_best), _p(src), _p(dst), _p(inl), B, n, max_iters, _p(H))
    return H


def refit_pose(lib, model_best, X, pix, pix_n, K, inl, mask, thr_n: float, ay: float,
               max_iters: int):
    """``csrc/refit_seed.cuh``'s PnP refit of one problem: (model [12], what
    its seed choice saw: a dict of cands [4, 12], scores [4], n_inl, mtm [12,
    12], evals [12], kernel [2, 12], choice and the Jacobi eigensolver's
    rotations)."""
    model_best, X, pix, pix_n, K, mask = _c(model_best, X, pix, pix_n, K, mask)
    inl = inl.to(torch.bool).contiguous()
    out = torch.empty(12, dtype=torch.float32)
    trace = torch.empty(233, dtype=torch.float32)
    choice, rotations = ctypes.c_int(-1), ctypes.c_int(-1)
    lib.refit_pose_host(_p(model_best), _p(X), _p(pix), _p(pix_n), _p(K), _p(inl), _p(mask),
                        ctypes.c_float(thr_n), ctypes.c_float(ay), X.shape[0], max_iters,
                        _p(out), _p(trace), ctypes.byref(choice), ctypes.byref(rotations))
    return out, {"cands": trace[:48].reshape(4, 12), "scores": trace[48:52],
                 "n_inl": float(trace[52]), "mtm": trace[53:197].reshape(12, 12),
                 "evals": trace[197:209], "kernel": trace[209:233].reshape(2, 12),
                 "choice": choice.value, "rotations": rotations.value}


def _seeds(seeds):
    s = np.array(seeds, dtype=np.uint32)
    return s, s.ctypes.data_as(ctypes.c_void_p)


def _n_rows(n):
    return -(-n // 16) * 16


def sweep_large_full(lib, src, dst, mask, threshold: float, seeds, n_hyp,
                     fused=False, k=1):
    """Row 6 on raw points: (table [n_rows, 5], order [n], msac [n_hyp],
    count [n_hyp]) by flat id, normalized units; the score under `Exact`
    or the kernel's `Fused`, k (1, 2 or 4) hypotheses a thread."""
    n = src.shape[0]
    table = torch.empty((_n_rows(n), 5), dtype=torch.float32)
    order = torch.empty((n,), dtype=torch.int32)
    msac = torch.empty((n_hyp,), dtype=torch.float32)
    count = torch.empty((n_hyp,), dtype=torch.float32)
    s, sp = _seeds(seeds)
    lib.sweep_large_full(_p(src), _p(dst), _p(mask), n, ctypes.c_float(threshold),
                         sp, n_hyp, int(fused), k, _p(table), _p(order), _p(msac),
                         _p(count))
    return table, order.long(), msac, count


def sweep_large_full_records(lib, src, dst, mask, threshold: float, seeds, n_hyp,
                             fused=True, k=4):
    """Row 6's full records as ``ops.sweep_large._sweep_plain(..., full=True)``
    gives them: (msac rescaled, counts, flat ids) [n_hyp] in s * B + r
    order."""
    from ransac_tpu_torch.ops import sweep as sw
    from ransac_tpu_torch.ops import sweep_large as sl

    _, _, msac, count = sweep_large_full(lib, src, dst, mask, threshold, seeds,
                                         n_hyp, fused, k)
    inv_s2 = sl._prepare(src, dst, mask, threshold, seeds)[2]
    flat = sw.record_flat_ids(0, n_hyp // 8, sl.LAN, "cpu").reshape(-1)
    return sl.rescale(msac[flat], inv_s2), count[flat], flat.to(torch.int32)


def pool_sort(lib, keys: np.ndarray) -> np.ndarray:
    """The prep kernels' order of uint32 keys (each row's slot the rank of
    its word key << 32 | row): the rows in pool order."""
    k = np.ascontiguousarray(keys, dtype=np.uint32)
    slot = np.empty(len(k), dtype=np.int32)
    order = np.empty(len(k), dtype=np.int32)
    lib.pool_sort(k.ctypes.data_as(ctypes.c_void_p), len(k),
                  slot.ctypes.data_as(ctypes.c_void_p),
                  order.ctypes.data_as(ctypes.c_void_p))
    assert (order[slot] == np.arange(len(k))).all()
    return order


def homography_scores(lib, models, src, dst, mask, thr_sq: float, fused=False):
    """Row 3's ``score::homography`` of every model [H, 9] over the raw
    points: (count [H], msac [H])."""
    m = models.reshape(-1, 9).contiguous()
    H = m.shape[0]
    count = torch.empty((H,), dtype=torch.float32)
    msac = torch.empty((H,), dtype=torch.float32)
    lib.homography_scores_host(_p(m), _p(src.contiguous()), _p(dst.contiguous()),
                               _p(mask.contiguous()), src.shape[0],
                               ctypes.c_float(thr_sq), H, int(fused), _p(count),
                               _p(msac))
    return count, msac


def pnp_scores(lib, models, Xw, pix_n, mask, thr_sq: float, fused=False):
    """Row 4's ``score::pose`` of every pose [H, 12] over the raw points:
    (count [H], msac [H])."""
    m = models.reshape(-1, 12).contiguous()
    H = m.shape[0]
    count = torch.empty((H,), dtype=torch.float32)
    msac = torch.empty((H,), dtype=torch.float32)
    lib.pnp_scores_host(_p(m), _p(Xw.contiguous()), _p(pix_n.contiguous()),
                        _p(mask.contiguous()), Xw.shape[0], ctypes.c_float(thr_sq), H,
                        int(fused), _p(count), _p(msac))
    return count, msac


def sweep_pnp_large_full(lib, X, pix, mask, thr_sq: float, ay: float, seeds,
                         n_hyp, block_h, fused=False):
    """Row 9: (table [n_rows, 9], order [n], msac [4, n_hyp], count [4,
    n_hyp]) by flat id; the score under `Exact` or the kernel's `Fused`."""
    n = X.shape[0]
    table = torch.empty((_n_rows(n), 9), dtype=torch.float32)
    order = torch.empty((n,), dtype=torch.int32)
    msac = torch.empty((4, n_hyp), dtype=torch.float32)
    count = torch.empty((4, n_hyp), dtype=torch.float32)
    s, sp = _seeds(seeds)
    lib.sweep_pnp_large_full(_p(X), _p(pix), _p(mask), n, ctypes.c_float(thr_sq),
                             ctypes.c_float(ay), sp, n_hyp, block_h, int(fused),
                             _p(table), _p(order), _p(msac), _p(count))
    return table, order.long(), msac, count


def sweep_essential_large_full(lib, x1, x2, mask, threshold_sq: float, seeds,
                               n_hyp, block_h, grouped=False, fused=False):
    """Row 8: (table [n_rows, 5], order [n], norm [6] = m1, m2, s, thr,
    msac [n_hyp], count [n_hyp]) by flat id, normalized units; the rows
    summed in the plain version's order, or with ``grouped`` as the
    kernel's 32 lanes a hypothesis, the score under `Exact` or the
    kernel's `Fused`."""
    n = x1.shape[0]
    table = torch.empty((_n_rows(n), 5), dtype=torch.float32)
    order = torch.empty((n,), dtype=torch.int32)
    norm = torch.empty((6,), dtype=torch.float32)
    msac = torch.empty((n_hyp,), dtype=torch.float32)
    count = torch.empty((n_hyp,), dtype=torch.float32)
    s, sp = _seeds(seeds)
    lib.sweep_essential_large_full(_p(x1), _p(x2), _p(mask), n,
                                   ctypes.c_float(threshold_sq), sp, n_hyp,
                                   block_h, int(grouped), int(fused), _p(table), _p(order),
                                   _p(norm), _p(msac), _p(count))
    return table, order.long(), norm, msac, count


def tree_sum_cols(lib, x: torch.Tensor) -> torch.Tensor:
    """``large::tree_sum_cols`` of a 1-d float32 tensor (the prep kernels'
    column-wise pairing of the pairwise tree sum)."""
    lib.tree_sum_cols.restype = ctypes.c_float
    x = x.contiguous()
    return torch.tensor(lib.tree_sum_cols(_p(x), x.shape[0]), dtype=torch.float32)


def sweep_multi_full(lib, src_p, dst_p, mask_p, thr_sq: float, idx, n,
                     fused=True, solve_fused=False):
    """Row 1's every-sample records (msac, count) [C, H], normalized units,
    of ``ops.sweep_multi._normalize``'s outputs and a sample table: the
    score under `Exact` or the kernel's `Fused`, the solve and the
    projection exact unless ``solve_fused``."""
    C, H = src_p.shape[0], idx.shape[1]
    msac = torch.empty((C, H), dtype=torch.float32)
    count = torch.empty((C, H), dtype=torch.float32)
    idx = idx.to(torch.int32).contiguous()
    lib.sweep_multi_full(_p(src_p.contiguous()), _p(dst_p.contiguous()),
                         _p(mask_p.contiguous()), ctypes.c_float(thr_sq), _p(idx),
                         C, H, n, int(fused), int(solve_fused), _p(msac), _p(count))
    return msac, count


def derive_fused_fractions(lib, out=print):
    """The Fused host build of rows 2, 3, 6 and 7 against the plain versions
    on ``chip_smoke.py``'s check cases (2^16 hypotheses; row 6 at 4 blocks)
    and timed shapes (row 2 at 2^22 on the bench problem, row 3 at 2^18
    models, row 6 on its 1024- and 256-point pools at 2^16 hypotheses, row 7
    at 2^20 on its n16 case), by the criteria of ``ops.sweep.hold_full`` /
    ``hold_reduced`` (rows 2 and 6), ``ops.score.hold`` (row 3) and
    ``ops.sweep_essential``'s (row 7); one JSON line per case."""
    import json

    import chip_smoke
    from ransac_tpu_torch import bench
    from ransac_tpu_torch.ops import sweep as sw
    from ransac_tpu_torch.ops import sweep_essential as se
    from ransac_tpu_torch.ops import sweep_essential_large as sel
    from ransac_tpu_torch.profile import ESSENTIAL_THRESHOLD

    sel._rsqrt = lambda x: 1.0 / sw.sqrt_rn(x)  # the host's rsqrt
    row2 = [(name, c, 11, chip_smoke.CHECK_HYP)
            for name, c in chip_smoke.sweep_cases("cpu").items()]
    row2.append(("timed_n13_H2^22", (*bench.problem("cpu"), 13), 5, chip_smoke.SWEEP_HYP))
    for name, (src, dst, mask, n_points), seed, n_hyp in row2:
        n_points = n_points or src.shape[0]
        seeds = sw.draw_seeds(seed, 4)
        args = (src, dst, mask, 75.0, seeds, n_points, n_hyp)
        f, i = sweep_full(lib, src, dst, mask, 75.0, seeds, n_points, n_hyp)
        full_k = (f[0], f[1], i)
        full_p = sw._sweep_plain(*args, True)
        held = sw.hold_full(full_k, full_p, lambda h: sw.cut_margins(*args, h))
        B = n_hyp // 8
        red = sw.reduce_records(*(t.reshape(8, B) for t in (f[0], f[1])),
                                i.reshape(8, B).long())
        red_k = (red[0][0::2], red[0][1::2], red[1])
        red_p = sw._sweep_plain(*args, False)
        flipped = held.pop("flipped")
        held_r = sw.hold_reduced(red_k, red_p, full_k, flipped)
        near_in, near_out, _ = sw.cut_margins(*args, flipped)
        out(json.dumps({"row": 2, "case": name, **held, "reduced": held_r,
                        "flip_count_change": (full_k[1] - full_p[1])[flipped].tolist(),
                        "flip_points_at_cut": [near_in.tolist(), near_out.tolist()]}))
    from ransac_tpu_torch.io.synthetic import planted_homography_pool
    from ransac_tpu_torch.ops import score as sc
    from ransac_tpu_torch.ops import sweep_large as sl

    row6 = [(name, (t["src"], t["dst"], t["mask"]), 3, 4 * sl.BLOCK_H)
            for name, t in chip_smoke.large_check_cases("cpu").items()]
    for n in (1024, 256):
        a, b, _ = planted_homography_pool(n, seed=7)
        row6.append((f"timed_n{n}_H2^16", (torch.from_numpy(a), torch.from_numpy(b),
                                            torch.ones(n)), 0, chip_smoke.CHECK_HYP))
    for name, (src, dst, mask), seed, n_hyp in row6:
        seeds = sw.draw_seeds(seed, sl.N_SEEDS)
        core = (src, dst, mask, 3.0, seeds, n_hyp)
        full_k = sweep_large_full_records(lib, src, dst, mask, 3.0, seeds, n_hyp)
        f_p, i_p = sl._sweep_plain(*core, True)[:2]
        held = sw.hold_full(full_k, (f_p[0], f_p[1], i_p),
                            lambda h: sl.cut_margins(*core, h))
        flipped = held.pop("flipped")
        B = n_hyp // 8
        red = sw.reduce_records(*(t.reshape(8, B) for t in (full_k[0], full_k[1])),
                                full_k[2].reshape(8, B).long())
        r_p = sl._sweep_plain(*core)
        held_r = sw.hold_reduced((red[0][0::2], red[0][1::2], red[1]),
                                 (r_p[0][0::2], r_p[0][1::2], r_p[1]), full_k, flipped)
        out(json.dumps({"row": 6, "case": name, **held, "reduced": held_r}))
    models, src, dst, mask = chip_smoke.score_models(chip_smoke.STAGEWISE_HYP, "cpu", seed=1)
    src16, dst16, mask16 = bench.problem("cpu", n_points=16)
    masked = mask.clone()
    masked[[1, 5, 9]] = 0.0
    for name, pts in (("n13_H2^18", (src, dst, mask)), ("n16_H2^18", (src16, dst16, mask16)),
                      ("n13_masked_H2^18", (src, dst, masked))):
        out_k = homography_scores(lib, models, *pts, sc._thr_sq(75.0), fused=True)
        held = sc.hold(out_k, sc.homography_scores_plain(models, *pts, 75.0),
                       lambda h, pts=pts: sc.cut_margins(models, *pts, 75.0, h))
        held.pop("flipped")
        out(json.dumps({"row": 3, "case": name, **held}))
    row7 = [(name, c, 6, chip_smoke.CHECK_HYP, block)
            for name, c in chip_smoke.essential_cases("cpu").items() for block in (512, 2048)]
    row7.append(("timed_n16_H2^20", chip_smoke.essential_cases("cpu")["n16"], 0,
                 chip_smoke.PROFILE_HYP, se.BLOCK_H))
    for name, (x1, x2, mask, n_points), seed, n_hyp, block in row7:
        n_points = n_points or x1.shape[0]
        seeds = sw.draw_seeds(seed, 8)
        args = (x1, x2, mask, ESSENTIAL_THRESHOLD, seeds, n_points, n_hyp, block)
        f, i = sweep_essential_full(lib, *args)
        f_p, i_p = se._sweep_plain(*args, True)
        held = se.hold_full((f[0], f[1], i), (f_p[0], f_p[1], i_p))
        B = n_hyp // 8
        pk = i.long() & 0xFFFFFFFF
        red = sw.reduce_records(*(t.reshape(8, B) for t in (f[0], f[1])),
                                pk.reshape(8, B), sentinel=se.UNSIGNED_SENTINEL)
        r_p = se._sweep_plain(*args, False)
        held_r = se.hold_reduced((red[0][0::2], red[0][1::2], red[1]),
                                 (r_p[0][0::2], r_p[0][1::2], r_p[1]))
        out(json.dumps({"row": 7, "case": f"{name}_block{block}", **held,
                        "reduced": held_r}))


def derive_rows_1_and_8(lib, out=print):
    """The Fused host build of rows 1 and 8 against the plain versions, one
    JSON line a case: row 1 on ``chip_smoke.py``'s four check cases (the
    planted 458-candidate scenes) by ``ops.sweep_multi.hold``, with the
    kernel's arithmetic (exact solve and projection) and, as the witness of
    why it keeps them exact, with the solve and the projection fused too;
    row 8 on chip_smoke.py's check cases (block 512) at 32 lanes a
    hypothesis by ``ops.sweep.hold_full`` with ``sweep_essential_large.
    cut_margins``."""
    import json
    import tempfile

    import chip_smoke
    from ransac_tpu_torch.ops import sweep as sw
    from ransac_tpu_torch.ops import sweep_essential_large as sel
    from ransac_tpu_torch.ops import sweep_large as sl
    from ransac_tpu_torch.ops import sweep_multi as sm

    with tempfile.TemporaryDirectory() as tmp:
        cases = chip_smoke.sweep_multi_cases(tmp, "cpu")
    for name, (pos2, dst, mask, idx) in cases.items():
        core = sm._normalize(pos2, dst, mask, 75.0)[:4] + (idx, dst.shape[0])
        out_p = sm._sweep_plain(*core, full=True)
        red_p = sm._sweep_plain(*core)
        for solve_fused in (False, True):
            m, c = sweep_multi_full(lib, *core[:3], float(core[3][0]), idx, core[5],
                                    solve_fused=solve_fused)
            out_k = (m, c, out_p[2])
            held, held_r = sm.hold(out_k, out_p, sm.reduce_candidates(*out_k), red_p,
                                   lambda h: sm.cut_margins(*core, h))
            out(json.dumps({"row": 1, "case": name, "solve_and_projection_fused": solve_fused,
                            **held, "reduced": held_r}))
    sel._rsqrt = lambda x: 1.0 / sw.sqrt_rn(x)  # the host's rsqrt
    for name, t in chip_smoke.large_check_cases("cpu").items():
        seeds = sw.draw_seeds(4, sel.N_SEEDS)
        n = t["x1"].shape[0]
        args = (t["x1"], t["x2"], t["mask"], (2.0 / 600.0) ** 2, seeds,
                sl.n_hyp_for(8192, n, 512), 512)
        f_p, i_p, *_, (_, _, s) = sel._sweep_plain(*args, full=True)
        _, _, _, msac, count = sweep_essential_large_full(lib, *args[:5], args[5], 512,
                                                          grouped=True, fused=True)
        flat = i_p.long()
        full_k = (sl.rescale(msac[flat], 1.0 / (s * s)), count[flat], i_p)
        held = sw.hold_full(full_k, (f_p[0], f_p[1], i_p), lambda h: sel.cut_margins(*args, h))
        held.pop("flipped")
        out(json.dumps({"row": 8, "case": name, **held}))


def float64_witness(out=print):
    """The two min-MSAC hypotheses of row 7's n13_n_points_10 check case
    (seed 6, 2^16 hypotheses, block 2048) on an H100 when the kernel's
    canonical solve was fused too (the plain winner 22663 counted 10 by the
    plain version and 6 by the kernel, the kernel's winner 29006 10 and 7),
    evaluated by the plain arithmetic in float32 and in float64: their
    samples, counts and how far F moves; one JSON line each."""
    import json

    import chip_smoke
    from ransac_tpu_torch.ops import sweep as sw
    from ransac_tpu_torch.ops import sweep_essential as se
    from ransac_tpu_torch.ops import sweep_essential_large as sel
    from ransac_tpu_torch.profile import ESSENTIAL_THRESHOLD

    x1, x2, mask, n_points = chip_smoke.essential_cases("cpu")["n13_n_points_10"]
    x1_p, x2_p, mask_p, thr, _ = se._normalize(x1, x2, mask, ESSENTIAL_THRESHOLD, n_points)
    seeds, B, lan = sw.draw_seeds(6, 8), (1 << 16) // 8, 2048 // 8

    def evaluate(h, dtype):
        r, s = torch.tensor([h % B]), h // B
        idx = sw.draw_sample((r // lan) * 2048 + s * lan + r % lan, seeds, n_points)
        a, b, w, t = (v.to(dtype) for v in (x1_p, x2_p, mask_p, thr))
        F, _ = sel.canonical_f([a[i, 0] for i in idx], [a[i, 1] for i in idx],
                               [b[i, 0] for i in idx], [b[i, 1] for i in idx])
        cnt = ms = torch.zeros(1, dtype=dtype)
        for n in range(x1.shape[0]):
            cnt, ms = sel.sampson(F, a[n, 0], a[n, 1], b[n, 0], b[n, 1], w[n], t[0], cnt, ms)
        return [int(i) for i in idx], float(cnt), torch.cat(F).double()

    for h in (22663, 29006):
        sample, c32, F32 = evaluate(h, torch.float32)
        _, c64, F64 = evaluate(h, torch.float64)
        out(json.dumps({"hyp": h, "sample": sample, "count_float32": c32,
                        "count_float64": c64,
                        "F_max_abs_diff": float((F32 - F64).abs().max())}))


def float64_witness_p3p(lib, n_hyp=1 << 16, out=print):
    """The P3P solve with the resolvent cubic's 12 Newton steps fused (FMA;
    the host's exact reciprocal stands in for MUFU's) against the plain
    version's exact solve, on a planted 13-point pool and on ``cli
    profile``'s kind of uniform 13-point inputs: the (sample, root) pairs
    whose validity or count moves, which of the two float32 sides a float64
    evaluation of the plain arithmetic agrees with on those pairs, and
    whether the min-MSAC sample or the winners' counts move; one JSON line a
    case.  (The kernels' solve stays exact: ``sweep_pnp.cuh``.)"""
    import json

    from ransac_tpu_torch.io.synthetic import planted_pnp_pool
    from ransac_tpu_torch.ops import sweep as sw
    from ransac_tpu_torch.ops import sweep_pnp as sp
    from ransac_tpu_torch.ops.projection import normalize_pixels

    rng = np.random.default_rng(0)
    X, pix, K, _, _, _ = planted_pnp_pool(13, seed=13)
    cases = {"planted_n13": (torch.from_numpy(X), normalize_pixels(
                 torch.from_numpy(pix), torch.from_numpy(K)), 10.0 / 900.0),
             "uniform_n13": (torch.from_numpy(rng.uniform(-2, 2, (13, 3)).astype(np.float32)),
                             torch.from_numpy(rng.uniform(-0.5, 0.5, (13, 2)).astype(np.float32)),
                             30.0 / 900.0)}
    sqrt, rsqrt, cbrt = sp._sqrt, sp._rsqrt, sp._cbrt_upper
    for name, (Xw, pix_n, thr_n) in cases.items():
        sp._rsqrt = lambda x: 1.0 / sqrt(x)  # the host build's rsqrt
        prep = sp.prepare(Xw, pix_n, torch.ones(13), thr_n, 1.0)
        seeds = sw.draw_seeds(0, 3)
        vmask = int(sw.sample_bitmask(prep[3])[0])
        f_p, i_p = sp._sweep_plain(*prep, seeds, 13, 13, n_hyp, 4096, True)
        f_c, _ = sweep_pnp_full(lib, *prep, vmask, seeds, 13, 13, n_hyp, 4096,
                                fused=False, cubic_fused=True)
        moved = ((f_c[:4] >= 3e38) != (f_p[:4] >= 3e38)) | (f_c[4:] != f_p[4:])
        k, o = torch.nonzero(moved, as_tuple=True)
        # The moved pairs in float64: the plain solve and score.
        sp._sqrt, sp._rsqrt = torch.sqrt, torch.rsqrt
        sp._cbrt_upper = lambda x: cbrt(x.float()).double()
        B, lan = n_hyp // 8, 4096 // 8
        s_, r_ = o // B, o % B
        idx = sw.draw_sample((r_ // lan) * 4096 + s_ * lan + r_ % lan, seeds, 13)
        Xd, fd, pd = (t.double() for t in prep[:3])
        poses, valid = sp.solve_poses([[Xd[i, c] for c in range(3)] for i in idx],
                                      [[fd[i, c] for c in range(3)] for i in idx],
                                      torch.ones_like(o, dtype=torch.bool),
                                      torch.tensor(1.0, dtype=torch.float64))
        pose = sp.root_of(poses, k)
        count64 = sp.score_pose(pose, 13, torch.tensor(prep[4], dtype=torch.float64),
                                Xd, pd, prep[3].double())[1]
        count64 = torch.where(torch.stack(valid).gather(0, k[None])[0], count64, -1.0)
        sp._sqrt, sp._rsqrt, sp._cbrt_upper = sqrt, rsqrt, cbrt
        c_p, c_c = f_p[4:][k, o].double(), f_c[4:][k, o].double()
        w_p, w_c = int(f_p[:4].reshape(-1).argmin()), int(f_c[:4].reshape(-1).argmin())
        out(json.dumps({
            "case": name, "pairs": 4 * n_hyp, "valid_pairs": int((f_p[4:] >= 0).sum()),
            "validity_moved": int(((f_c[:4] >= 3e38) != (f_p[:4] >= 3e38)).sum()),
            "count_moved": int((f_c[4:] != f_p[4:]).sum()),
            "float64_agrees_with_exact": int((count64 == c_p).sum()),
            "float64_agrees_with_fused_cubic": int((count64 == c_c).sum()),
            "min_msac_sample": [sorted((int(i_p[w_p % n_hyp]) >> (4 * j)) & 15 for j in range(3)),
                                sorted((int(i_p[w_c % n_hyp]) >> (4 * j)) & 15
                                       for j in range(3))],
            "winner_counts": [float(f_p[4:].reshape(-1)[w_p]), float(f_c[4:].reshape(-1)[w_c])],
            "max_count": [float(f_p[4:].max()), float(f_c[4:].max())]}))


if __name__ == "__main__":
    import sys
    import tempfile

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    with tempfile.TemporaryDirectory() as tmp:
        lib = load(Path(tmp))
        derive_fused_fractions(lib)
        derive_rows_1_and_8(lib)
        float64_witness_p3p(lib)
    float64_witness()
