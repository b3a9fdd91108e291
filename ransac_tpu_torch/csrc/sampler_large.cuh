// The windowed counter sampler of the large-pool sweeps (sweep_large.cu,
// sweep_pnp_large.cu, sweep_essential_large.cu), and the pool preparation
// their one-block prep kernels share.
//
// The sampler of ransac_tpu/ops/pallas/sweep_large.py:67-185, bit for bit:
//
// - range_reduce: floor(u24 * (n * 2^-24)) with u24 the top 24 bits of a
//   murmur3 hash, the product rounded once to float32 and truncated toward
//   zero, then clamped to n - 1.  (n * 2^-24 is exact, so the one rounding
//   is the product's.)  It is not `bits % n`.
// - fy_draws<K>: the K-subset Fisher-Yates of the TPU kernels, each draw
//   range-reduced over (n - j) and shifted past the earlier picks in
//   ascending order.
// - window_base: block b of a sweep samples inside the circular window
//   [wb, wb + min(64, n_valid)) of the pool, wb = range_reduce(fmix(b ^
//   seed), n_valid) when n_valid > 64, else 0.
// - shuffle_key: the pool is the valid rows first, in the order of the keys
//   fmix(i ^ seed) & 0x7FFFFFFF (a stable sort, so equal keys keep their
//   row order), then the invalid rows in row order (keys 0x80000000 + i).
//   The prep kernels sort the words key << 32 | row with a bitonic network
//   (pool_slot_sorted): the words are distinct, so their ascending order is
//   the keys' stable order.
//
// The pool preparation sums with a fixed pairwise tree (tree_sum_block), so
// the plain PyTorch version takes the same sums in the same order.  Without
// __CUDACC__ everything here but the block-level helpers builds as host
// C++, as fp32_rn.cuh does.

#pragma once

#include "fp32_rn.cuh"

namespace large {

constexpr int kWindow = 64;
constexpr int kUnroll = 16;       // the table is padded to a multiple of this
constexpr int kNAcc = 4;          // accumulator pairs of the score loops
constexpr float kBig = 3.4e38f;

RT_FN int range_reduce(unsigned bits, int n_range) {
  const float u24 = static_cast<float>(static_cast<int>((bits >> 8) & 0xFFFFFFu));
  const float scale = rt::mul(static_cast<float>(n_range), 5.9604644775390625e-8f);
#ifdef __CUDACC__
  const int r = __float2int_rz(rt::mul(u24, scale));
#else
  const int r = static_cast<int>(rt::mul(u24, scale));
#endif
  return r < n_range - 1 ? r : n_range - 1;
}

// K-subset Fisher-Yates over [0, n) from seeds[0..K-1] (sweep_large.py:145-165).
template <int K>
RT_FN void fy_draws(unsigned flat, const unsigned* seeds, int n, int* idx) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    int r = range_reduce(rt::fmix(flat ^ seeds[j]), n - j);
    int sorted[K];
#pragma unroll
    for (int p = 0; p < j; ++p) {
      int ins = idx[p];
#pragma unroll
      for (int q = 0; q < p; ++q) {
        const int lo = sorted[q] < ins ? sorted[q] : ins;
        const int hi = sorted[q] < ins ? ins : sorted[q];
        sorted[q] = lo;
        ins = hi;
      }
      sorted[p] = ins;
    }
#pragma unroll
    for (int q = 0; q < j; ++q) r += (r >= sorted[q]) ? 1 : 0;
    idx[j] = r;
  }
}

RT_FN int window_base(unsigned block, unsigned seed, int n_valid) {
  return range_reduce(rt::fmix(block ^ seed), n_valid > kWindow ? n_valid : 1);
}

// Pool slots of hypothesis `flat`: K draws in its block's circular window.
// With fewer than K valid points the draws are meaningless (the JAX kernel
// reads out of its table there): slots are clamped to >= 0 so every read
// stays in the table, and the caller marks the hypothesis invalid.
template <int K>
RT_FN void sample_slots(unsigned flat, const unsigned* draw_seeds,
                        unsigned window_seed, int n_valid, int block_h,
                        int* slot) {
  const int wbase = window_base(flat / static_cast<unsigned>(block_h),
                                window_seed, n_valid);
  fy_draws<K>(flat, draw_seeds, n_valid < kWindow ? n_valid : kWindow, slot);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int s = wbase + slot[j];
    const int w = s >= n_valid ? s - n_valid : s;
    slot[j] = w < 0 ? 0 : w;
  }
}

RT_FN unsigned shuffle_key(int i, unsigned seed, bool valid) {
  const unsigned u = static_cast<unsigned>(i);
  return valid ? (rt::fmix(u ^ seed) & 0x7FFFFFFFu) : 0x80000000u + u;
}

// Rows of the padded table: n rounded up to a multiple of kUnroll.
RT_FN int table_rows(int n) { return (n + kUnroll - 1) / kUnroll * kUnroll; }

// The smallest power of two >= n (>= 1): the width of tree_sum.
RT_FN int tree_width(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The sort word of row i: its shuffle key above its row, so that words are
// distinct and ascending words are the keys' stable order.  Padding words
// are all ones, above every row's.
constexpr unsigned long long kPadWord = ~0ull;

RT_FN unsigned long long pool_word(int i, unsigned key) {
  return static_cast<unsigned long long>(key) << 32 | static_cast<unsigned>(i);
}

// Position t of pass (k, j) of the bitonic sorting network over p words
// (p a power of two; passes k = 2, 4, ..., p and, within each, j = k / 2,
// ..., 1): the word it keeps of its own, `mine`, and its partner's at t ^ j,
// `other`.  The pair sorts ascending where bit k of t is clear; the lower
// position keeps the smaller word then, the upper the larger.
RT_FN unsigned long long bitonic_keep(unsigned long long mine,
                                      unsigned long long other, int t, int k,
                                      int j) {
  const bool smaller = ((t & j) == 0) == ((t & k) == 0);
  return (mine < other) == smaller ? mine : other;
}

#ifndef __CUDACC__
// The network one pair after another: sorts w[0..p) ascending.
inline void bitonic_sort(unsigned long long* w, int p) {
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = 0; t < p; ++t) {
        if (t & j) continue;
        const unsigned long long a = w[t], b = w[t ^ j];
        w[t] = bitonic_keep(a, b, t, k, j);
        w[t ^ j] = bitonic_keep(b, a, t ^ j, k, j);
      }
    }
  }
}
#endif

#ifdef __CUDACC__
// In-place pairwise sum of a shared buf[0..p) (p a power of two) by a whole
// block (blockDim.x >= max(p/2, 32)): buf[i] += buf[i + h] for h = p/2,
// p/4, ..., 1; the levels below 32 run in the first warp's registers (lane
// i adds lane i + h, the same operands in the same order).  Every thread
// must call it; it returns the sum to every thread.
__device__ __forceinline__ float tree_sum_block(float* buf, int p) {
  const int i = threadIdx.x;
  __syncthreads();
  int h = p >> 1;
  for (; h >= 32; h >>= 1) {
    if (i < h) buf[i] = rt::add(buf[i], buf[i + h]);
    __syncthreads();
  }
  if (i < 32) {
    float v = buf[i];
    for (; h >= 1; h >>= 1) v = rt::add(v, __shfl_down_sync(0xffffffffu, v, h));
    if (i == 0) buf[0] = v;
  }
  __syncthreads();
  const float s = buf[0];
  __syncthreads();
  return s;
}

// Pool slot of row threadIdx.x (a row's rank in the keys' stable order;
// rows past n keep their index), `key` its shuffle key.  Thread t holds
// word t of the block's n rows (pool_word), padded with kPadWord, through
// the bitonic network over tree_width(n) words: a pass with j < 32 trades
// words by warp shuffles, one with j >= 32 through shared memory (words,
// blockDim.x entries).  Then the sorted words give each row its position
// (slots, n entries).  blockDim.x, a power of two >= tree_width(n) and >=
// 32; every thread must call it.
__device__ __forceinline__ int pool_slot_sorted(unsigned key, int n,
                                                unsigned long long* words,
                                                int* slots) {
  const int i = threadIdx.x;
  const int p = tree_width(n);
  unsigned long long w = i < n ? pool_word(i, key) : kPadWord;
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned long long other;
      if (j >= 32) {
        words[i] = w;
        __syncthreads();
        other = words[i ^ j];
        __syncthreads();
      } else {
        other = __shfl_xor_sync(0xffffffffu, w, j);
      }
      w = bitonic_keep(w, other, i, k, j);
    }
  }
  if (i < n) slots[static_cast<unsigned>(w)] = i;
  __syncthreads();
  return i < n ? slots[i] : i;
}

// Masked centroid (mx, my) of the block's points a [n, 2] (thread i holds
// row i; `in` marks i < n, m its weight) with divisor cnt, and the tree sum
// of the masked distances to it: out = (mx, my, sum).  The JAX wrappers'
// normalization (sweep_large.py:396-401, sweep_essential_large.py:384-392).
__device__ __forceinline__ void centroid_dist(const float* a, float m, bool in,
                                              int p, float cnt, float* buf,
                                              float out[3]) {
  using namespace rt;
  const int i = threadIdx.x;
  const float ax = in ? a[2 * i] : 0.0f, ay = in ? a[2 * i + 1] : 0.0f;
  buf[i] = in ? mul(ax, m) : 0.0f;
  out[0] = div(tree_sum_block(buf, p), cnt);
  buf[i] = in ? mul(ay, m) : 0.0f;
  out[1] = div(tree_sum_block(buf, p), cnt);
  const float qx = sub(ax, out[0]), qy = sub(ay, out[1]);
  buf[i] = in ? mul(sqrt_rn(add(mul(qx, qx), mul(qy, qy))), m) : 0.0f;
  out[2] = tree_sum_block(buf, p);
}
#endif

}  // namespace large
