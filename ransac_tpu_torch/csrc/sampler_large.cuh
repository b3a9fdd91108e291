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
//   The prep kernels rank the words key << 32 | row (pool_slot: a row's slot
//   is the count of smaller words, spread over a warp and over the blocks of
//   the prep grid, a warp a row): the words are distinct, so the ranks are
//   the positions in the keys' stable order.
//
// The pool preparation sums with a fixed pairwise tree (the plain PyTorch
// version's tree_sum): the values zero-padded to p = tree_width(n), then
// x[i] += x[i + h] for h = p/2, ..., 1.  The prep kernels take that tree by
// columns (tree_sums): value r sits in column r % 32 at depth r / 32, so the
// levels h >= 32 pair values of one column, which warp c reduces in
// registers; the 32 column sums then take the levels 16, ..., 1.  The same
// operands meet in the same order, and any number of sums pass one barrier
// together.  Without __CUDACC__ everything here but the block-level helpers
// builds as host C++, as fp32_rn.cuh does (tree_sum_cols is the column form
// one addition after another).

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

// The word of row i: its shuffle key above its row, so that words are
// distinct and ascending words are the keys' stable order.  Padding words
// are all ones, above every row's.
constexpr unsigned long long kPadWord = ~0ull;

RT_FN unsigned long long pool_word(int i, unsigned key) {
  return static_cast<unsigned long long>(key) << 32 | static_cast<unsigned>(i);
}

// The words of words[first], words[first + step], ... (< n) below `mine`.
// Summed over first = 0 .. step - 1, the rank of `mine` among words[0..n):
// its position in the ascending order, as the words are distinct.
RT_FN int count_below(unsigned long long mine, const unsigned long long* words,
                      int n, int first, int step) {
  int c = 0;
  for (int j = first; j < n; j += step) c += words[j] < mine ? 1 : 0;
  return c;
}

// The shared memory index of row r in the preps' row-major staging arrays:
// one pad float every 32 rows, so that the transposed reads of tree_sums
// (rows 32 k + c by lane k) meet no bank conflict.
RT_HD constexpr int padded(int r) { return r + (r >> 5); }

#ifndef __CUDACC__
// The sum of x[0..n) in tree_sums' pairing, one addition after another:
// column c (values 32 k + c) by the levels q/2, ..., 1 over k (q = p / 32),
// then the 32 column sums by 16, ..., 1; below 32 values, the one column.
inline float tree_sum_cols(const float* x, int n) {
  const int p = tree_width(n);
  const int width = p < 32 ? p : 32;
  float col[32];
  for (int c = 0; c < width; ++c) {
    float e[32];
    const int q = p < 32 ? 1 : p / 32;
    for (int k = 0; k < q; ++k) e[k] = 32 * k + c < n ? x[32 * k + c] : 0.0f;
    for (int off = q / 2; off >= 1; off >>= 1)
      for (int k = 0; k < off; ++k) e[k] = rt::add(e[k], e[k + off]);
    col[c] = e[0];
  }
  for (int off = width / 2; off >= 1; off >>= 1)
    for (int c = 0; c < off; ++c) col[c] = rt::add(col[c], col[c + off]);
  return col[0];
}
#endif

#ifdef __CUDACC__
// Pool slot of row r (< n: its rank among words[0..n), shared memory, by
// the whole warp, lane l counting words l, l + 32, ...; past n: r itself).
// Every lane of the warp must call it and gets the slot.
__device__ __forceinline__ int pool_slot(const unsigned long long* words, int r,
                                         int n) {
  const int below = count_below(r < n ? words[r] : 0ull, words, n,
                                threadIdx.x & 31, 32);
  const int slot = static_cast<int>(__reduce_add_sync(0xffffffffu,
                                                      static_cast<unsigned>(below)));
  return r < n ? slot : r;
}

// The row whose values thread threadIdx.x brings to tree_sums over p rows,
// or -1: with p >= 32, lane k of warp c brings row 32 k + c (k < p / 32);
// below 32 rows, lane k of every warp brings row k.
__device__ __forceinline__ int sum_row(int p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (p >= 32) return lane < (p >> 5) ? 32 * lane + warp : -1;
  return lane < p ? lane : -1;
}

// V pairwise tree sums over p rows (p a power of two <= 1024) by a block of
// 1024 threads: v holds this thread's values of row sum_row(p) (zeros where
// it brings none).  Warp c adds column c by shuffles down (lane k adds
// lane k + h / 32 for h = p/2, ..., 32), its lane 0 puts the column sums in
// cols (V x 32 floats, not used by another tree_sums call before the next
// barrier), and after one barrier every warp adds the 32 columns (lane c
// adds lane c + h, h = 16, ..., 1): out holds the V sums in every thread.
// Every thread must call it.
template <int V>
__device__ __forceinline__ void tree_sums(float (&v)[V], int p, float* cols,
                                          float (&out)[V]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (p >= 32) {
    for (int h = p >> 6; h >= 1; h >>= 1) {
#pragma unroll
      for (int c = 0; c < V; ++c)
        v[c] = rt::add(v[c], __shfl_down_sync(0xffffffffu, v[c], h));
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < V; ++c) cols[32 * c + warp] = v[c];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < V; ++c) v[c] = cols[32 * c + lane];
  }
  for (int h = (p < 32 ? p : 32) >> 1; h >= 1; h >>= 1) {
#pragma unroll
    for (int c = 0; c < V; ++c)
      v[c] = rt::add(v[c], __shfl_down_sync(0xffffffffu, v[c], h));
  }
#pragma unroll
  for (int c = 0; c < V; ++c) out[c] = __shfl_sync(0xffffffffu, v[c], 0);
}

// The JAX wrappers' masked normalization of two point sets a, b [n, 2]
// with weights m (sweep_large.py:396-407, sweep_essential_large.py:
// 384-392), staged in shared memory as raw[c * stride + padded(r)] for c =
// (m, ax, ay, bx, by): out = (cnt, a's centroid x, y, b's centroid x, y,
// a's and b's sums of masked distances to them, n_valid), cnt = max(sum of
// m, 1), a centroid the masked sum over cnt, n_valid the rows of m > 0 (a
// sum of ones, exact).  Two tree_sums passes: the sums of m, m * ax, m *
// ay, m * bx, m * by and the valid rows, then the two distance sums.  A
// block of 1024 threads after a barrier on raw; cols 8 x 32 floats; every
// thread must call it.
__device__ __forceinline__ void pool_norm(const float* raw, int stride, int n,
                                          float* cols, float out[8]) {
  using namespace rt;
  const int p = tree_width(n);
  const int r = sum_row(p);
  const bool in = r >= 0 && r < n;
  float x[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) x[c] = in ? raw[c * stride + padded(r)] : 0.0f;
  const float m = x[0];
  float v[6] = {m, in ? mul(x[1], m) : 0.0f, in ? mul(x[2], m) : 0.0f,
                in ? mul(x[3], m) : 0.0f, in ? mul(x[4], m) : 0.0f,
                in && m > 0.0f ? 1.0f : 0.0f};
  float s[6];
  tree_sums<6>(v, p, cols, s);
  out[7] = s[5];
  out[0] = max_nan(s[0], 1.0f);
#pragma unroll
  for (int c = 0; c < 4; ++c) out[1 + c] = div(s[1 + c], out[0]);
  float d[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float qx = sub(x[1 + 2 * e], out[1 + 2 * e]);
    const float qy = sub(x[2 + 2 * e], out[2 + 2 * e]);
    d[e] = in ? mul(sqrt_rn(add(mul(qx, qx), mul(qy, qy))), m) : 0.0f;
  }
  float ds[2];
  tree_sums<2>(d, p, cols + 6 * 32, ds);
  out[5] = ds[0];
  out[6] = ds[1];
}
#endif

}  // namespace large
