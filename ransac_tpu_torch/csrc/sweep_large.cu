// Large-pool homography-RANSAC sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `homography_ransac_sweep_large`
// (ransac_tpu/ops/pallas/sweep_large.py, kernel body `_make_kernel`) for
// pools of up to 1024 correspondences.  A call is two launches from one C
// call:
//
// - sweep_large_prep_kernel, one block of 1024 threads, does what the JAX
//   wrapper does in XLA: counts the valid points, normalizes src and dst by
//   their masked centroids and mean distances (pairwise tree sums, see
//   sampler_large.cuh), scales the threshold, and writes the table in the
//   shuffled valid-first pool order (each row's slot is its stable rank
//   among the shuffle keys) padded with zero rows to a multiple of 16, the
//   pool order itself and n_valid.
// - sweep_large_kernel: each thread is one hypothesis (sweep_large.cuh):
//   windowed counter sample, projective-frame homography, score of every
//   table row from shared memory (the table is at most 20 KB).  The TPU
//   kernel's records are kept: record r = b * 256 + l covers the flat ids
//   b * 2048 + s * 256 + l, s = 0..7, and holds the min-MSAC and (max count,
//   min MSAC) winners with their flat ids (records.cuh); MSAC is scaled back
//   to pixel^2 units as it is written.
//
// What bounds it on this card: FP32 CUDA-core arithmetic, about 25
// operations per table row and hypothesis with one IEEE division, so
// ~25 N per hypothesis; the table is read from shared memory as a
// broadcast (every thread of a warp reads the same row).  Making it fast
// (FMA, approximate reciprocal, several hypotheses per thread) is later work.
//
// Rounding: every operation is rounded on its own, in the order of the plain
// PyTorch version (`ransac_tpu_torch.ops.sweep_large`), so the two agree bit
// for bit on the same inputs.

#include <cuda_runtime.h>

#include "records.cuh"
#include "sampler_large.cuh"
#include "sweep_large.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPrepThreads = 1024;
constexpr int kM = sweep_large::kMaxPoints;
// The prep buffer: five columns of kM floats (x, y of src, x, y of dst,
// weight) in pool order, then thr^2 and 1 / s_dst^2.
constexpr int kThrSq = 5 * kM, kInvS2 = kThrSq + 1;
constexpr int kPrepFloats = kInvS2 + 1;

__global__ void __launch_bounds__(kPrepThreads)
sweep_large_prep_kernel(const float* __restrict__ src,   // [n, 2] raw
                        const float* __restrict__ dst,   // [n, 2] raw
                        const float* __restrict__ mask,  // [n]
                        float threshold, unsigned shuffle_seed, int n,
                        float* __restrict__ prep,        // [kPrepFloats]
                        int* __restrict__ aux) {         // [n + 1]
  using namespace rt;
  __shared__ float buf[kM];
  __shared__ unsigned keys[kM];
  const int i = threadIdx.x;
  const bool in = i < n;
  const float m = in ? mask[i] : 0.0f;
  const bool valid = in && m > 0.0f;
  if (in) keys[i] = large::shuffle_key(i, shuffle_seed, valid);
  const int n_valid = __syncthreads_count(valid);
  const int p = large::tree_width(n);
  buf[i] = m;
  const float cnt = max_nan(large::tree_sum_block(buf, p), 1.0f);
  // Centroid and scale sqrt(2) / mean distance of src, then of dst
  // (sweep_large.py:396-407).
  float ps[3], pd[3];
  large::centroid_dist(src, m, in, p, cnt, buf, ps);
  large::centroid_dist(dst, m, in, p, cnt, buf, pd);
  ps[2] = div(1.4142135623730951f, max_nan(div(ps[2], cnt), 1e-12f));
  pd[2] = div(1.4142135623730951f, max_nan(div(pd[2], cnt), 1e-12f));

  const int n_rows = large::table_rows(n);
  if (i < n_rows) {
    const int slot = in ? large::pool_slot(keys, n, i) : i;
    prep[slot] = in ? mul(sub(src[2 * i], ps[0]), ps[2]) : 0.0f;
    prep[kM + slot] = in ? mul(sub(src[2 * i + 1], ps[1]), ps[2]) : 0.0f;
    prep[2 * kM + slot] = in ? mul(sub(dst[2 * i], pd[0]), pd[2]) : 0.0f;
    prep[3 * kM + slot] = in ? mul(sub(dst[2 * i + 1], pd[1]), pd[2]) : 0.0f;
    prep[4 * kM + slot] = m;
    if (in) aux[slot] = i;
  }
  if (i == 0) {
    prep[kThrSq] = sweep::threshold_sq(threshold, pd[2]);
    prep[kInvS2] = rcp(mul(pd[2], pd[2]));
    aux[n] = n_valid;
  }
}

__global__ void __launch_bounds__(kThreads)
sweep_large_kernel(const float* __restrict__ prep, const int* __restrict__ aux,
                   int n, unsigned s0, unsigned s1, unsigned s2, unsigned s3,
                   unsigned s4, int B,
                   float* __restrict__ f_out,     // [4, B]
                   int* __restrict__ i_out) {     // [2, B]
  __shared__ float tab[5 * kM];
  const int n_rows = large::table_rows(n);
  for (int k = threadIdx.x; k < n_rows; k += kThreads) {
#pragma unroll
    for (int c = 0; c < 5; ++c) tab[c * kM + k] = prep[c * kM + k];
  }
  __syncthreads();
  const int n_valid = aux[n];
  const float inv_s2 = prep[kInvS2];

  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int r = g >> 3, s = g & 7;
  const int flat = (r >> 8) * sweep_large::kBlockH + s * 256 + (r & 255);
  const unsigned seeds[5] = {s0, s1, s2, s3, s4};
  const sweep_large::Table t{tab, tab + kM, tab + 2 * kM, tab + 3 * kM,
                             tab + 4 * kM};
  float msac, count;
  sweep_large::eval(static_cast<unsigned>(flat), seeds, n_valid, n_rows,
                    prep[kThrSq], t, &msac, &count);
  records::Record rec =
      records::reduce(msac, count, flat, msac, count, flat, large::kBig);
  if (s == 0) {
    rec.msac_m = sweep::rescale(rec.msac_m, inv_s2);
    rec.msac_c = sweep::rescale(rec.msac_c, inv_s2);
    records::write(rec, r, B, f_out, i_out);
  }
}

}  // namespace

// C entry point, bound with ctypes.  src/dst [n, 2] and mask [n] are the
// caller's raw points (4 <= n valid, n <= 1024); prep is a device buffer of
// kPrepFloats = 5122 floats, aux of n + 1 ints (the pool order, then
// n_valid); n_hyp must be a positive multiple of 2048 (the wrapper rounds
// it up to at least 4 blocks when n > 64).  Seeds: 4 draws, the window
// seed, the shuffle seed.  Launches both kernels on `stream`, does not
// synchronise, and returns cudaGetLastError().
extern "C" int sweep_large_launch(const float* src, const float* dst,
                                  const float* mask, float threshold,
                                  unsigned s0, unsigned s1, unsigned s2,
                                  unsigned s3, unsigned s4, unsigned s5, int n,
                                  int n_hyp, float* prep, int* aux,
                                  float* f_out, int* i_out, void* stream) {
  static_assert(kPrepFloats == 5122, "ops/sweep_large.py PREP_FLOATS");
  if (n < 1 || n > kM || n_hyp <= 0 || n_hyp % sweep_large::kBlockH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sweep_large_prep_kernel<<<1, kPrepThreads, 0, st>>>(src, dst, mask,
                                                      threshold, s5, n, prep,
                                                      aux);
  sweep_large_kernel<<<n_hyp / kThreads, kThreads, 0, st>>>(
      prep, aux, n, s0, s1, s2, s3, s4, n_hyp / 8, f_out, i_out);
  return static_cast<int>(cudaGetLastError());
}
