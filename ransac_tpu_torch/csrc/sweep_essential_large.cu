// Large-pool 8-point essential-matrix RANSAC sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `essential_ransac_sweep_large`
// (ransac_tpu/ops/pallas/sweep_essential_large.py, kernel body
// `_make_kernel`) for pools of up to 1024 correspondences: the fused path of
// the two-view pipeline.  A call is two launches from one C call:
//
// - sweep_essential_large_prep_kernel, one block of 1024 threads, does what
//   the JAX wrapper does in XLA: counts the valid points, normalizes both
//   images with one shared scale (masked centroids, mean distance over both
//   point sets, pairwise tree sums of sampler_large.cuh), scales the squared
//   threshold, and writes the table in the shuffled valid-first pool order
//   padded with zero rows to a multiple of 16, the pool order, n_valid, and
//   the centroids and scale (the caller re-solves the winner in this frame).
// - sweep_essential_large_kernel: each thread is one hypothesis
//   (sweep_essential_large.cuh): 8 windowed counter draws, the
//   canonical-frame F, the Sampson score of every table row from shared
//   memory (20 KB at most).  Records as the TPU kernel's: with LAN = block_h
//   / 8, record r = b * LAN + l covers the flat ids b * block_h + s * LAN + l,
//   s = 0..7, with the min-MSAC and (max count, min MSAC) winners and their
//   flat ids; MSAC is scaled back by 1 / s^2 as it is written.
//
// What bounds it on this card: FP32 CUDA-core arithmetic, about 300 dependent
// operations per hypothesis for the solve (8 sampled pairs, two frames, ten
// pairs of 2 x 2 minors) and ~40 per table row with one IEEE division.
// Making it fast is later work.
//
// Rounding: every operation is rounded on its own, in the order of the plain
// PyTorch version (`ransac_tpu_torch.ops.sweep_essential_large`), so the two
// agree bit for bit on the same inputs (rsqrt is rsqrtf, torch.rsqrt on the
// card).

#include <cuda_runtime.h>

#include "records.cuh"
#include "sampler_large.cuh"
#include "sweep_essential_large.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPrepThreads = 1024;
constexpr int kM = sweep_essential_large::kMaxPoints;
// The prep buffer: five columns of kM floats (u1, v1, u2, v2, weight) in
// pool order, then thr^2 * s^2, 1 / s^2, m1 (2), m2 (2) and s.
constexpr int kThr = 5 * kM, kInvS2 = kThr + 1, kM1 = kThr + 2, kM2 = kThr + 4,
              kScale = kThr + 6;
constexpr int kPrepFloats = kScale + 1;

// The 8 draw seeds and the window seed, passed by value.
struct Seeds {
  unsigned s[9];
};

__global__ void __launch_bounds__(kPrepThreads)
sweep_essential_large_prep_kernel(const float* __restrict__ x1,   // [n, 2]
                                  const float* __restrict__ x2,   // [n, 2]
                                  const float* __restrict__ mask, // [n]
                                  float threshold_sq, unsigned shuffle_seed,
                                  int n, float* __restrict__ prep,
                                  int* __restrict__ aux) {        // [n + 1]
  using namespace rt;
  __shared__ float buf[kM];
  __shared__ unsigned long long words[kM];
  __shared__ int slots[kM];
  const int i = threadIdx.x;
  const bool in = i < n;
  const float m = in ? mask[i] : 0.0f;
  const bool valid = in && m > 0.0f;
  const int n_valid = __syncthreads_count(valid);
  const int slot = large::pool_slot_sorted(
      large::shuffle_key(i, shuffle_seed, valid), n, words, slots);
  const int p = large::tree_width(n);
  buf[i] = m;
  const float wsum = max_nan(large::tree_sum_block(buf, p), 1.0f);
  float c1[3], c2[3];
  large::centroid_dist(x1, m, in, p, wsum, buf, c1);
  large::centroid_dist(x2, m, in, p, wsum, buf, c2);
  const float s = div(1.4142135623730951f,
                      max_nan(div(add(c1[2], c2[2]), mul(2.0f, wsum)), 1e-12f));

  const int n_rows = large::table_rows(n);
  if (i < n_rows) {
    prep[slot] = in ? mul(sub(x1[2 * i], c1[0]), s) : 0.0f;
    prep[kM + slot] = in ? mul(sub(x1[2 * i + 1], c1[1]), s) : 0.0f;
    prep[2 * kM + slot] = in ? mul(sub(x2[2 * i], c2[0]), s) : 0.0f;
    prep[3 * kM + slot] = in ? mul(sub(x2[2 * i + 1], c2[1]), s) : 0.0f;
    prep[4 * kM + slot] = m;
    if (in) aux[slot] = i;
  }
  if (i == 0) {
    prep[kThr] = mul(mul(threshold_sq, s), s);
    prep[kInvS2] = rcp(mul(s, s));
    prep[kM1] = c1[0];
    prep[kM1 + 1] = c1[1];
    prep[kM2] = c2[0];
    prep[kM2 + 1] = c2[1];
    prep[kScale] = s;
    aux[n] = n_valid;
  }
}

__global__ void __launch_bounds__(kThreads)
sweep_essential_large_kernel(const float* __restrict__ prep,
                             const int* __restrict__ aux, int n,
                             Seeds seeds, int lan, int B,
                             float* __restrict__ f_out,   // [4, B]
                             int* __restrict__ i_out) {   // [2, B]
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
  const int flat = (r / lan) * 8 * lan + s * lan + r % lan;
  const sweep_essential_large::Table t{tab, tab + kM, tab + 2 * kM,
                                       tab + 3 * kM, tab + 4 * kM};
  float msac, count;
  sweep_essential_large::eval(static_cast<unsigned>(flat), seeds.s, n_valid,
                              8 * lan, n_rows, prep[kThr], t, &msac, &count);
  records::Record rec =
      records::reduce(msac, count, flat, msac, count, flat, large::kBig);
  if (s == 0) {
    rec.msac_m = sweep::rescale(rec.msac_m, inv_s2);
    rec.msac_c = sweep::rescale(rec.msac_c, inv_s2);
    records::write(rec, r, B, f_out, i_out);
  }
}

}  // namespace

// C entry point, bound with ctypes.  x1/x2 [n, 2] (normalized camera
// coordinates) and mask [n], 8 <= n valid, n <= 1024; seeds s0-s7 draw, s8
// places the windows, s9 shuffles the pool; prep a device buffer
// of kPrepFloats = 5127 floats, aux of n + 1 ints (the pool order, then
// n_valid); block_h a multiple of 256 that divides n_hyp.  Launches both
// kernels on `stream`, does not synchronise, and returns cudaGetLastError().
extern "C" int sweep_essential_large_launch(const float* x1, const float* x2,
                                            const float* mask,
                                            float threshold_sq, unsigned s0,
                                            unsigned s1, unsigned s2,
                                            unsigned s3, unsigned s4,
                                            unsigned s5, unsigned s6,
                                            unsigned s7, unsigned s8,
                                            unsigned s9, int n,
                                            int n_hyp, int block_h,
                                            float* prep, int* aux,
                                            float* f_out, int* i_out,
                                            void* stream) {
  static_assert(kPrepFloats == 5127, "ops/sweep_essential_large.py PREP_FLOATS");
  if (n < 1 || n > kM || n_hyp <= 0 || block_h <= 0 ||
      block_h % kThreads != 0 || n_hyp % block_h != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Seeds seeds{{s0, s1, s2, s3, s4, s5, s6, s7, s8}};
  sweep_essential_large_prep_kernel<<<1, kPrepThreads, 0, st>>>(
      x1, x2, mask, threshold_sq, s9, n, prep, aux);
  sweep_essential_large_kernel<<<n_hyp / kThreads, kThreads, 0, st>>>(
      prep, aux, n, seeds, block_h / 8, n_hyp / 8, f_out, i_out);
  return static_cast<int>(cudaGetLastError());
}
