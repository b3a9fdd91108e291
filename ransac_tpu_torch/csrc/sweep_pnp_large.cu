// Large-pool P3P-RANSAC sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `pnp_ransac_sweep_large`
// (ransac_tpu/ops/pallas/sweep_pnp_large.py, kernel body `_make_kernel`) for
// pools of up to 512 correspondences.  A call is two launches from one C
// call:
//
// - sweep_pnp_large_prep_kernel, n_rows / 16 blocks of 512 threads, does
//   what the JAX wrapper does in XLA: counts the valid points, turns the
//   normalized pixels into unit bearings and (x, ay * y), and writes the
//   table in the shuffled valid-first pool order (sampler_large.cuh: a warp
//   a row counts the smaller pool words, 16 rows a block) padded with zero
//   rows to a multiple of 16, the pool order itself and n_valid.  The table
//   is what the score reads, point by point: (X, Y, Z, w) as one float4 and
//   (x, ay * y) as one float2 a slot; the bearings, which only the draws
//   read, in three columns after them.
// - sweep_pnp_large_kernel: each thread is one 3-point sample: windowed
//   counter draw (seeds 0-2, windows seed 3), then Grunert's P3P, depth
//   polish and triad pose (sweep_pnp.cuh); the block's valid poses are
//   gathered and scored over every table row (pnp_queue.cuh; the table in
//   shared memory, 12 KB at most).  Records as the TPU kernel's: with LAN =
//   block_h / 8, record r = b * LAN + l covers the flat ids b * block_h + s *
//   LAN + l, s = 0..7; the best root of each sample under both rules is
//   reduced over the record's eight samples to the min-MSAC and (max count,
//   min MSAC) winners, each packed as flat * 4 + root (flat < 2^28).  With
//   `full` set every (sample, root) writes its own record instead, as the
//   16-point sweep's full records (root * n_hyp + s * B + r), and the flat
//   id at s * B + r.
//
// What bounds it on this card: the FP32 pipe's issue rate, mostly in the
// score: ~24 operations a row and valid pose against ~1,200 for the solve.
// Only the valid (sample, root) pairs are scored (~40% on uniform inputs),
// in full warps whatever root of whatever lane they come from; the `Fused`
// score issues each product-sum after the camera point as one FFMA and the
// reciprocal on the MUFU pipe; a table row is one 16-byte and one 8-byte
// broadcast load, shared by the kPerLane poses a thread scores.
//
// Rounding: the prep and the solve round every operation on its own, in the
// order of the plain PyTorch version (`ransac_tpu_torch.ops.sweep_pnp_large`),
// so the table, pool order, samples, poses and validity are the plain
// version's bit for bit; rsqrt is rsqrtf, which is what torch.rsqrt
// computes on the card.  Counts and MSAC agree in their decisions
// (`ops.sweep_pnp_large.hold_full` / `hold_reduced`), not bit for bit.

#include <cuda_runtime.h>

#include "pnp_queue.cuh"
#include "records.cuh"
#include "sampler_large.cuh"
#include "sweep_pnp.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPerLane = 1;      // poses a thread scores against each point load
using Score = rt::Fused;         // the score's arithmetic policy
constexpr int kM = 512;          // MAX_POINTS
// The prep buffer: (X, Y, Z, w) of slot k at 4k, (x, ay * y) at kPix + 2k,
// bearing component c at kBear + c * kM + k.
constexpr int kPix = 4 * kM, kBear = 6 * kM;
constexpr int kPrepFloats = 9 * kM;

__global__ void __launch_bounds__(kM)
sweep_pnp_large_prep_kernel(const float* __restrict__ X,      // [n, 3]
                            const float* __restrict__ pix,    // [n, 2] normalized
                            const float* __restrict__ mask,   // [n]
                            float ay, unsigned shuffle_seed, int n,
                            float* __restrict__ prep,         // [kPrepFloats]
                            int* __restrict__ aux) {          // [n + 1]
  using namespace rt;
  __shared__ unsigned long long words[kM];
  const int t = threadIdx.x;
  const bool in = t < n;
  const bool valid = in && mask[t] > 0.0f;
  words[t] = in ? large::pool_word(t, large::shuffle_key(t, shuffle_seed, valid))
                : large::kPadWord;
  const int n_valid = __syncthreads_count(valid);
  // Warp w puts table row r = 16 * blockIdx.x + w at its slot.
  const int r = blockIdx.x * (kM / 32) + (t >> 5);
  if (r < large::table_rows(n)) {
    const int slot = large::pool_slot(words, r, n);
    if ((t & 31) == 0) {
      float4 xyzw = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float2 p2 = make_float2(0.0f, 0.0f);
      float bear[3] = {};
      if (r < n) {
        const float px = pix[2 * r], py = pix[2 * r + 1];
        const float nrm = sqrt_rn(add(add(mul(px, px), mul(py, py)), 1.0f));
        xyzw = make_float4(X[3 * r], X[3 * r + 1], X[3 * r + 2], mask[r]);
        p2 = make_float2(px, mul(py, ay));
        bear[0] = div(px, nrm);
        bear[1] = div(py, nrm);
        bear[2] = div(1.0f, nrm);
        aux[slot] = r;
      }
      reinterpret_cast<float4*>(prep)[slot] = xyzw;
      reinterpret_cast<float2*>(prep + kPix)[slot] = p2;
#pragma unroll
      for (int c = 0; c < 3; ++c) prep[kBear + c * kM + slot] = bear[c];
    }
  }
  if (blockIdx.x == 0 && t == 0) aux[n] = n_valid;
}

__global__ void __launch_bounds__(kThreads)
sweep_pnp_large_kernel(const float* __restrict__ prep,
                       const int* __restrict__ aux, int n, float thr_sq,
                       float ay, unsigned s0, unsigned s1, unsigned s2,
                       unsigned s3, int lan, int B, int full,
                       float* __restrict__ f_out,   // [4, B] or [8, 8B]
                       int* __restrict__ i_out) {   // [2, B] or [8B]
  __shared__ __align__(16) float s_xyzw[4 * kM];
  __shared__ __align__(8) float s_pix[2 * kM];
  __shared__ pnp_queue::Queue<kThreads> queue;
  const int n_rows = large::table_rows(n);
  for (int k = threadIdx.x; k < n_rows; k += kThreads) {
    reinterpret_cast<float4*>(s_xyzw)[k] = reinterpret_cast<const float4*>(prep)[k];
    reinterpret_cast<float2*>(s_pix)[k] = reinterpret_cast<const float2*>(prep + kPix)[k];
  }
  __syncthreads();
  const int n_valid = aux[n];

  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int r = g >> 3, s = g & 7;
  const int flat = (r / lan) * 8 * lan + s * lan + r % lan;
  const unsigned seeds[3] = {s0, s1, s2};
  int slot[3];
  large::sample_slots<3>(static_cast<unsigned>(flat), seeds, s3, n_valid,
                         8 * lan, slot);
  float P[3][3], F[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      P[j][c] = s_xyzw[4 * slot[j] + c];
      F[j][c] = __ldg(prep + kBear + c * kM + slot[j]);
    }
  }
  sweep_pnp::Solve sv;
  sweep_pnp::solve(P, F, &sv);
  const unsigned long long slots = queue.push(sv, F, n_valid >= 3, ay);
  __syncthreads();
  queue.score<Score, kPerLane>(sweep_pnp::Table{s_xyzw, s_pix}, n_rows, thr_sq);
  __syncthreads();
  float msac[sweep_pnp::kRoots], count[sweep_pnp::kRoots];
  queue.results(slots, msac, count);

  if (full) {
    const long long n_hyp = 8LL * B, o = static_cast<long long>(s) * B + r;
#pragma unroll
    for (int k = 0; k < sweep_pnp::kRoots; ++k) {
      f_out[k * n_hyp + o] = msac[k];
      f_out[(4 + k) * n_hyp + o] = count[k];
    }
    i_out[o] = flat;
    return;
  }
  float a_msac, a_count, b_msac, b_count;
  int a_root, b_root;
  sweep_pnp::best_roots(msac, count, &a_msac, &a_count, &a_root, &b_msac,
                        &b_count, &b_root);
  records::reduce_and_write(a_msac, a_count, flat * 4 + a_root, b_msac,
                            b_count, flat * 4 + b_root, sweep_pnp::kBig, s, r,
                            B, f_out, i_out);
}

}  // namespace

// C entry point, bound with ctypes.  X [n, 3], pix [n, 2] (fx-normalized
// pixels) and mask [n], 3 <= n valid, n <= 512; prep is a device buffer of
// kPrepFloats = 4608 floats (16-byte aligned), aux of n + 1 ints (the pool
// order, then n_valid); block_h a multiple of 256 that divides n_hyp.
// Seeds: 3 draws, the window seed, the shuffle seed.  `full`: per-(sample,
// root) records f_out [8, n_hyp] and flat ids i_out [n_hyp] instead of the
// reduced f_out [4, B] and i_out [2, B].  Launches both kernels on `stream`,
// does not synchronise, and returns cudaGetLastError().
extern "C" int sweep_pnp_large_launch(const float* X, const float* pix,
                                      const float* mask, float thr_sq,
                                      float ay, unsigned s0, unsigned s1,
                                      unsigned s2, unsigned s3, unsigned s4,
                                      int n, int n_hyp, int block_h, int full,
                                      float* prep, int* aux, float* f_out,
                                      int* i_out, void* stream) {
  static_assert(kPrepFloats == 4608, "ops/sweep_pnp_large.py PREP_FLOATS");
  if (n < 1 || n > kM || n_hyp <= 0 || block_h <= 0 ||
      block_h % 256 != 0 || n_hyp % block_h != 0 || n_hyp > (1 << 28)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rows = (n + 15) / 16 * 16;  // large::table_rows
  sweep_pnp_large_prep_kernel<<<(n_rows + 15) / 16, kM, 0, st>>>(X, pix, mask, ay, s4,
                                                                n, prep, aux);
  sweep_pnp_large_kernel<<<n_hyp / kThreads, kThreads, 0, st>>>(
      prep, aux, n, thr_sq, ay, s0, s1, s2, s3, block_h / 8, n_hyp / 8, full,
      f_out, i_out);
  return static_cast<int>(cudaGetLastError());
}
