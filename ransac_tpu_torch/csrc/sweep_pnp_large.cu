// Large-pool P3P-RANSAC sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `pnp_ransac_sweep_large`
// (ransac_tpu/ops/pallas/sweep_pnp_large.py, kernel body `_make_kernel`) for
// pools of up to 512 correspondences.  A call is two launches from one C
// call:
//
// - sweep_pnp_large_prep_kernel, one block of 512 threads, does what the JAX
//   wrapper does in XLA: counts the valid points, turns the normalized
//   pixels into unit bearings and (x, ay * y), and writes the table in the
//   shuffled valid-first pool order (sampler_large.cuh) padded with zero
//   rows to a multiple of 16, the pool order itself and n_valid.
// - sweep_pnp_large_kernel: each thread is one 3-point sample: windowed
//   counter draw (seeds 0-2, windows seed 3), then Grunert's P3P, depth
//   polish, triad pose and the score of every table row under each of the
//   four roots (sweep_pnp.cuh's solve_and_score, the table in shared memory,
//   18 KB at most).  Records as the TPU kernel's: with LAN = block_h / 8,
//   record r = b * LAN + l covers the flat ids b * block_h + s * LAN + l,
//   s = 0..7; the best root of each sample under both rules is reduced over
//   the record's eight samples to the min-MSAC and (max count, min MSAC)
//   winners, each packed as flat * 4 + root (flat < 2^28).
//
// What bounds it on this card: FP32 CUDA-core arithmetic and its latency,
// about 2,000 operations per sample plus 4 x ~30 per table row, with exact
// divisions, and long serial dependency chains in the quartic.  The four
// roots are worked one at a time (the root loop is not unrolled) to keep
// registers down.  Making it fast is later work.
//
// Rounding: every operation is rounded on its own, in the order of the plain
// PyTorch version (`ransac_tpu_torch.ops.sweep_pnp_large`); rsqrt is rsqrtf,
// which is what torch.rsqrt computes on the card.

#include <cuda_runtime.h>

#include "records.cuh"
#include "sampler_large.cuh"
#include "sweep_pnp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kM = 512;  // MAX_POINTS
constexpr int kCols = 9;  // X Y Z fx fy fz px py w
constexpr int kPrepFloats = kCols * kM;

__global__ void __launch_bounds__(kM)
sweep_pnp_large_prep_kernel(const float* __restrict__ X,      // [n, 3]
                            const float* __restrict__ pix,    // [n, 2] normalized
                            const float* __restrict__ mask,   // [n]
                            float ay, unsigned shuffle_seed, int n,
                            float* __restrict__ prep,         // [kPrepFloats]
                            int* __restrict__ aux) {          // [n + 1]
  using namespace rt;
  __shared__ unsigned keys[kM];
  const int i = threadIdx.x;
  const bool in = i < n;
  const float m = in ? mask[i] : 0.0f;
  const bool valid = in && m > 0.0f;
  if (in) keys[i] = large::shuffle_key(i, shuffle_seed, valid);
  const int n_valid = __syncthreads_count(valid);
  const int n_rows = large::table_rows(n);
  if (i < n_rows) {
    const int slot = in ? large::pool_slot(keys, n, i) : i;
    float v[kCols] = {};
    if (in) {
      const float px = pix[2 * i], py = pix[2 * i + 1];
      const float nrm = sqrt_rn(add(add(mul(px, px), mul(py, py)), 1.0f));
      v[0] = X[3 * i];
      v[1] = X[3 * i + 1];
      v[2] = X[3 * i + 2];
      v[3] = div(px, nrm);
      v[4] = div(py, nrm);
      v[5] = div(1.0f, nrm);
      v[6] = px;
      v[7] = mul(py, ay);
      v[8] = m;
      aux[slot] = i;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) prep[c * kM + slot] = v[c];
  }
  if (i == 0) aux[n] = n_valid;
}

__global__ void __launch_bounds__(kThreads)
sweep_pnp_large_kernel(const float* __restrict__ prep,
                       const int* __restrict__ aux, int n, float thr_sq,
                       float ay, unsigned s0, unsigned s1, unsigned s2,
                       unsigned s3, int lan, int B,
                       float* __restrict__ f_out,   // [4, B]
                       int* __restrict__ i_out) {   // [2, B]
  __shared__ float tab[kCols * kM];
  const int n_rows = large::table_rows(n);
  for (int k = threadIdx.x; k < n_rows; k += kThreads) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) tab[c * kM + k] = prep[c * kM + k];
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
  const sweep_pnp::Pool pool{tab,          tab + kM,     tab + 2 * kM,
                             tab + 3 * kM, tab + 4 * kM, tab + 5 * kM,
                             tab + 6 * kM, tab + 7 * kM, tab + 8 * kM};
  float P[3][3], F[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      P[j][c] = tab[c * kM + slot[j]];
      F[j][c] = tab[(3 + c) * kM + slot[j]];
    }
  }
  float msac[sweep_pnp::kRoots], count[sweep_pnp::kRoots];
  sweep_pnp::solve_and_score(P, F, n_valid >= 3, n_rows, thr_sq, ay, pool,
                             msac, count);
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
// kPrepFloats = 4608 floats, aux of n + 1 ints (the pool order, then
// n_valid); block_h a multiple of 256 that divides n_hyp.  Seeds: 3 draws,
// the window seed, the shuffle seed.  Launches both kernels on `stream`,
// does not synchronise, and returns cudaGetLastError().
extern "C" int sweep_pnp_large_launch(const float* X, const float* pix,
                                      const float* mask, float thr_sq,
                                      float ay, unsigned s0, unsigned s1,
                                      unsigned s2, unsigned s3, unsigned s4,
                                      int n, int n_hyp, int block_h,
                                      float* prep, int* aux, float* f_out,
                                      int* i_out, void* stream) {
  static_assert(kPrepFloats == 4608, "ops/sweep_pnp_large.py PREP_FLOATS");
  if (n < 1 || n > kM || n_hyp <= 0 || block_h <= 0 ||
      block_h % kThreads != 0 || n_hyp % block_h != 0 ||
      n_hyp > (1 << 28)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sweep_pnp_large_prep_kernel<<<1, kM, 0, st>>>(X, pix, mask, ay, s4, n, prep,
                                                aux);
  sweep_pnp_large_kernel<<<n_hyp / kThreads, kThreads, 0, st>>>(
      prep, aux, n, thr_sq, ay, s0, s1, s2, s3, block_h / 8, n_hyp / 8, f_out,
      i_out);
  return static_cast<int>(cudaGetLastError());
}
