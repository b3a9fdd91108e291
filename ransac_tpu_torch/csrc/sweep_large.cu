// Large-pool homography-RANSAC sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `homography_ransac_sweep_large`
// (ransac_tpu/ops/pallas/sweep_large.py, kernel body `_make_kernel`) for
// pools of up to 1024 correspondences.  A call is two launches from one C
// call:
//
// - sweep_large_prep_kernel does what the JAX wrapper does in XLA: counts
//   the valid points, normalizes src and dst by their masked centroids and
//   mean distances (large::pool_norm: two passes of column-wise pairwise
//   tree sums, see sampler_large.cuh), scales the threshold, and writes the
//   table in the shuffled valid-first pool order padded with zero rows to a
//   multiple of 16, the pool order itself and n_valid.  It is n_rows / 32
//   blocks of 1024 threads: each stages every row in shared memory, takes
//   the sums, and gives 32 rows their slots, a warp a row counting the
//   smaller pool words key << 32 | row (large::pool_slot).
// - sweep_large_kernel: a thread carries kHyp hypotheses (sweep_large.cuh):
//   windowed counter samples, projective-frame homographies, then the score
//   of every table row from shared memory (the table is at most 20 KB), one
//   broadcast 16-byte load (x, y, px, py) and one weight a row for all kHyp.
//   The TPU kernel's records are kept: record r = b * 256 + l covers the
//   flat ids b * 2048 + s * 256 + l, s = 0..7, and holds the min-MSAC and
//   (max count, min MSAC) winners with their flat ids.  Thread (r, c), c <
//   8 / kHyp, holds s = c * kHyp + k; the record reduces in registers, then
//   with log2(8 / kHyp) xor shuffles (records.cuh), selecting exactly as the
//   TPU does.  MSAC is scaled back to pixel^2 units as it is written.  With
//   `full` set every hypothesis writes its own (msac, count, flat) at s * B
//   + r instead, B = n_hyp / 8.
//
// What bounds it on this card: the FP32 pipe's issue rate, ~19 operations a
// table row and hypothesis (1024 rows against ~150 for the draws and the
// solve).  The design spends the issue slots on that arithmetic: from the
// residual on a product-sum is one FFMA and the reciprocal of w^2 goes to
// the MUFU pipe (the `Fused` policy of fp32_rn.cuh; the projection keeps
// the plain order, sweep_large.cuh), and one shared-memory vector load a
// row serves kHyp hypotheses held in registers.
//
// Rounding: the score rounds each product-sum once, so the kernel agrees
// with the plain PyTorch version (`ransac_tpu_torch.ops.sweep_large`, every
// operation rounded on its own) in its decisions, not bit for bit: the
// same samples and validity (the solve is exact), counts equal but where
// points at the inlier cut explain a flip, MSAC within 1e-4 relative on >=
// 99% of hypotheses and 1e-3 on all (`ops.sweep.hold_full`, held on the
// card by chip_smoke.py).  The table, the pool order and n_valid are the
// plain version's bit for bit, and the `Exact` instantiation of the header
// is its arithmetic bit for bit (host build).

#include <cuda_runtime.h>

#include "records.cuh"
#include "sampler_large.cuh"
#include "sweep_large.cuh"

namespace {

using Score = rt::Fused;         // the score's arithmetic policy
constexpr int kThreads = 256;
constexpr int kHyp = 4;          // hypotheses a thread
constexpr int kLanes = 8 / kHyp; // lanes a record
constexpr int kPrepThreads = 1024;
constexpr int kM = sweep_large::kMaxPoints;
constexpr int kStage = large::padded(kM);  // floats of a staged prep column
// The prep buffer: table row k as (x, y, px, py) at 4k..4k+3, its weight at
// kW + k, then thr^2 and 1 / s_dst^2.
constexpr int kW = 4 * kM;
constexpr int kThrSq = 5 * kM, kInvS2 = kThrSq + 1;
constexpr int kPrepFloats = kInvS2 + 1;

// The 4 draw seeds and the window seed, passed by value.
struct Seeds {
  unsigned s[5];
};

__global__ void __launch_bounds__(kPrepThreads)
sweep_large_prep_kernel(const float* __restrict__ src,   // [n, 2] raw
                        const float* __restrict__ dst,   // [n, 2] raw
                        const float* __restrict__ mask,  // [n]
                        float threshold, unsigned shuffle_seed, int n,
                        float* __restrict__ prep,        // [kPrepFloats]
                        int* __restrict__ aux) {         // [n + 1]
  using namespace rt;
  __shared__ unsigned long long words[kM];
  __shared__ float raw[5 * kStage];  // m, sx, sy, dx, dy of row r at padded(r)
  __shared__ float cols[8 * 32];
  const int t = threadIdx.x;
  const bool in = t < n;
  const float v[5] = {in ? mask[t] : 0.0f, in ? src[2 * t] : 0.0f,
                      in ? src[2 * t + 1] : 0.0f, in ? dst[2 * t] : 0.0f,
                      in ? dst[2 * t + 1] : 0.0f};
#pragma unroll
  for (int c = 0; c < 5; ++c) raw[c * kStage + large::padded(t)] = v[c];
  words[t] = in ? large::pool_word(t, large::shuffle_key(t, shuffle_seed, v[0] > 0.0f))
                : large::kPadWord;
  __syncthreads();
  // cnt, the centroids of src and dst, their distance sums, n_valid
  // (sweep_large.py:396-407).
  float nrm[8];
  large::pool_norm(raw, kStage, n, cols, nrm);
  const float s_src = div(1.4142135623730951f, max_nan(div(nrm[5], nrm[0]), 1e-12f));
  const float s_dst = div(1.4142135623730951f, max_nan(div(nrm[6], nrm[0]), 1e-12f));

  // Warp w puts table row r = 32 * blockIdx.x + w at its slot.
  const int r = blockIdx.x * (kPrepThreads / 32) + (t >> 5);
  if (r < large::table_rows(n)) {
    const int slot = large::pool_slot(words, r, n);
    if ((t & 31) == 0) {
      float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float m = 0.0f;
      if (r < n) {
        const float* x = raw + large::padded(r);
        m = x[0];
        q.x = mul(sub(x[kStage], nrm[1]), s_src);
        q.y = mul(sub(x[2 * kStage], nrm[2]), s_src);
        q.z = mul(sub(x[3 * kStage], nrm[3]), s_dst);
        q.w = mul(sub(x[4 * kStage], nrm[4]), s_dst);
        aux[slot] = r;
      }
      reinterpret_cast<float4*>(prep)[slot] = q;
      prep[kW + slot] = m;
    }
  }
  if (blockIdx.x == 0 && t == 0) {
    prep[kThrSq] = sweep::threshold_sq(threshold, s_dst);
    prep[kInvS2] = rcp(mul(s_dst, s_dst));
    aux[n] = static_cast<int>(nrm[7]);
  }
}

__global__ void __launch_bounds__(kThreads)
sweep_large_kernel(const float* __restrict__ prep, const int* __restrict__ aux,
                   int n, Seeds seeds, int B, int full,
                   float* __restrict__ f_out,     // [4, B] or [2, 8B]
                   int* __restrict__ i_out) {     // [2, B] or [8B]
  __shared__ float4 s_pts[kM];
  __shared__ float s_w[kM];
  const int n_rows = large::table_rows(n);
  for (int k = threadIdx.x; k < n_rows; k += kThreads) {
    s_pts[k] = reinterpret_cast<const float4*>(prep)[k];
    s_w[k] = prep[kW + k];
  }
  __syncthreads();
  const int n_valid = aux[n];
  const float inv_s2 = prep[kInvS2];

  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int r = g / kLanes, c = g % kLanes;
  // Hypothesis s = c * kHyp + k of record r.
  const int flat0 = (r >> 8) * sweep_large::kBlockH + c * kHyp * 256 + (r & 255);
  const sweep_large::Table t{reinterpret_cast<const float*>(s_pts), s_w};
  float msac[kHyp], count[kHyp];
  int flat[kHyp];
  sweep_large::eval<Score, kHyp>(static_cast<unsigned>(flat0), 256, seeds.s,
                                 n_valid, n_rows, prep[kThrSq], t, msac, count);
#pragma unroll
  for (int k = 0; k < kHyp; ++k) flat[k] = flat0 + k * 256;

  if (full) {
    const long long n_hyp = 8LL * B;
#pragma unroll
    for (int k = 0; k < kHyp; ++k) {
      const long long o = static_cast<long long>(c * kHyp + k) * B + r;
      f_out[o] = sweep::rescale(msac[k], inv_s2);
      f_out[n_hyp + o] = count[k];
      i_out[o] = flat[k];
    }
    return;
  }
  records::Record rec = records::reduce_k<kHyp>(msac, count, flat, msac, count,
                                                flat, large::kBig, 1 << 30);
  if (c == 0) {
    rec.msac_m = sweep::rescale(rec.msac_m, inv_s2);
    rec.msac_c = sweep::rescale(rec.msac_c, inv_s2);
    records::write(rec, r, B, f_out, i_out);
  }
}

}  // namespace

// C entry point, bound with ctypes.  src/dst [n, 2] and mask [n] are the
// caller's raw points (4 <= n valid, n <= 1024); prep is a 16-byte aligned
// device buffer of kPrepFloats = 5122 floats, aux of n + 1 ints (the pool
// order, then n_valid); n_hyp must be a positive multiple of 2048 (the
// wrapper rounds it up to at least 4 blocks when n > 64).  Seeds: 4 draws,
// the window seed, the shuffle seed.  `full`: every hypothesis' record
// (f_out [2, n_hyp], i_out [n_hyp]) instead of the reduced ones (f_out [4,
// B], i_out [2, B]).  Launches both kernels on `stream`, does not
// synchronise, and returns cudaGetLastError().
extern "C" int sweep_large_launch(const float* src, const float* dst,
                                  const float* mask, float threshold,
                                  unsigned s0, unsigned s1, unsigned s2,
                                  unsigned s3, unsigned s4, unsigned s5, int n,
                                  int n_hyp, int full, float* prep, int* aux,
                                  float* f_out, int* i_out, void* stream) {
  static_assert(kPrepFloats == 5122, "ops/sweep_large.py PREP_FLOATS");
  static_assert(sweep_large::kBlockH % (kThreads * kHyp) == 0,
                "n_hyp is a whole number of the grid's blocks");
  if (n < 1 || n > kM || n_hyp <= 0 || n_hyp % sweep_large::kBlockH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_rows = (n + 15) / 16 * 16;  // large::table_rows
  sweep_large_prep_kernel<<<(n_rows + 31) / 32, kPrepThreads, 0, st>>>(
      src, dst, mask, threshold, s5, n, prep, aux);
  sweep_large_kernel<<<n_hyp / (kThreads * kHyp), kThreads, 0, st>>>(
      prep, aux, n, Seeds{{s0, s1, s2, s3, s4}}, n_hyp / 8, full, f_out, i_out);
  return static_cast<int>(cudaGetLastError());
}
