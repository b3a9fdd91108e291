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
//   shuffled valid-first pool order padded with zero rows to a multiple of
//   16, the pool order itself and n_valid.  The pool order is a bitonic sort
//   of the words key << 32 | row, a word a thread (large::pool_slot_sorted:
//   55 passes at 1024 rows, 40 of them by warp shuffles), not a rank of
//   every row against every other.
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
  const float cnt = max_nan(large::tree_sum_block(buf, p), 1.0f);
  // Centroid and scale sqrt(2) / mean distance of src, then of dst
  // (sweep_large.py:396-407).
  float ps[3], pd[3];
  large::centroid_dist(src, m, in, p, cnt, buf, ps);
  large::centroid_dist(dst, m, in, p, cnt, buf, pd);
  ps[2] = div(1.4142135623730951f, max_nan(div(ps[2], cnt), 1e-12f));
  pd[2] = div(1.4142135623730951f, max_nan(div(pd[2], cnt), 1e-12f));

  if (i < large::table_rows(n)) {
    float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (in) {
      q.x = mul(sub(src[2 * i], ps[0]), ps[2]);
      q.y = mul(sub(src[2 * i + 1], ps[1]), ps[2]);
      q.z = mul(sub(dst[2 * i], pd[0]), pd[2]);
      q.w = mul(sub(dst[2 * i + 1], pd[1]), pd[2]);
      aux[slot] = i;
    }
    reinterpret_cast<float4*>(prep)[slot] = q;
    prep[kW + slot] = m;
  }
  if (i == 0) {
    prep[kThrSq] = sweep::threshold_sq(threshold, pd[2]);
    prep[kInvS2] = rcp(mul(pd[2], pd[2]));
    aux[n] = n_valid;
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
  sweep_large_prep_kernel<<<1, kPrepThreads, 0, st>>>(src, dst, mask,
                                                      threshold, s5, n, prep,
                                                      aux);
  sweep_large_kernel<<<n_hyp / (kThreads * kHyp), kThreads, 0, st>>>(
      prep, aux, n, Seeds{{s0, s1, s2, s3, s4}}, n_hyp / 8, full, f_out, i_out);
  return static_cast<int>(cudaGetLastError());
}
