// <= 16-point 8-point essential-matrix RANSAC sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `essential_ransac_sweep`
// (ransac_tpu/ops/pallas/sweep_essential.py, kernel body `_make_kernel`).
// A thread carries kHyp hypotheses (sweep_essential.cuh): for each its
// 8-point sample from the counter PRNG (no random tensor in device memory)
// and the canonical-frame F, then the Sampson score of every point against
// all kHyp.  The TPU kernel's record layout is kept: with LAN = block_h / 8,
// record r = b * LAN + l covers the flat ids b * block_h + s * LAN + l,
// s = 0..7, and holds two winners, by min MSAC and by (max count, min MSAC);
// ties go to the smallest packed sample as an UNSIGNED number (records.cuh
// reduce_unsigned: the eight 4-bit indices use the sign bit).  Thread (r, c),
// c < 8 / kHyp, holds s = c * kHyp + k; the record reduces in registers,
// then with xor shuffles.  With `full` set every hypothesis writes its own
// (msac, count, packed) at s * B + r instead, B = n_hyp / 8 (the TPU's
// full-record order).
//
// A call is two launches from one C call: a one-warp prep kernel does the
// JAX wrapper's XLA work (sweep_essential.py:331-346: one shared scale over
// both images, the scaled squared threshold, the sample bitmask) into a
// small device buffer, from the points staged in shared memory, then the
// sweep, which scales MSAC back by 1 / s^2 as it writes.
//
// What bounds it on this card: the FP32 pipe's issue rate (the canonical
// solve is ~530 operations, almost all product-differences; a Sampson test
// 40, 25 with each product-sum one FFMA; no tile for the tensor cores,
// nothing for TMA to move).  As in sweep.cu: FFMA for every product-sum of
// the score (`Fused`, fp32_rn.cuh), MUFU's reciprocal of the Sampson
// denominator, one broadcast 16-byte load per pool point scored against
// kHyp F's, draws and the record's flat id reduced by multiply-high with
// divisors made on the host (rt::Divider).  The solve keeps one rounding
// per operation: fused, it amplified its last-place differences on
// ill-conditioned samples until the card and the plain version counted a
// min-MSAC sample's inliers differently.
//
// Rounding: F is the plain PyTorch version's
// (`ransac_tpu_torch.ops.sweep_essential`) bit for bit; the score rounds
// each product-sum once, so the two agree in their decisions (a count
// moves only where a point sits at the Sampson cut), not bit for bit
// (`ops.sweep_essential.hold_full`, held on the card by chip_smoke.py).  The
// `Exact` instantiation of the same header is the plain version's
// arithmetic bit for bit (host build; rsqrt is rsqrtf, torch.rsqrt on the
// card).

#include <cuda_runtime.h>

#include "records.cuh"
#include "sweep_essential.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHyp = 4;              // hypotheses a thread
constexpr int kLanes = 8 / kHyp;     // lanes a record
constexpr int kM = sweep_essential::kMaxPoints;
// The prep buffer: point n as (x1, y1, x2, y2) at 4n..4n+3, the mask at
// 4 kM + n, then thr^2 * s^2, 1 / s^2 and the sample bitmask (an int).
constexpr int kW = 4 * kM;
constexpr int kThrSq = 5 * kM, kInvS2 = kThrSq + 1, kVmask = kThrSq + 2;
constexpr int kPrepFloats = kVmask + 1;

// The 8 draw seeds, their divisors n_points - j and LAN's, passed by value.
struct Draws {
  unsigned seed[8];
  rt::Divider div[8];
  rt::Divider lan;
};

__global__ void __launch_bounds__(32)
sweep_essential_prep_kernel(const float* __restrict__ x1,   // [n, 2] raw
                            const float* __restrict__ x2,   // [n, 2] raw
                            const float* __restrict__ mask, // [n]
                            float threshold_sq, int n_points, int n_score,
                            float* __restrict__ prep) {     // [kPrepFloats]
  using namespace rt;
  __shared__ float s_x1[2 * kM], s_x2[2 * kM], s_mask[kM];
  __shared__ float s_par[5];  // m1 (2), m2 (2), s
  const int tid = threadIdx.x;
  if (tid < kM) {
    const bool in = tid < n_score;
    s_x1[2 * tid] = in ? x1[2 * tid] : 0.0f;
    s_x1[2 * tid + 1] = in ? x1[2 * tid + 1] : 0.0f;
    s_x2[2 * tid] = in ? x2[2 * tid] : 0.0f;
    s_x2[2 * tid + 1] = in ? x2[2 * tid + 1] : 0.0f;
    s_mask[tid] = in ? mask[tid] : 0.0f;
  }
  __syncwarp();
  if (tid == 0) sweep_essential::norm_params(s_x1, s_x2, n_points, s_par);
  __syncwarp();
  const float s = s_par[4];
  if (tid < kM) {
    const bool in = tid < n_score;
    float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (in) {
      q.x = mul(sub(s_x1[2 * tid], s_par[0]), s);
      q.y = mul(sub(s_x1[2 * tid + 1], s_par[1]), s);
      q.z = mul(sub(s_x2[2 * tid], s_par[2]), s);
      q.w = mul(sub(s_x2[2 * tid + 1], s_par[3]), s);
    }
    reinterpret_cast<float4*>(prep)[tid] = q;
    prep[kW + tid] = s_mask[tid];
  }
  if (tid == 0) {
    prep[kThrSq] = mul(mul(threshold_sq, s), s);
    prep[kInvS2] = rcp(mul(s, s));
    prep[kVmask] = as_float(sweep::sample_bitmask(s_mask, n_score));
  }
}

__global__ void __launch_bounds__(kThreads)
sweep_essential_kernel(const float* __restrict__ prep,  // normalized pool
                       Draws draws, int n_score, int lan, int n_hyp, int full,
                       float* __restrict__ f_out,       // [4, B] or [2, n_hyp]
                       int* __restrict__ i_out) {       // [2, B] or [n_hyp]
  __shared__ float4 s_pts[kM];
  __shared__ float s_w[kM];
  const int tid = threadIdx.x;
  if (tid < kM) {
    s_pts[tid] = reinterpret_cast<const float4*>(prep)[tid];
    s_w[tid] = prep[kW + tid];
  }
  __syncthreads();
  const float inv_s2 = prep[kInvS2];

  // Threads past the last record (the last block of a block_h that is not
  // a multiple of 8 kThreads / kHyp) evaluate hypotheses too, for the
  // shuffles, and write nothing.
  const int g = blockIdx.x * kThreads + tid;
  const int r = g / kLanes, c = g % kLanes, B = n_hyp / 8;
  const unsigned rb = rt::udiv(static_cast<unsigned>(r), draws.lan);
  const unsigned rl = static_cast<unsigned>(r) - rb * static_cast<unsigned>(lan);
  // Hypothesis s = c * kHyp + k of record r.
  const unsigned flat0 = (rb * 8 + c * kHyp) * static_cast<unsigned>(lan) + rl;
  const sweep::Pool pool{reinterpret_cast<const float*>(s_pts), s_w};
  float msac[kHyp], count[kHyp];
  int packed[kHyp];
  sweep_essential::eval<rt::Fused, kHyp>(
      flat0, static_cast<unsigned>(lan), draws.seed, draws.div,
      rt::as_int(prep[kVmask]), n_score, prep[kThrSq], pool, msac, count, packed);

  if (full) {
    if (r < B) {
#pragma unroll
      for (int k = 0; k < kHyp; ++k) {
        const long long o = static_cast<long long>(c * kHyp + k) * B + r;
        f_out[o] = sweep::rescale(msac[k], inv_s2);
        f_out[n_hyp + o] = count[k];
        i_out[o] = packed[k];
      }
    }
    return;
  }
  records::Record rec =
      records::reduce_unsigned<kHyp>(msac, count, packed, sweep::kInvalid);
  if (c == 0 && r < B) {
    rec.msac_m = sweep::rescale(rec.msac_m, inv_s2);
    rec.msac_c = sweep::rescale(rec.msac_c, inv_s2);
    records::write(rec, r, B, f_out, i_out);
  }
}

}  // namespace

// C entry point, bound with ctypes.  x1/x2 [n_score, 2] and mask [n_score]
// are the caller's raw points, 8 <= n_points <= n_score <= 16; s0-s7 the
// draw seeds; block_h a positive multiple of 8 that divides n_hyp; prep a
// device buffer of kPrepFloats = 83 floats (16-byte aligned).  Launches both
// kernels on `stream` (PyTorch's current stream), does not synchronise, and
// returns cudaGetLastError().
extern "C" int sweep_essential_launch(const float* x1, const float* x2,
                                      const float* mask, float threshold_sq,
                                      unsigned s0, unsigned s1, unsigned s2,
                                      unsigned s3, unsigned s4, unsigned s5,
                                      unsigned s6, unsigned s7, int n_points,
                                      int n_score, int n_hyp, int block_h,
                                      int full, float* prep, float* f_out,
                                      int* i_out, void* stream) {
  static_assert(kPrepFloats == 83, "ops/sweep_essential.py PREP_FLOATS");
  if (n_points < 8 || n_points > n_score || n_score > kM || block_h <= 0 ||
      block_h % 8 != 0 || n_hyp <= 0 || n_hyp % block_h != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Draws draws{{s0, s1, s2, s3, s4, s5, s6, s7}, {}, rt::make_divider(block_h / 8)};
  for (int j = 0; j < 8; ++j) draws.div[j] = rt::make_divider(n_points - j);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = n_hyp / kHyp;
  sweep_essential_prep_kernel<<<1, 32, 0, st>>>(x1, x2, mask, threshold_sq,
                                                n_points, n_score, prep);
  sweep_essential_kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      prep, draws, n_score, block_h / 8, n_hyp, full, f_out, i_out);
  return static_cast<int>(cudaGetLastError());
}
