// Fused homography-RANSAC sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `homography_ransac_sweep`
// (ransac_tpu/ops/pallas/sweep.py, kernel body `_make_kernel`).  A thread
// carries kHyp hypotheses: for each it draws its 4-point sample from the
// counter PRNG (no random tensor in device memory) and solves the
// projective-frame homography, then scores every point against all kHyp
// (sweep.cuh).  The TPU kernel's record layout is kept: record r = b * 256 +
// l covers the flat ids b * 2048 + s * 256 + l, s = 0..7, and holds two
// winners, by min MSAC (ties to the smallest packed sample) and by (max
// count, min MSAC, smallest packed sample).  Thread (r, c), c < 8 / kHyp,
// holds s = c * kHyp + k; the record reduces in registers, then with
// log2(8 / kHyp) xor shuffles (records.cuh), exactly as the TPU's sublane
// reductions select.  With `full` set every hypothesis writes its own
// (msac, count, packed) at s * B + r instead, B = n_hyp / 8 (the TPU
// kernel's full-record order).
//
// The entry point takes the caller's raw points.  A one-block kernel first
// normalizes them as the JAX wrapper does (centroid and mean distance of
// src and of dst, on two warps at once) into a small device buffer, and
// the sweep scales MSAC back to pixel^2 units as it writes, so a call is
// two launches from one C call.  (Normalizing in every block's prologue
// instead cost the sweep 17-33% of its device time at 2^22.)
//
// What bounds it on this card: the FP32 pipe's issue rate.  The pool is 83
// floats and the projection a 3 x 3 by 3-vector product, so there is no
// tile for the tensor cores (and TF32 would move inlier decisions at the
// threshold) and nothing for TMA to move.  The design spends the issue
// slots on the arithmetic: a product-sum is one FFMA (the `Fused` policy of
// fp32_rn.cuh), the per-point reciprocal goes to the MUFU pipe
// (rcp.approx), each pool point is one broadcast 16-byte shared-memory load
// scored against kHyp homographies in registers, and the draws reduce modulo
// n - j by a multiply-high with divisors made once per call on the host
// (rt::Divider), not by a run-time `%`.
//
// Rounding: the `Fused` policy rounds each product-sum once, so the kernel
// agrees with the plain PyTorch version (`ransac_tpu_torch.ops.sweep.
// _sweep_plain`, every operation rounded on its own) in its decisions, not
// bit for bit: the same samples, validity and counts (a flip only at a cut),
// MSAC within 1e-4 relative on >= 99% of hypotheses and 1e-3 on all
// (`ops.sweep.hold_full`, held on the card by chip_smoke.py).  The `Exact`
// instantiation of the same header is the plain version's arithmetic bit
// for bit (host build).

#include <cuda_runtime.h>

#include "records.cuh"
#include "sweep.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHyp = 4;              // hypotheses a thread
constexpr int kLanes = 8 / kHyp;     // lanes a record
constexpr int kM = sweep::kMaxPoints;
// The normalized pool in the prep buffer: point n as (sx, sy, dx, dy) at
// 4n..4n+3, the mask at 4 kM + n, then thr^2, 1 / s_dst^2 and the sample
// bitmask (an int).
constexpr int kW = 4 * kM;
constexpr int kThrSq = 5 * kM, kInvS2 = kThrSq + 1, kVmask = kThrSq + 2;
constexpr int kPrepFloats = kVmask + 1;

// The 4 draw seeds and their divisors n_points - j, passed by value.
struct Draws {
  unsigned seed[4];
  rt::Divider div[4];
};

__global__ void __launch_bounds__(64)
sweep_prep_kernel(const float* __restrict__ src,  // [n, 2] raw
                  const float* __restrict__ dst,  // [n, 2] raw
                  const float* __restrict__ mask, // [n]
                  float threshold, int n_points, int n_score,
                  float* __restrict__ prep) {     // [kPrepFloats]
  __shared__ float s_src[2 * kM], s_dst[2 * kM];
  __shared__ float s_par[6];  // centroid and scale of src, then of dst
  const int tid = threadIdx.x;
  if (tid < kM) {
    const bool in = tid < n_score;
    s_src[2 * tid] = in ? src[2 * tid] : 0.0f;
    s_src[2 * tid + 1] = in ? src[2 * tid + 1] : 0.0f;
    s_dst[2 * tid] = in ? dst[2 * tid] : 0.0f;
    s_dst[2 * tid + 1] = in ? dst[2 * tid + 1] : 0.0f;
    prep[kW + tid] = in ? mask[tid] : 0.0f;
  }
  __syncthreads();
  if (tid == 0) sweep::norm_params(s_src, n_points, s_par);
  if (tid == 32) sweep::norm_params(s_dst, n_points, s_par + 3);
  __syncthreads();
  if (tid < kM) {
    const bool in = tid < n_score;
    float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (in) {
      q.x = rt::mul(rt::sub(s_src[2 * tid], s_par[0]), s_par[2]);
      q.y = rt::mul(rt::sub(s_src[2 * tid + 1], s_par[1]), s_par[2]);
      q.z = rt::mul(rt::sub(s_dst[2 * tid], s_par[3]), s_par[5]);
      q.w = rt::mul(rt::sub(s_dst[2 * tid + 1], s_par[4]), s_par[5]);
    }
    reinterpret_cast<float4*>(prep)[tid] = q;
  }
  if (tid == 32) {
    const float s_dst = s_par[5];
    prep[kThrSq] = sweep::threshold_sq(threshold, s_dst);
    prep[kInvS2] = rt::rcp(rt::mul(s_dst, s_dst));
    prep[kVmask] = rt::as_float(sweep::sample_bitmask(mask, n_score));
  }
}

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ prep,    // normalized pool
             Draws draws, int n_score, int B, int full,
             float* __restrict__ f_out,         // [4, B] or [2, 8B]
             int* __restrict__ i_out) {         // [2, B] or [8B]
  __shared__ float4 s_pts[kM];
  __shared__ float s_w[kM];
  const int tid = threadIdx.x;
  if (tid < kM) {
    s_pts[tid] = reinterpret_cast<const float4*>(prep)[tid];
    s_w[tid] = prep[kW + tid];
  }
  __syncthreads();
  const float inv_s2 = prep[kInvS2];

  const int g = blockIdx.x * kThreads + tid;
  const int r = g / kLanes, c = g % kLanes;
  // Hypothesis s = c * kHyp + k of record r.
  const unsigned flat0 =
      static_cast<unsigned>((r >> 8) * 2048 + c * kHyp * 256 + (r & 255));
  const sweep::Pool pool{reinterpret_cast<const float*>(s_pts), s_w};
  float msac[kHyp], count[kHyp];
  int packed[kHyp];
  sweep::eval<rt::Fused, kHyp>(flat0, 256, draws.seed, draws.div,
                               rt::as_int(prep[kVmask]), n_score, prep[kThrSq],
                               pool, msac, count, packed);

  if (full) {
    const long long n_hyp = 8LL * B;
#pragma unroll
    for (int k = 0; k < kHyp; ++k) {
      const long long o = static_cast<long long>(c * kHyp + k) * B + r;
      f_out[o] = sweep::rescale(msac[k], inv_s2);
      f_out[n_hyp + o] = count[k];
      i_out[o] = packed[k];
    }
    return;
  }
  records::Record rec = records::reduce_k<kHyp>(msac, count, packed, msac, count,
                                                packed, sweep::kInvalid, 1 << 30);
  if (c == 0) {
    rec.msac_m = sweep::rescale(rec.msac_m, inv_s2);
    rec.msac_c = sweep::rescale(rec.msac_c, inv_s2);
    records::write(rec, r, B, f_out, i_out);
  }
}

}  // namespace

// C entry point, bound with ctypes.  src/dst [n_score, 2] and mask
// [n_score] are the caller's raw points; prep is a device buffer of
// kPrepFloats = 83 floats (16-byte aligned); n_hyp must be a positive
// multiple of 2048.  Launches both kernels on `stream` (PyTorch's current
// stream), does not synchronise, and returns cudaGetLastError().
extern "C" int sweep_launch(const float* src, const float* dst,
                            const float* mask, float threshold, unsigned s0,
                            unsigned s1, unsigned s2, unsigned s3,
                            int n_points, int n_score, int n_hyp, int full,
                            float* prep, float* f_out, int* i_out,
                            void* stream) {
  static_assert(kPrepFloats == 83, "ops/sweep.py PREP_FLOATS");
  if (n_hyp <= 0 || n_hyp % 2048 != 0 || n_points < 4 || n_points > n_score ||
      n_score > kM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Draws draws{{s0, s1, s2, s3}, {}};
  for (int j = 0; j < 4; ++j) draws.div[j] = rt::make_divider(n_points - j);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sweep_prep_kernel<<<1, 64, 0, st>>>(src, dst, mask, threshold, n_points,
                                      n_score, prep);
  sweep_kernel<<<n_hyp / kHyp / kThreads, kThreads, 0, st>>>(
      prep, draws, n_score, n_hyp / 8, full, f_out, i_out);
  return static_cast<int>(cudaGetLastError());
}
