// Fused homography-RANSAC sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `homography_ransac_sweep`
// (ransac_tpu/ops/pallas/sweep.py, kernel body `_make_kernel`).  Each thread
// is one hypothesis: it draws its 4-point sample from the counter PRNG (no
// random tensor in device memory), solves the projective-frame homography
// and scores every point (sweep.cuh).  The TPU kernel's record layout is
// kept: record r = b * 256 + l covers the flat ids b * 2048 + s * 256 + l,
// s = 0..7, and holds two winners, by min MSAC (ties to the smallest packed
// sample) and by (max count, min MSAC, smallest packed sample).  The eight
// threads of a record are eight neighbouring lanes of a warp and reduce with
// three xor shuffles, exactly as the TPU's sublane reductions select.
// With `full` set every hypothesis writes its own (msac, count, packed) at
// s * B + r instead, B = n_hyp / 8 (the TPU kernel's full-record order).
//
// The entry point takes the caller's raw points.  A one-block kernel first
// normalizes them as the JAX wrapper does (centroid and mean distance of
// src and of dst, on two warps at once) into a small device buffer, and
// the sweep scales MSAC back to pixel^2 units as it writes, so a call is
// two launches from one C call.  (Normalizing in every block's prologue
// instead cost the sweep 17-33% of its device time at 2^22.)
//
// What bounds it on this card: FP32 CUDA-core arithmetic, about
// 150 + 22 n operations per hypothesis with IEEE division (one per point)
// and no FMA, and 24 bytes written per 8 hypotheses.  The points live in
// shared memory.  Making it fast (FMA, approximate reciprocal, more
// hypotheses per thread) is later work.
//
// Rounding: every operation is rounded on its own, in the order of the
// plain PyTorch version (`ransac_tpu_torch.ops.sweep._sweep_plain`), so the
// two agree bit for bit on the same inputs.

#include <cuda_runtime.h>

#include "records.cuh"
#include "sweep.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kM = sweep::kMaxPoints;
// The normalized pool in the prep buffer: x, y of src, x, y of dst, mask
// (kM floats each), then thr^2, 1 / s_dst^2 and the sample bitmask (an int).
constexpr int kThrSq = 5 * kM, kInvS2 = kThrSq + 1, kVmask = kThrSq + 2;
constexpr int kPrepFloats = kVmask + 1;

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
    prep[4 * kM + tid] = in ? mask[tid] : 0.0f;
  }
  __syncthreads();
  if (tid == 0) sweep::norm_params(s_src, n_points, s_par);
  if (tid == 32) sweep::norm_params(s_dst, n_points, s_par + 3);
  __syncthreads();
  if (tid < kM) {
    const bool in = tid < n_score;
    prep[tid] =
        in ? rt::mul(rt::sub(s_src[2 * tid], s_par[0]), s_par[2]) : 0.0f;
    prep[kM + tid] =
        in ? rt::mul(rt::sub(s_src[2 * tid + 1], s_par[1]), s_par[2]) : 0.0f;
    prep[2 * kM + tid] =
        in ? rt::mul(rt::sub(s_dst[2 * tid], s_par[3]), s_par[5]) : 0.0f;
    prep[3 * kM + tid] =
        in ? rt::mul(rt::sub(s_dst[2 * tid + 1], s_par[4]), s_par[5]) : 0.0f;
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
             unsigned s0, unsigned s1, unsigned s2, unsigned s3,
             int n_points, int n_score, int B, int full,
             float* __restrict__ f_out,         // [4, B] or [2, 8B]
             int* __restrict__ i_out) {         // [2, B] or [8B]
  __shared__ float s_pool[5 * kM];
  const int tid = threadIdx.x;
  if (tid < 5 * kM) s_pool[tid] = prep[tid];
  __syncthreads();
  const float inv_s2 = prep[kInvS2];

  const int g = blockIdx.x * kThreads + tid;
  const int r = g >> 3, s = g & 7;
  const unsigned flat =
      static_cast<unsigned>((r >> 8) * 2048 + s * 256 + (r & 255));
  const unsigned seeds[4] = {s0, s1, s2, s3};
  const sweep::Pool pool{s_pool, s_pool + kM, s_pool + 2 * kM, s_pool + 3 * kM,
                         s_pool + 4 * kM};
  float msac, count;
  int packed;
  sweep::eval(flat, seeds, rt::as_int(prep[kVmask]),
              n_points, n_score, prep[kThrSq], pool, &msac, &count, &packed);

  if (full) {
    const long long n_hyp = 8LL * B;
    const long long o = static_cast<long long>(s) * B + r;
    f_out[o] = sweep::rescale(msac, inv_s2);
    f_out[n_hyp + o] = count;
    i_out[o] = packed;
    return;
  }
  records::Record rec = records::reduce(msac, count, packed, msac, count,
                                        packed, sweep::kInvalid);
  if (s == 0) {
    rec.msac_m = sweep::rescale(rec.msac_m, inv_s2);
    rec.msac_c = sweep::rescale(rec.msac_c, inv_s2);
    records::write(rec, r, B, f_out, i_out);
  }
}

}  // namespace

// C entry point, bound with ctypes.  src/dst [n_score, 2] and mask
// [n_score] are the caller's raw points; prep is a device buffer of
// kPrepFloats = 83 floats; n_hyp must be a positive multiple of 2048.
// Launches both kernels on `stream` (PyTorch's current stream), does not
// synchronise, and returns cudaGetLastError().
extern "C" int sweep_launch(const float* src, const float* dst,
                            const float* mask, float threshold, unsigned s0,
                            unsigned s1, unsigned s2, unsigned s3,
                            int n_points, int n_score, int n_hyp, int full,
                            float* prep, float* f_out, int* i_out,
                            void* stream) {
  static_assert(kPrepFloats == 83, "ops/sweep.py PREP_FLOATS");
  if (n_hyp <= 0 || n_hyp % 2048 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sweep_prep_kernel<<<1, 64, 0, st>>>(src, dst, mask, threshold, n_points,
                                      n_score, prep);
  sweep_kernel<<<n_hyp / kThreads, kThreads, 0, st>>>(
      prep, s0, s1, s2, s3, n_points, n_score, n_hyp / 8, full, f_out, i_out);
  return static_cast<int>(cudaGetLastError());
}
