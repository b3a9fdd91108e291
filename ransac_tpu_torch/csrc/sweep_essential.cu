// <= 16-point 8-point essential-matrix RANSAC sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `essential_ransac_sweep`
// (ransac_tpu/ops/pallas/sweep_essential.py, kernel body `_make_kernel`).
// Each thread is one hypothesis (sweep_essential.cuh): its 8-point sample
// from the counter PRNG (no random tensor in device memory), the
// canonical-frame F and the Sampson score of every point.  The TPU kernel's
// record layout is kept: with LAN = block_h / 8, record r = b * LAN + l
// covers the flat ids b * block_h + s * LAN + l, s = 0..7, and holds two
// winners, by min MSAC and by (max count, min MSAC); ties go to the
// smallest packed sample as an UNSIGNED number (records.cuh
// reduce_unsigned: the eight 4-bit indices use the sign bit).  The eight
// threads of a record are eight neighbouring lanes and reduce with xor
// shuffles.  With `full` set every hypothesis writes its own (msac, count,
// packed) at s * B + r instead, B = n_hyp / 8 (the TPU's full-record order).
//
// A call is two launches from one C call: a one-warp prep kernel does the
// JAX wrapper's XLA work (sweep_essential.py:331-346: one shared scale over
// both images, the scaled squared threshold, the sample bitmask) into a
// small device buffer, then the sweep, which scales MSAC back by 1 / s^2 as
// it writes.
//
// What bounds it on this card: FP32 CUDA-core arithmetic, about 650
// operations per hypothesis (8 counter draws and the canonical solve) and 40
// per point with one IEEE division, and 24 bytes written per 8 hypotheses.
// The points live in shared memory.  Making it fast is later work.
//
// Rounding: every operation is rounded on its own, in the order of the plain
// PyTorch version (`ransac_tpu_torch.ops.sweep_essential`), so the two agree
// bit for bit on the same inputs (rsqrt is rsqrtf, torch.rsqrt on the card).

#include <cuda_runtime.h>

#include "records.cuh"
#include "sweep_essential.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kM = sweep_essential::kMaxPoints;
// The prep buffer: x, y of image 1, x, y of image 2, mask (kM floats each),
// then thr^2 * s^2, 1 / s^2 and the sample bitmask (an int).
constexpr int kThrSq = 5 * kM, kInvS2 = kThrSq + 1, kVmask = kThrSq + 2;
constexpr int kPrepFloats = kVmask + 1;

// The 8 draw seeds, passed by value.
struct Seeds {
  unsigned s[8];
};

__global__ void __launch_bounds__(32)
sweep_essential_prep_kernel(const float* __restrict__ x1,   // [n, 2] raw
                            const float* __restrict__ x2,   // [n, 2] raw
                            const float* __restrict__ mask, // [n]
                            float threshold_sq, int n_points, int n_score,
                            float* __restrict__ prep) {     // [kPrepFloats]
  using namespace rt;
  __shared__ float s_par[5];  // m1 (2), m2 (2), s
  const int tid = threadIdx.x;
  if (tid == 0) sweep_essential::norm_params(x1, x2, n_points, s_par);
  __syncthreads();
  const float s = s_par[4];
  if (tid < kM) {
    const bool in = tid < n_score;
    prep[tid] = in ? mul(sub(x1[2 * tid], s_par[0]), s) : 0.0f;
    prep[kM + tid] = in ? mul(sub(x1[2 * tid + 1], s_par[1]), s) : 0.0f;
    prep[2 * kM + tid] = in ? mul(sub(x2[2 * tid], s_par[2]), s) : 0.0f;
    prep[3 * kM + tid] = in ? mul(sub(x2[2 * tid + 1], s_par[3]), s) : 0.0f;
    prep[4 * kM + tid] = in ? mask[tid] : 0.0f;
  }
  if (tid == 0) {
    prep[kThrSq] = mul(mul(threshold_sq, s), s);
    prep[kInvS2] = rcp(mul(s, s));
    prep[kVmask] = as_float(sweep::sample_bitmask(mask, n_score));
  }
}

__global__ void __launch_bounds__(kThreads)
sweep_essential_kernel(const float* __restrict__ prep,  // normalized pool
                       Seeds seeds, int n_points, int n_score, int lan,
                       int n_hyp, int full,
                       float* __restrict__ f_out,       // [4, B] or [2, n_hyp]
                       int* __restrict__ i_out) {       // [2, B] or [n_hyp]
  __shared__ float s_pool[5 * kM];
  const int tid = threadIdx.x;
  if (tid < 5 * kM) s_pool[tid] = prep[tid];
  __syncthreads();
  const float inv_s2 = prep[kInvS2];

  // Threads past n_hyp (the last block of a block_h that is not a multiple
  // of 256) evaluate a hypothesis too, for the shuffles, and write nothing.
  const int g = blockIdx.x * kThreads + tid;
  const int r = g >> 3, s = g & 7, B = n_hyp / 8;
  const unsigned flat = static_cast<unsigned>((r / lan) * 8 * lan + s * lan + r % lan);
  const sweep::Pool pool{s_pool, s_pool + kM, s_pool + 2 * kM, s_pool + 3 * kM,
                         s_pool + 4 * kM};
  float msac, count;
  int packed;
  sweep_essential::eval(flat, seeds.s, rt::as_int(prep[kVmask]), n_points,
                        n_score, prep[kThrSq], pool, &msac, &count, &packed);

  if (full) {
    if (g < n_hyp) {
      const long long o = static_cast<long long>(s) * B + r;
      f_out[o] = sweep::rescale(msac, inv_s2);
      f_out[n_hyp + o] = count;
      i_out[o] = packed;
    }
    return;
  }
  records::Record rec = records::reduce_unsigned(msac, count, packed, msac,
                                                 count, packed, sweep::kInvalid);
  if (s == 0 && r < B) {
    rec.msac_m = sweep::rescale(rec.msac_m, inv_s2);
    rec.msac_c = sweep::rescale(rec.msac_c, inv_s2);
    records::write(rec, r, B, f_out, i_out);
  }
}

}  // namespace

// C entry point, bound with ctypes.  x1/x2 [n_score, 2] and mask [n_score]
// are the caller's raw points, 8 <= n_points <= n_score <= 16; s0-s7 the
// draw seeds; block_h a positive multiple of 8 that divides n_hyp; prep a
// device buffer of kPrepFloats = 83 floats.  Launches both kernels on
// `stream` (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError().
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Seeds seeds{{s0, s1, s2, s3, s4, s5, s6, s7}};
  sweep_essential_prep_kernel<<<1, 32, 0, st>>>(x1, x2, mask, threshold_sq,
                                                n_points, n_score, prep);
  sweep_essential_kernel<<<(n_hyp + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      prep, seeds, n_points, n_score, block_h / 8, n_hyp, full, f_out, i_out);
  return static_cast<int>(cudaGetLastError());
}
