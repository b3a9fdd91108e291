// Candidate-axis exhaustive homography-RANSAC sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `multi_candidate_sweep` in
// ransac_tpu/ops/pallas/sweep_multi.py (kernel body `_make_kernel`).  It
// computes what that kernel computes, not its TPU block layout: for every
// candidate camera c and every 4-point sample h of a shared sample table,
// the division-free projective-frame (adjugate) homography, the algebraic
// inlier test r2 <= thr^2 w^2 and the truncated MSAC min(r2, thr^2 w^2)/w^2
// over n <= 16 points (sweep_multi.cuh), then one record per candidate: min
// MSAC, ties to the smallest packed sample i0 + 16 i1 + 256 i2 + 4096 i3,
// with its count.
//
// Layout: one block of 256 threads per candidate.  The candidate's plane
// points, the shared (normalized) pixels and the mask live in shared memory;
// thread t takes the samples h = t, t + 256, ..., one at a time, and keeps
// its best record; warp shuffles and then shared memory across the 8 warps
// give the candidate's record.  A thread skips a sample h > 0 that is a
// copy of sample 0 (the table's padding, pipelines/localize.py
// sweep_sample_table: 309 of 1024 at 13 points), which cannot change a
// record: sample 0 itself is scored.  With `full` set every sample's
// (msac, count) is written instead, [C, H], nothing skipped.
//
// What bounds it on this card: the FP32 pipe's issue rate, ~200 operations
// a sample for the two frames and H and ~18 a point (13 at the localize
// shape); the C x H samples read a few bytes each, shared through L2.  The
// design spends the issue slots on that arithmetic: the score takes the
// `Fused` policy of fp32_rn.cuh from the residual on (each product-sum one
// FFMA, the quotient min(r2, t) times MUFU's reciprocal of w^2 where the
// plain version divides, one accumulator pair a sample), and the table's
// padding is skipped.  One sample a thread keeps the exact solve in 126
// registers, two blocks a SM (4 samples a thread took 171, one block a SM,
// and were slower: PERF.md).  The
// frames, H and the projection keep the plain order (`Exact`): the
// candidates' plane points are ill-conditioned, and fused there MSAC moved
// by up to 7% and counts off the inlier cut (host build, PERF.md).
//
// Rounding: the kernel agrees with the plain PyTorch version
// (`ransac_tpu_torch.ops.sweep_multi`, every operation rounded on its own,
// the quotient an IEEE division) in its decisions, not bit for bit: the
// same samples and validity (the solve is exact), a count moved only by
// points at the inlier cut, MSAC within 1e-4 relative
// on >= 99% of samples and 1e-3 on all, each candidate's winner the plain
// one or a near-tie in the kernel's own full records
// (`ops.sweep_multi.hold_full` / `hold_reduced`, held on the card by
// chip_smoke.py).  The `Exact` instantiation of sweep_multi.cuh is the
// plain version bit for bit (host build).

#include <cuda_runtime.h>

#include "sweep_multi.cuh"

namespace {

using Score = rt::Fused;         // the score's policy from the residual on
using Solve = rt::Exact;         // the frames' and H's
using Proj = rt::Exact;          // the projection's
constexpr int kMaxPoints = sweep_multi::kMaxPoints;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Record order: lower MSAC wins; equal MSAC goes to the smaller packed sample.
__device__ __forceinline__ bool better(float m, int p, float best_m, int best_p) {
  return m < best_m || (m == best_m && p < best_p);
}

__global__ void __launch_bounds__(kThreads)
sweep_multi_kernel(const float* __restrict__ src,     // [C, 16, 2]
                   const float* __restrict__ dst,     // [16, 2]
                   const float* __restrict__ mask,    // [16]
                   const float* __restrict__ thr_sq,  // [1]
                   const int* __restrict__ idx,       // [4, H]
                   int H, int n, int full,
                   float* __restrict__ out_msac,      // [C] or [C, H]
                   float* __restrict__ out_count,     // [C] or [C, H]
                   int* __restrict__ out_packed) {    // [C]
  __shared__ float s_pts[5][kMaxPoints];  // sx, sy, dx, dy, w
  __shared__ float r_msac[kWarps], r_count[kWarps];
  __shared__ int r_packed[kWarps];

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < kMaxPoints) {
    s_pts[0][tid] = src[(c * kMaxPoints + tid) * 2];
    s_pts[1][tid] = src[(c * kMaxPoints + tid) * 2 + 1];
    s_pts[2][tid] = dst[tid * 2];
    s_pts[3][tid] = dst[tid * 2 + 1];
    s_pts[4][tid] = mask[tid];
  }
  __syncthreads();
  const float t2 = thr_sq[0];
  const sweep_multi::Points pt{s_pts[0], s_pts[1], s_pts[2], s_pts[3], s_pts[4]};
  const int first[4] = {idx[0], idx[H], idx[2 * H], idx[3 * H]};

  float best_msac = __int_as_float(0x7f800000);  // +inf
  float best_count = -2.0f;
  int best_packed = 1 << 30;
  for (int h = tid; h < H; h += kThreads) {
    int i[4];
    bool copy = h > 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      i[j] = idx[j * H + h];
      copy = copy && i[j] == first[j];
    }
    if (copy && !full) continue;
    float msac, count;
    int packed;
    sweep_multi::eval<Score, Solve, Proj>(i, pt, n, t2, &msac, &count, &packed);
    if (full) {
      out_msac[static_cast<long long>(c) * H + h] = msac;
      out_count[static_cast<long long>(c) * H + h] = count;
    } else if (better(msac, packed, best_msac, best_packed)) {
      best_msac = msac;
      best_count = count;
      best_packed = packed;
    }
  }
  if (full) return;

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_down_sync(0xffffffffu, best_msac, off);
    const float oc = __shfl_down_sync(0xffffffffu, best_count, off);
    const int op = __shfl_down_sync(0xffffffffu, best_packed, off);
    if (better(om, op, best_msac, best_packed)) {
      best_msac = om;
      best_count = oc;
      best_packed = op;
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    r_msac[warp] = best_msac;
    r_count[warp] = best_count;
    r_packed[warp] = best_packed;
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < kWarps; ++k) {
      if (better(r_msac[k], r_packed[k], best_msac, best_packed)) {
        best_msac = r_msac[k];
        best_count = r_count[k];
        best_packed = r_packed[k];
      }
    }
    out_msac[c] = best_msac;
    out_count[c] = best_count;
    out_packed[c] = best_packed;
  }
}

}  // namespace

// C entry point, bound with ctypes.  H a multiple of 256 (the wrapper's
// 1024), 4 <= n <= 16.  `full`: every sample's normalized MSAC
// and count ([C, H]; out_packed unused) instead of each candidate's record.
// Launches on `stream` (PyTorch's current stream), does not synchronise,
// and returns cudaGetLastError() so that a refused launch is reported to
// the caller.
extern "C" int sweep_multi_launch(const float* src, const float* dst,
                                  const float* mask, const float* thr_sq,
                                  const int* idx, int C, int H, int n, int full,
                                  float* out_msac, float* out_count,
                                  int* out_packed, void* stream) {
  if (H <= 0 || H % kThreads != 0 || n < 4 || n > kMaxPoints)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C > 0) {
    sweep_multi_kernel<<<C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        src, dst, mask, thr_sq, idx, H, n, full, out_msac, out_count, out_packed);
  }
  return static_cast<int>(cudaGetLastError());
}
