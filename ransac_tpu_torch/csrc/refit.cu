// The engines' two refits for Hopper (sm_90a), each one launch from its
// inputs to its result: `models.ransac.refit_homography` (weighted DLT seed,
// homography LM, fallback) and `models.ransac._pnp_refit` (DLT-PnP and EPnP
// seeds, truncated MSAC among them and the RANSAC winner, pose LM,
// fallback).
//
// Replaces no TPU kernel: the JAX package's refits are plain JAX under jit.
// Their plain port runs each seed one small torch op at a time from the
// host: ~2,500 device kernels for the 458-candidate weighted DLT and ~4,500
// for the PnP seeds (with a host wait for `torch.linalg.eigh`), ~7,000 of
// an engine localization's ~8,600, while the work is a few MFLOP.  What
// bounds the kernels is the serial chain of one problem's steps (two
// reductions over the points, 8 eliminations of 9 x 9 or 12 x 12, the LM's
// passes), so each problem stays in one warp from start to end, as in
// csrc/lm.cu:
// - one warp a problem; lanes take points l, l + 32, ..., so any number of
//   points works, and a __shfl_xor_sync butterfly leaves every lane with the
//   same sums (lm::WarpLanes), so every lane runs the same small dense
//   steps (the eliminations, the 3 x 3 eigensolvers) in its registers;
// - the homography refit: 4 problems a block, the 458 candidates of a
//   localization in 115 blocks;
// - the pose refit: one warp, EPnP's 12 x 12 eigensolver in shared memory,
//   row r of each Jacobi rotation updated by lane r.
// Nothing is read back to the host and nothing is allocated; the threshold
// and fy / fx of the pose refit are read on the card where the caller has
// them there.
//
// Rounding: every operation rounds on its own (no FMA, IEEE division and
// square root) in the plain versions' order, the sums in the lanes'
// (refit_seed.cuh; tests/test_torch_refit_kernel.py states the limits).

#include <cuda_runtime.h>

#include "refit_seed.cuh"

namespace {

constexpr int kWarps = 4;  // homography problems a block
constexpr int kThreads = kWarps * lm::kLanes;

__global__ void __launch_bounds__(kThreads)
refit_homography_kernel(const float* __restrict__ H_best, long long hb_stride,  // [B, 9]
                        const float* __restrict__ src, long long src_stride,    // [B, n, 2]
                        const float* __restrict__ dst, long long dst_stride,    // [B, n, 2]
                        const bool* __restrict__ inl, long long inl_stride,     // [B, n]
                        int B, int n, int max_iters,
                        float* __restrict__ H_out) {                            // [B, 9]
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / lm::kLanes;
  if (b >= B) return;  // the whole warp
  const int lane = static_cast<int>(threadIdx.x % lm::kLanes);
  const seed::HomographyProblem p{src + b * src_stride, dst + b * dst_stride,
                                  inl + b * inl_stride, n};
  float H[9];
  seed::refit_homography(p, H_best + b * hb_stride, max_iters, lm::WarpLanes{lane}, H);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) H_out[9 * b + k] = H[k];
  }
}

__global__ void __launch_bounds__(lm::kLanes)
refit_pose_kernel(const float* __restrict__ model_best,  // [12]
                  const float* __restrict__ X,           // [n, 3]
                  const float* __restrict__ pix,         // [n, 2]
                  const float* __restrict__ pix_n,       // [n, 2]
                  const float* __restrict__ K,           // [3, 3]
                  const bool* __restrict__ inl,          // [n]
                  const float* __restrict__ mask,        // [n]
                  float thr_n, const float* __restrict__ thr_n_ptr,
                  float ay, const float* __restrict__ ay_ptr,
                  int n, int max_iters,
                  float* __restrict__ out) {             // [12]
  __shared__ float A[144], V[144];
  const int lane = static_cast<int>(threadIdx.x);
  const seed::PoseProblem p{X, pix, pix_n, K, inl, mask,
                            thr_n_ptr ? *thr_n_ptr : thr_n, ay_ptr ? *ay_ptr : ay, n};
  float model[12];
  seed::refit_pose(p, model_best, max_iters, A, V, lm::WarpLanes{lane}, model, nullptr);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 12; ++k) out[k] = model[k];
  }
}

}  // namespace

// C entry points, bound with ctypes.  Launch on `stream` (PyTorch's current
// stream), do not synchronise, and return cudaGetLastError().
// refit_homography_launch: each input is [B, ...] with its items' entries
// contiguous and `*_stride` elements between items (0 for an input shared by
// every item); H_out [B, 3, 3] is contiguous.
extern "C" int refit_homography_launch(const float* H_best, long long hb_stride,
                                       const float* src, long long src_stride,
                                       const float* dst, long long dst_stride,
                                       const bool* inl, long long inl_stride,
                                       int B, int n, int max_iters, float* H_out,
                                       void* stream) {
  if (B < 0 || n < 0 || max_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0)
    refit_homography_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        H_best, hb_stride, src, src_stride, dst, dst_stride, inl, inl_stride, B, n, max_iters,
        H_out);
  return static_cast<int>(cudaGetLastError());
}

// refit_pose_launch: one problem, every input contiguous; thr_n and ay by
// value, or through a pointer that, where not null, stands in for it.
extern "C" int refit_pose_launch(const float* model_best, const float* X, const float* pix,
                                 const float* pix_n, const float* K, const bool* inl,
                                 const float* mask, float thr_n, const float* thr_n_ptr,
                                 float ay, const float* ay_ptr, int n, int max_iters,
                                 float* out, void* stream) {
  if (n < 0 || max_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  refit_pose_kernel<<<1, lm::kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      model_best, X, pix, pix_n, K, inl, mask, thr_n, thr_n_ptr, ay, ay_ptr, n, max_iters, out);
  return static_cast<int>(cudaGetLastError());
}
