// Batched Levenberg-Marquardt for Hopper (sm_90a): `refine_pose` (6
// parameters), every pass of every problem in one launch.  The homography
// LM of lm.cuh runs inside the fused homography refit (refit.cu), its one
// caller on the card.
//
// Replaces no TPU kernel: the JAX package's LM (ransac_tpu/ops/lm.py) is
// plain JAX under jit, one compiled program.  Its port, the plain loop
// `ransac_tpu_torch.ops.lm.levenberg_marquardt`, launches ~490 device
// kernels a pass of one pose under vmap(jacfwd), one by one from the host,
// while the work is a few kFLOP a pass.  What bounds the kernel on this
// card is neither memory nor arithmetic but the serial chain of one
// problem's passes: each pass is a reduction over the points, a 6 x 6
// elimination and a second reduction, one after another, ~10 of them.  So
// the design keeps a problem in one warp's registers from start to end:
// - one warp a problem, 4 a block; lanes take points l, l + 32, ..., so any
//   number of points works;
// - each lane accumulates its points' share of g (n values), the upper
//   triangle of J^T J (n (n + 1) / 2) and the cost in registers, the
//   Jacobian by forward-mode tangents (lm.cuh); a __shfl_xor_sync butterfly
//   leaves every lane with the same sums, so every lane solves the same n x
//   n step (no broadcast, no divergence) and takes the trial cost at
//   x + dx with a second pass over its points;
// - the warp runs at most max_iters passes and leaves once its problem is
//   done; lane 0 writes x, the cost, the passes run and done.
// Nothing is read back to the host and nothing is allocated.
//
// Rounding: every operation rounds on its own (no FMA, IEEE division), as
// the plain loop's tensor ops do; the sums add in the lanes' order, not
// torch's, so the kernel agrees with the plain loop to float32 rounding
// along the trajectory (tests/test_torch_lm_kernel.py states the limits).

#include <cuda_runtime.h>

#include "lm.cuh"

namespace {

constexpr int kWarps = 4;  // problems a block
constexpr int kThreads = kWarps * lm::kLanes;

__global__ void __launch_bounds__(kThreads)
lm_pose_kernel(const float* __restrict__ rvec0, long long r_stride,  // [B, 3]
               const float* __restrict__ tvec0, long long t_stride,  // [B, 3]
               const float* __restrict__ X, long long X_stride,      // [B, n, 3]
               const float* __restrict__ pix, long long pix_stride,  // [B, n, 2]
               const float* __restrict__ K, long long K_stride,      // [B, 3, 3]
               const float* __restrict__ w, long long w_stride,      // [B, n]
               int B, int n, int max_iters,
               float* __restrict__ x_out,                // [B, 6]
               float* __restrict__ cost_out,             // [B]
               long long* __restrict__ iterations_out,   // [B]
               bool* __restrict__ converged_out) {       // [B]
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / lm::kLanes;
  if (b >= B) return;
  const lm::Pose m{X + b * X_stride, pix + b * pix_stride, K + b * K_stride, w + b * w_stride, n};
  float x[6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x[k] = rvec0[b * r_stride + k];
    x[3 + k] = tvec0[b * t_stride + k];
  }
  const lm::State s = lm::run(m, x, max_iters, lm::WarpLanes{static_cast<int>(threadIdx.x % lm::kLanes)});
  if (threadIdx.x % lm::kLanes == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) x_out[6 * b + k] = x[k];
    cost_out[b] = s.cost;
    iterations_out[b] = s.iterations;
    converged_out[b] = s.done;
  }
}

int blocks_of(int B) { return (B + kWarps - 1) / kWarps; }

}  // namespace

// C entry points, bound with ctypes.  Launch on `stream` (PyTorch's current
// stream), do not synchronise, and return cudaGetLastError().  Each input is
// [B, ...] with its items' entries contiguous and `*_stride` floats between
// items (0 for an input shared by every item); the outputs are contiguous.
extern "C" int lm_pose_launch(const float* rvec0, long long r_stride,
                              const float* tvec0, long long t_stride,
                              const float* X, long long X_stride,
                              const float* pix, long long pix_stride,
                              const float* K, long long K_stride,
                              const float* w, long long w_stride,
                              int B, int n, int max_iters, float* x_out,
                              float* cost_out, long long* iterations_out,
                              bool* converged_out, void* stream) {
  if (B < 0 || n < 0 || max_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0)
    lm_pose_kernel<<<blocks_of(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        rvec0, r_stride, tvec0, t_stride, X, X_stride, pix, pix_stride, K, K_stride,
        w, w_stride, B, n, max_iters, x_out, cost_out, iterations_out, converged_out);
  return static_cast<int>(cudaGetLastError());
}
