// Fused RANSAC scoring kernels for Hopper (sm_90a): per-model inlier count
// and truncated MSAC over at most 16 correspondences.
//
// Replaces the Pallas TPU kernels `homography_scores` and `pnp_scores`
// (ransac_tpu/ops/pallas/score.py, kernel bodies `_h_score_kernel` and
// `_pnp_score_kernel`).  One thread per model reads its model row-major
// ([H, 9] homographies, [H, 12] poses R|t: the public layouts, not the
// TPU's transposed [16, H] padding), loops the 16 padded points from shared
// memory (padding has mask 0) and writes (count, msac).  Homographies divide
// by w with the |w| < 1e-12 guard; poses score points with z <= 1e-6 as
// e^2 = 1e12 (behind the camera).
//
// What bounds it on this card: device memory, 36 or 48 bytes read and 8
// written per model, against ~14 or ~22 operations per point; at 2^20 models
// about 46-59 MB moved.  The model reads are strided by 9 or 12 floats
// (L1/L2 absorb most of it); staging the rows through shared memory for
// coalesced loads is later work.
//
// Rounding: every operation is rounded on its own (__f*_rn, no FMA), in the
// order of the plain PyTorch versions (`ransac_tpu_torch.ops.score`), so the
// two agree bit for bit on the same inputs.

#include <cuda_runtime.h>

#include "fp32_rn.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPoints = 16;

__global__ void __launch_bounds__(kThreads)
homography_scores_kernel(const float* __restrict__ models,  // [H, 9]
                         const float* __restrict__ src,     // [16, 2]
                         const float* __restrict__ dst,     // [16, 2]
                         const float* __restrict__ mask,    // [16]
                         float thr_sq, int H,
                         float* __restrict__ out_count,     // [H]
                         float* __restrict__ out_msac) {    // [H]
  using namespace rt;
  __shared__ float s_x[kMaxPoints], s_y[kMaxPoints];
  __shared__ float s_px[kMaxPoints], s_py[kMaxPoints], s_w[kMaxPoints];
  const int tid = threadIdx.x;
  if (tid < kMaxPoints) {
    s_x[tid] = src[2 * tid];
    s_y[tid] = src[2 * tid + 1];
    s_px[tid] = dst[2 * tid];
    s_py[tid] = dst[2 * tid + 1];
    s_w[tid] = mask[tid];
  }
  __syncthreads();
  const long long h = static_cast<long long>(blockIdx.x) * kThreads + tid;
  if (h >= H) return;
  float m[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k] = models[h * 9 + k];
  float count = 0.0f, msac = 0.0f;
#pragma unroll
  for (int n = 0; n < kMaxPoints; ++n) {
    const float x = s_x[n], y = s_y[n];
    const float u = add(add(mul(m[0], x), mul(m[1], y)), m[2]);
    const float v = add(add(mul(m[3], x), mul(m[4], y)), m[5]);
    const float w = add(add(mul(m[6], x), mul(m[7], y)), m[8]);
    const float inv_w = rcp(fabsf(w) < 1e-12f ? 1e-12f : w);
    const float du = sub(mul(u, inv_w), s_px[n]);
    const float dv = sub(mul(v, inv_w), s_py[n]);
    const float e2 = add(mul(du, du), mul(dv, dv));
    count = add(count, mul(e2 <= thr_sq ? 1.0f : 0.0f, s_w[n]));
    msac = add(msac, mul(min_nan(e2, thr_sq), s_w[n]));
  }
  out_count[h] = count;
  out_msac[h] = msac;
}

__global__ void __launch_bounds__(kThreads)
pnp_scores_kernel(const float* __restrict__ models,  // [H, 12] R row-major, t
                  const float* __restrict__ X,       // [16, 3]
                  const float* __restrict__ pix,     // [16, 2] normalized
                  const float* __restrict__ mask,    // [16]
                  float thr_sq, int H,
                  float* __restrict__ out_count,     // [H]
                  float* __restrict__ out_msac) {    // [H]
  using namespace rt;
  __shared__ float s_X[kMaxPoints], s_Y[kMaxPoints], s_Z[kMaxPoints];
  __shared__ float s_px[kMaxPoints], s_py[kMaxPoints], s_w[kMaxPoints];
  const int tid = threadIdx.x;
  if (tid < kMaxPoints) {
    s_X[tid] = X[3 * tid];
    s_Y[tid] = X[3 * tid + 1];
    s_Z[tid] = X[3 * tid + 2];
    s_px[tid] = pix[2 * tid];
    s_py[tid] = pix[2 * tid + 1];
    s_w[tid] = mask[tid];
  }
  __syncthreads();
  const long long h = static_cast<long long>(blockIdx.x) * kThreads + tid;
  if (h >= H) return;
  float m[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) m[k] = models[h * 12 + k];
  float count = 0.0f, msac = 0.0f;
#pragma unroll
  for (int n = 0; n < kMaxPoints; ++n) {
    const float Xn = s_X[n], Yn = s_Y[n], Zn = s_Z[n];
    const float xc = add(add(add(mul(m[0], Xn), mul(m[1], Yn)), mul(m[2], Zn)), m[9]);
    const float yc = add(add(add(mul(m[3], Xn), mul(m[4], Yn)), mul(m[5], Zn)), m[10]);
    const float zc = add(add(add(mul(m[6], Xn), mul(m[7], Yn)), mul(m[8], Zn)), m[11]);
    const bool behind = zc <= 1e-6f;
    const float inv_z = rcp(behind ? 1.0f : zc);
    const float du = sub(mul(xc, inv_z), s_px[n]);
    const float dv = sub(mul(yc, inv_z), s_py[n]);
    const float e2 = behind ? 1e12f : add(mul(du, du), mul(dv, dv));
    count = add(count, mul(e2 <= thr_sq ? 1.0f : 0.0f, s_w[n]));
    msac = add(msac, mul(min_nan(e2, thr_sq), s_w[n]));
  }
  out_count[h] = count;
  out_msac[h] = msac;
}

}  // namespace

// C entry points, bound with ctypes.  Launch on `stream` (PyTorch's current
// stream), do not synchronise, and return cudaGetLastError().
extern "C" int homography_scores_launch(const float* models, const float* src,
                                        const float* dst, const float* mask,
                                        float thr_sq, int H, float* out_count,
                                        float* out_msac, void* stream) {
  if (H > 0) {
    homography_scores_kernel<<<(H + kThreads - 1) / kThreads, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        models, src, dst, mask, thr_sq, H, out_count, out_msac);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pnp_scores_launch(const float* models, const float* X,
                                 const float* pix, const float* mask,
                                 float thr_sq, int H, float* out_count,
                                 float* out_msac, void* stream) {
  if (H > 0) {
    pnp_scores_kernel<<<(H + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        models, X, pix, mask, thr_sq, H, out_count, out_msac);
  }
  return static_cast<int>(cudaGetLastError());
}
