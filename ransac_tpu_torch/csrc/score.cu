// Fused RANSAC scoring kernels for Hopper (sm_90a): per-model inlier count
// and truncated MSAC over at most 16 correspondences.
//
// Replaces the Pallas TPU kernels `homography_scores` and `pnp_scores`
// (ransac_tpu/ops/pallas/score.py, kernel bodies `_h_score_kernel` and
// `_pnp_score_kernel`).  Models are read in their public layouts ([H, 9]
// homographies, [H, 12] poses R|t), not the TPU's transposed [16, H]
// padding.  Homographies divide by w with the |w| < 1e-12 guard; poses score
// points with z <= 1e-6 as e^2 = 1e12 (behind the camera).
//
// homography_scores_kernel (row 3).  What bounds it on this card: device
// memory, 36 bytes read and 8 written a model (11.5 MB at 2^18 models, 3.4
// us at 3.35 TB/s), with ~17 operations a point beside it.  So the design
// keeps the memory system busy and the arithmetic short:
// - persistent blocks (as many as fit on the card) walk the tiles of 256
//   models; each tile (9216 bytes) is staged into shared memory with
//   coalesced 16-byte cp.async copies, double-buffered, so the next tile's
//   load overlaps the current tile's scoring;
// - each thread reads its model's 9 floats from shared memory (a stride of 9
//   words is free of bank conflicts) and scores the n real points only, each
//   one broadcast 16-byte load (x, y, px, py) and its weight (score.cuh);
// - the block prologue reads the caller's raw src, dst [n, 2] and mask [n],
//   zero-filled past n, so a call is one launch with no padding on the host;
// - the score is `Fused` (fp32_rn.cuh): each product-sum one FFMA, MUFU's
//   reciprocal of w.  With every operation rounded on its own (`Exact`, an
//   IEEE division a point) the same kernel took 8.7 us at 2^18 models on
//   an H100, above twice its bound.
// pnp_scores_kernel (row 4): one thread a pose, its 12 floats read from
// device memory, the 16 padded points from shared memory.
//
// Rounding: pnp_scores_kernel rounds every operation on its own, in the
// order of the plain PyTorch version (`ransac_tpu_torch.ops.score`), so the
// two agree bit for bit.  homography_scores_kernel agrees with its plain
// version in its decisions: counts equal but where points at the inlier cut
// explain a flip, MSAC within 1e-4 relative on >= 99% of the models and
// 1e-3 on all (`ops.score.hold`, held on the card by chip_smoke.py); its
// header under `Exact` is the plain version's arithmetic bit for bit (host
// build).

#include <cuda_runtime.h>

#include <stdint.h>

#include "fp32_rn.cuh"
#include "score.cuh"

namespace {

using HScore = rt::Fused;          // the homography score's arithmetic policy
constexpr int kThreads = 256;      // models a tile: one a thread
constexpr int kTileFloats = 9 * kThreads;
constexpr int kMaxPoints = score::kMaxPoints;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// Start copying tile `tile` of models [H, 9] (16-byte aligned) into `dst`:
// the tile's 16-byte chunks, then the floats of a ragged last tile past its
// last whole chunk.  Every thread of the block issues its share and commits
// one group.
__device__ __forceinline__ void stage_tile(float* dst, const float* models,
                                           int tile, int H) {
  const float* src = models + static_cast<long long>(tile) * kTileFloats;
  const int floats = min(kThreads, H - tile * kThreads) * 9;
  const int chunks = floats >> 2;
  for (int c = threadIdx.x; c < chunks; c += kThreads)
    cp_async16(dst + 4 * c, src + 4 * c);
  for (int f = 4 * chunks + threadIdx.x; f < floats; f += kThreads)
    cp_async4(dst + f, src + f);
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
homography_scores_kernel(const float* __restrict__ models,  // [H, 9]
                         const float* __restrict__ src,     // [n, 2]
                         const float* __restrict__ dst,     // [n, 2]
                         const float* __restrict__ mask,    // [n]
                         float thr_sq, int n, int H,
                         float* __restrict__ out_count,     // [H]
                         float* __restrict__ out_msac) {    // [H]
  __shared__ __align__(16) float s_models[2][kTileFloats];
  __shared__ float4 s_pts[kMaxPoints];
  __shared__ float s_w[kMaxPoints];
  const int tid = threadIdx.x;
  const int n_tiles = (H + kThreads - 1) / kThreads;
  int tile = blockIdx.x;  // < n_tiles: the grid is at most n_tiles blocks
  stage_tile(s_models[0], models, tile, H);
  commit_group();
  if (tid < kMaxPoints) {
    const bool in = tid < n;
    s_pts[tid] = in ? make_float4(src[2 * tid], src[2 * tid + 1], dst[2 * tid],
                                  dst[2 * tid + 1])
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s_w[tid] = in ? mask[tid] : 0.0f;
  }
  const sweep::Pool pool{reinterpret_cast<const float*>(s_pts), s_w};
  for (int b = 0; tile < n_tiles; tile += gridDim.x, b ^= 1) {
    const int next = tile + gridDim.x;
    if (next < n_tiles) stage_tile(s_models[b ^ 1], models, next, H);
    commit_group();
    wait_all_but_one();  // this tile's copies have landed
    __syncthreads();
    const long long h = static_cast<long long>(tile) * kThreads + tid;
    if (h < H) {
      float m[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) m[k] = s_models[b][9 * tid + k];
      float count, msac;
      score::homography<HScore>(m, pool, n, thr_sq, &count, &msac);
      out_count[h] = count;
      out_msac[h] = msac;
    }
    __syncthreads();  // buffer b is refilled two tiles on
  }
}

// The blocks of the persistent grid: as many as fit on the card at once.
int resident_blocks() {
  static int device = -1, blocks = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != device) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, homography_scores_kernel,
                                                  kThreads, 0);
    blocks = sms * per_sm > 0 ? sms * per_sm : 1;
    device = dev;
  }
  return blocks;
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
// homography_scores_launch: models [H, 9] 16-byte aligned; src, dst [n, 2]
// and mask [n] the caller's raw points, n <= 16.
extern "C" int homography_scores_launch(const float* models, const float* src,
                                        const float* dst, const float* mask,
                                        float thr_sq, int n, int H,
                                        float* out_count, float* out_msac,
                                        void* stream) {
  if (n < 0 || n > kMaxPoints || reinterpret_cast<uintptr_t>(models) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (H > 0) {
    const int n_tiles = (H + kThreads - 1) / kThreads;
    const int resident = resident_blocks();
    const int grid = n_tiles < resident ? n_tiles : resident;
    homography_scores_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        models, src, dst, mask, thr_sq, n, H, out_count, out_msac);
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
