// Fused RANSAC scoring kernels for Hopper (sm_90a): per-model inlier count
// and truncated MSAC over at most 16 correspondences.
//
// Replaces the Pallas TPU kernels `homography_scores` and `pnp_scores`
// (ransac_tpu/ops/pallas/score.py, kernel bodies `_h_score_kernel` and
// `_pnp_score_kernel`).  Models are read in their public layouts ([H, 9]
// homographies, [H, 12] poses R|t), not the TPU's transposed [16, H]
// padding.  Homographies divide by w with the |w| < 1e-12 guard; poses score
// points with z <= 1e-6 as e^2 = 1e12 (behind the camera).  Both score the
// n real points and the TPU's zero padding row (score.cuh).
//
// What bounds both on this card: device memory.  Row 3 reads 36 bytes and
// writes 8 a model (11.5 MB at 2^18 models, 3.4 us at 3.35 TB/s), row 4 48
// and 8 a pose (58.7 MB at 2^20 poses, 17.5 us), with ~17 and ~21
// operations a point beside them.  So one design keeps the memory system
// busy and the arithmetic short:
// - persistent blocks (as many as fit on the card) walk the tiles of 256
//   models; each tile (9216 or 12288 bytes) is staged into shared memory
//   with coalesced 16-byte cp.async copies, double-buffered, so the next
//   tile's load overlaps the current tile's scoring (`score_tiles`);
// - each thread reads its model from shared memory: a homography as 9
//   words (a stride of 9 words is free of bank conflicts), a pose as three
//   16-byte loads (at a stride of 12 words the 8 threads of each 128-byte
//   phase fall on disjoint banks); each point is a broadcast load;
// - the block prologue reads the caller's raw points and mask [n],
//   zero-filled past n, so a call is one launch with no padding on the host;
// - the score is `Fused` (fp32_rn.cuh): each product-sum one FFMA, MUFU's
//   reciprocal of w or z; a pose's camera point keeps the plain order.
//   With every operation rounded on its own (`Exact`, an IEEE division a
//   point), row 3 took 8.7 us at 2^18 models on an H100, above twice its
//   bound.
//
// Rounding: both kernels agree with their plain versions
// (`ransac_tpu_torch.ops.score`) in their decisions: counts equal but where
// points at the inlier cut explain a flip, MSAC within 1e-4 relative on >=
// 99% of the models and 1e-3 on all, NaN in the same places (`ops.score.hold`
// with `cut_margins` / `pose_cut_margins`, held on the card by
// chip_smoke.py); behind-camera decisions come from the exact camera point.
// Their headers under `Exact` are the plain versions' arithmetic bit for
// bit (host build).

#include <cuda_runtime.h>

#include <stdint.h>

#include "fp32_rn.cuh"
#include "score.cuh"

namespace {

using Policy = rt::Fused;          // the scores' arithmetic policy
constexpr int kThreads = 256;      // models a tile: one a thread
constexpr int kMaxPoints = score::kMaxPoints;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// Start copying tile `tile` of models [H, W] (16-byte aligned) into `dst`:
// the tile's 16-byte chunks, then the floats of a ragged last tile past its
// last whole chunk.  Every thread of the block issues its share; the caller
// commits the group.
template <int W>
__device__ __forceinline__ void stage_tile(float* dst, const float* models,
                                           int tile, int H) {
  const float* src = models + static_cast<long long>(tile) * W * kThreads;
  const int floats = min(kThreads, H - tile * kThreads) * W;
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

// The persistent walk over the tiles of models [H, W], starting at tile
// blockIdx.x, which the caller has staged into tiles[0] and committed:
// stage the block's next tile into the other buffer, wait for this one, and
// score(model in shared memory, &count, &msac) one model a thread.  The
// first barrier also publishes what the caller wrote to shared memory
// before the walk.
template <int W, class Score>
__device__ __forceinline__ void score_tiles(float (*tiles)[W * kThreads],
                                            const float* models, int H,
                                            Score score, float* out_count,
                                            float* out_msac) {
  const int n_tiles = (H + kThreads - 1) / kThreads;
  for (int tile = blockIdx.x, b = 0; tile < n_tiles; tile += gridDim.x, b ^= 1) {
    const int next = tile + gridDim.x;
    if (next < n_tiles) stage_tile<W>(tiles[b ^ 1], models, next, H);
    commit_group();
    wait_all_but_one();  // this tile's copies have landed
    __syncthreads();
    const long long h = static_cast<long long>(tile) * kThreads + threadIdx.x;
    if (h < H) {
      float count, msac;
      score(&tiles[b][W * threadIdx.x], &count, &msac);
      out_count[h] = count;
      out_msac[h] = msac;
    }
    __syncthreads();  // buffer b is refilled two tiles on
  }
}

__global__ void __launch_bounds__(kThreads)
homography_scores_kernel(const float* __restrict__ models,  // [H, 9]
                         const float* __restrict__ src,     // [n, 2]
                         const float* __restrict__ dst,     // [n, 2]
                         const float* __restrict__ mask,    // [n]
                         float thr_sq,
                         const float* __restrict__ thr_sq_p,  // [1] or null
                         int n, int H,
                         float* __restrict__ out_count,     // [H]
                         float* __restrict__ out_msac) {    // [H]
  __shared__ __align__(16) float s_models[2][9 * kThreads];
  __shared__ float4 s_pts[kMaxPoints];
  __shared__ float s_w[kMaxPoints];
  const int tid = threadIdx.x;
  if (thr_sq_p != nullptr) thr_sq = *thr_sq_p;
  stage_tile<9>(s_models[0], models, blockIdx.x, H);  // grid <= n_tiles
  commit_group();
  if (tid < kMaxPoints) {
    const bool in = tid < n;
    s_pts[tid] = in ? make_float4(src[2 * tid], src[2 * tid + 1], dst[2 * tid],
                                  dst[2 * tid + 1])
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s_w[tid] = in ? mask[tid] : 0.0f;
  }
  const sweep::Pool pool{reinterpret_cast<const float*>(s_pts), s_w};
  score_tiles<9>(s_models, models, H,
                 [&](const float* sm, float* count, float* msac) {
                   float m[9];
#pragma unroll
                   for (int k = 0; k < 9; ++k) m[k] = sm[k];
                   score::homography<Policy>(m, pool, n, thr_sq, count, msac);
                 },
                 out_count, out_msac);
}

__global__ void __launch_bounds__(kThreads)
pnp_scores_kernel(const float* __restrict__ models,  // [H, 12] R row-major, t
                  const float* __restrict__ X,       // [n, 3]
                  const float* __restrict__ pix,     // [n, 2] normalized
                  const float* __restrict__ mask,    // [n]
                  float thr_sq,
                  const float* __restrict__ thr_sq_p,  // [1] or null
                  int n, int H,
                  float* __restrict__ out_count,     // [H]
                  float* __restrict__ out_msac) {    // [H]
  __shared__ __align__(16) float s_models[2][12 * kThreads];
  __shared__ float4 s_xyzw[kMaxPoints];
  __shared__ float2 s_pix[kMaxPoints];
  const int tid = threadIdx.x;
  if (thr_sq_p != nullptr) thr_sq = *thr_sq_p;
  stage_tile<12>(s_models[0], models, blockIdx.x, H);  // grid <= n_tiles
  commit_group();
  if (tid < kMaxPoints) {
    const bool in = tid < n;
    s_xyzw[tid] = in ? make_float4(X[3 * tid], X[3 * tid + 1], X[3 * tid + 2],
                                   mask[tid])
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s_pix[tid] = in ? make_float2(pix[2 * tid], pix[2 * tid + 1])
                    : make_float2(0.0f, 0.0f);
  }
  const sweep_pnp::Table pool{reinterpret_cast<const float*>(s_xyzw),
                              reinterpret_cast<const float*>(s_pix)};
  score_tiles<12>(s_models, models, H,
                  [&](const float* sm, float* count, float* msac) {
                    float m[12];
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                      const float4 v = reinterpret_cast<const float4*>(sm)[c];
                      m[4 * c] = v.x;
                      m[4 * c + 1] = v.y;
                      m[4 * c + 2] = v.z;
                      m[4 * c + 3] = v.w;
                    }
                    score::pose<Policy>(m, pool, n, thr_sq, count, msac);
                  },
                  out_count, out_msac);
}

// The blocks of one kernel's persistent grid: as many as fit on the card
// at once, read once per device.
struct Residency {
  int device = -1, blocks = 0;

  template <class Kernel>
  int of(Kernel kernel) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev != device) {
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
      blocks = sms * per_sm > 0 ? sms * per_sm : 1;
      device = dev;
    }
    return blocks;
  }
};

// Check the arguments of a scorer's entry and give its grid: n points of
// models [H, W] 16-byte aligned; 0 when there is nothing to launch, -1 on
// bad arguments.
template <class Kernel>
int grid_of(Kernel kernel, Residency* resident, const float* models, int n, int H) {
  if (n < 0 || n > kMaxPoints || reinterpret_cast<uintptr_t>(models) % 16 != 0)
    return -1;
  if (H <= 0) return 0;
  const int n_tiles = (H + kThreads - 1) / kThreads;
  const int blocks = resident->of(kernel);
  return n_tiles < blocks ? n_tiles : blocks;
}

}  // namespace

// C entry points, bound with ctypes.  Launch on `stream` (PyTorch's current
// stream), do not synchronise, and return cudaGetLastError().  Models are
// 16-byte aligned ([H, 9] homographies, [H, 12] poses); the points are the
// caller's raw ones, n <= 16: src, dst [n, 2] or X [n, 3] and pix [n, 2],
// and mask [n].  Where thr_sq_p is not null, the kernel reads thr_sq from
// that float on the card instead, so a threshold formed there is never
// read back by the host.
extern "C" int homography_scores_launch(const float* models, const float* src,
                                        const float* dst, const float* mask,
                                        float thr_sq, const float* thr_sq_p,
                                        int n, int H,
                                        float* out_count, float* out_msac,
                                        void* stream) {
  static Residency resident;
  const int grid = grid_of(homography_scores_kernel, &resident, models, n, H);
  if (grid < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0)
    homography_scores_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        models, src, dst, mask, thr_sq, thr_sq_p, n, H, out_count, out_msac);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pnp_scores_launch(const float* models, const float* X,
                                 const float* pix, const float* mask,
                                 float thr_sq, const float* thr_sq_p, int n, int H,
                                 float* out_count, float* out_msac, void* stream) {
  static Residency resident;
  const int grid = grid_of(pnp_scores_kernel, &resident, models, n, H);
  if (grid < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0)
    pnp_scores_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        models, X, pix, mask, thr_sq, thr_sq_p, n, H, out_count, out_msac);
  return static_cast<int>(cudaGetLastError());
}
