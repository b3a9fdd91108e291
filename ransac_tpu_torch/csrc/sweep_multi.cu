// Candidate-axis exhaustive homography-RANSAC sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `multi_candidate_sweep` in
// ransac_tpu/ops/pallas/sweep_multi.py (kernel body `_make_kernel`).  It
// computes what that kernel computes, not its TPU block layout: for every
// candidate camera c and every 4-point sample h of a shared sample table,
// the division-free projective-frame (adjugate) homography, the algebraic
// inlier test r2 <= thr^2 w^2 and the truncated MSAC min(r2, thr^2 w^2)/w^2
// over n <= 16 points (4 independent accumulators, summed in the Pallas
// kernel's order), then one record per candidate: min MSAC, ties to the
// smallest packed sample i0 + 16 i1 + 256 i2 + 4096 i3, with its count.
//
// Layout: one thread block of 256 threads per candidate.  The candidate's
// plane points, the shared (normalized) pixels and the mask live in shared
// memory; thread t walks hypotheses h = t, t + 256, ... and reads its four
// indices from idx[j * H + h], so a warp's index reads are coalesced.  A
// warp-shuffle reduction and then a shared-memory reduction across the 8
// warps give the candidate's record.  Nothing but the C records is written.
//
// What bounds it on this card: FP32 CUDA-core arithmetic, about
// 500 + 22 n flops per hypothesis, and a few bytes per candidate (the
// 4 x H int32 sample table is shared by all candidates and stays in L2).
// At the localize shape (458 candidates x 1024 padded samples, n = 13)
// that is about 0.4 GFLOP, a few microseconds of the H100's 67 TFLOP/s
// FP32 rate, so the launch itself likely dominates.  Making it fast
// (FMA contraction, several candidates per block, fewer index loads) is
// later work.
//
// Rounding: every product, sum and quotient is rounded on its own (the
// __f*_rn intrinsics are never contracted into FMA, and the quotient is an
// IEEE division where the TPU used an approximate reciprocal), in the order
// the plain PyTorch version (`multi_candidate_sweep_ref`) evaluates them.
// The kernel and the plain version therefore agree bit for bit on the same
// inputs.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxPoints = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kInvalid = 3.4e38f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Record order: lower MSAC wins; equal MSAC goes to the smaller packed sample.
__device__ __forceinline__ bool better(float m, int p, float best_m, int best_p) {
  return m < best_m || (m == best_m && p < best_p);
}

__device__ __forceinline__ float det3(float px, float py, float qx, float qy,
                                      float rx, float ry) {
  return sub(mul(sub(qx, px), sub(ry, py)), mul(sub(rx, px), sub(qy, py)));
}

// Projective frame of 4 points: M maps the canonical frame onto them.
// Valid when no three of the points are (near-)collinear.
__device__ __forceinline__ bool frame(const float* x, const float* y,
                                      float M[3][3]) {
  const float d0 = det3(x[0], y[0], x[1], y[1], x[2], y[2]);
  const float l1 = det3(x[3], y[3], x[1], y[1], x[2], y[2]);
  const float l2 = det3(x[0], y[0], x[3], y[3], x[2], y[2]);
  const float l3 = det3(x[0], y[0], x[1], y[1], x[3], y[3]);
  M[0][0] = mul(l1, x[0]); M[0][1] = mul(l2, x[1]); M[0][2] = mul(l3, x[2]);
  M[1][0] = mul(l1, y[0]); M[1][1] = mul(l2, y[1]); M[1][2] = mul(l3, y[2]);
  M[2][0] = l1;            M[2][1] = l2;            M[2][2] = l3;
  return fabsf(d0) > 1e-7f && fabsf(l1) > 1e-7f && fabsf(l2) > 1e-7f &&
         fabsf(l3) > 1e-7f;
}

__global__ void __launch_bounds__(kThreads)
sweep_multi_kernel(const float* __restrict__ src,     // [C, 16, 2]
                   const float* __restrict__ dst,     // [16, 2]
                   const float* __restrict__ mask,    // [16]
                   const float* __restrict__ thr_sq,  // [1]
                   const int* __restrict__ idx,       // [4, H]
                   int H, int n,
                   float* __restrict__ out_msac,      // [C]
                   float* __restrict__ out_count,     // [C]
                   int* __restrict__ out_packed) {    // [C]
  __shared__ float s_sx[kMaxPoints], s_sy[kMaxPoints];
  __shared__ float s_dx[kMaxPoints], s_dy[kMaxPoints], s_w[kMaxPoints];
  __shared__ float r_msac[kWarps], r_count[kWarps];
  __shared__ int r_packed[kWarps];

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < kMaxPoints) {
    s_sx[tid] = src[(c * kMaxPoints + tid) * 2];
    s_sy[tid] = src[(c * kMaxPoints + tid) * 2 + 1];
    s_dx[tid] = dst[tid * 2];
    s_dy[tid] = dst[tid * 2 + 1];
    s_w[tid] = mask[tid];
  }
  __syncthreads();
  const float t2 = thr_sq[0];

  float best_msac = __int_as_float(0x7f800000);  // +inf
  float best_count = -2.0f;
  int best_packed = 1 << 30;

  for (int h = tid; h < H; h += kThreads) {
    int i[4];
    float sx[4], sy[4], dx[4], dy[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      i[j] = idx[j * H + h];
      sx[j] = s_sx[i[j]];
      sy[j] = s_sy[i[j]];
      dx[j] = s_dx[i[j]];
      dy[j] = s_dy[i[j]];
    }
    float A[3][3], B[3][3];
    const bool ok_s = frame(sx, sy, A);
    const bool ok_d = frame(dx, dy, B);

    float adj[3][3];
    adj[0][0] = sub(mul(A[1][1], A[2][2]), mul(A[1][2], A[2][1]));
    adj[0][1] = sub(mul(A[0][2], A[2][1]), mul(A[0][1], A[2][2]));
    adj[0][2] = sub(mul(A[0][1], A[1][2]), mul(A[0][2], A[1][1]));
    adj[1][0] = sub(mul(A[1][2], A[2][0]), mul(A[1][0], A[2][2]));
    adj[1][1] = sub(mul(A[0][0], A[2][2]), mul(A[0][2], A[2][0]));
    adj[1][2] = sub(mul(A[0][2], A[1][0]), mul(A[0][0], A[1][2]));
    adj[2][0] = sub(mul(A[1][0], A[2][1]), mul(A[1][1], A[2][0]));
    adj[2][1] = sub(mul(A[0][1], A[2][0]), mul(A[0][0], A[2][1]));
    adj[2][2] = sub(mul(A[0][0], A[1][1]), mul(A[0][1], A[1][0]));
    float Hm[9];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int col = 0; col < 3; ++col) {
        Hm[3 * r + col] = add(add(mul(B[r][0], adj[0][col]), mul(B[r][1], adj[1][col])),
                              mul(B[r][2], adj[2][col]));
      }
    }

    float cnt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float ms[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int p = 0; p < kMaxPoints; ++p) {
      if (p < n) {
        const float x = s_sx[p], y = s_sy[p];
        const float u = add(add(mul(Hm[0], x), mul(Hm[1], y)), Hm[2]);
        const float v = add(add(mul(Hm[3], x), mul(Hm[4], y)), Hm[5]);
        const float w = add(add(mul(Hm[6], x), mul(Hm[7], y)), Hm[8]);
        const float a = sub(u, mul(s_dx[p], w));
        const float b = sub(v, mul(s_dy[p], w));
        const float r2 = add(mul(a, a), mul(b, b));
        const float w2 = fmaxf(mul(w, w), 1e-30f);
        const float t = mul(t2, w2);
        cnt[p & 3] = add(cnt[p & 3], r2 <= t ? s_w[p] : 0.0f);
        ms[p & 3] = add(ms[p & 3], mul(__fdiv_rn(fminf(r2, t), w2), s_w[p]));
      }
    }
    const float count = add(add(add(cnt[0], cnt[1]), cnt[2]), cnt[3]);
    float msac = add(add(add(ms[0], ms[1]), ms[2]), ms[3]);
    if (!(ok_s && ok_d)) msac = kInvalid;
    const int packed = i[0] + 16 * i[1] + 256 * i[2] + 4096 * i[3];
    if (better(msac, packed, best_msac, best_packed)) {
      best_msac = msac;
      best_count = count;
      best_packed = packed;
    }
  }

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

// C entry point, bound with ctypes.  Launches on `stream` (PyTorch's current
// stream), does not synchronise, and returns cudaGetLastError() so that a
// refused launch is reported to the caller.
extern "C" int sweep_multi_launch(const float* src, const float* dst,
                                  const float* mask, const float* thr_sq,
                                  const int* idx, int C, int H, int n,
                                  float* out_msac, float* out_count,
                                  int* out_packed, void* stream) {
  if (C > 0) {
    sweep_multi_kernel<<<C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        src, dst, mask, thr_sq, idx, H, n, out_msac, out_count, out_packed);
  }
  return static_cast<int>(cudaGetLastError());
}
