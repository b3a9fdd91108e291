// Fused P3P-RANSAC sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `pnp_ransac_sweep`
// (ransac_tpu/ops/pallas/sweep_pnp.py, kernel body `_make_kernel`).  Each
// thread is one 3-point sample: counter-PRNG draw, Grunert P3P with its four
// roots, depth polish, triad pose and the score of every point under each
// root (sweep_pnp.cuh).  The TPU kernel's records are kept: with
// LAN = block_h / 8, record r = b * LAN + l covers the flat ids
// b * block_h + s * LAN + l, s = 0..7; the best root of each sample under
// both rules is reduced over the record's eight samples (three xor shuffles
// among eight neighbouring lanes) to two winners, min MSAC and (max count,
// min MSAC), each with its root id in bits 12-13 of the packed sample.  With
// `full` set every (sample, root) writes its own record, root-major, at
// root * n_hyp + s * B + r (B = n_hyp / 8), and the packed sample at s * B + r.
//
// What bounds it on this card: FP32 CUDA-core arithmetic and its latency,
// about 2,000 operations per sample (the TPU kernel's count) plus
// 4 x ~30 per point, with exact divisions in the Newton loops and long
// serial dependency chains (12 resolvent-cubic steps).  Registers: four
// roots' poses are worked one at a time (the root loop is not unrolled), so
// only the roots, the shared world triad and two running bests stay live.
// Making it fast (approximate reciprocals, FMA, a shorter cubic) is later work.
//
// Rounding: every operation is rounded on its own, in the order of the plain
// PyTorch version (`ransac_tpu_torch.ops.sweep_pnp._sweep_plain`); rsqrt is
// rsqrtf, which is what torch.rsqrt computes on the card.

#include <cuda_runtime.h>

#include "records.cuh"
#include "sweep_pnp.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sweep_pnp_kernel(const float* __restrict__ X,      // [16, 3]
                 const float* __restrict__ f,      // [16, 3] unit bearings
                 const float* __restrict__ pix,    // [16, 2] (x, ay * y)
                 const float* __restrict__ mask,   // [16]
                 const int* __restrict__ vmask,    // [1] sample bitmask
                 float thr_sq, float ay, unsigned s0, unsigned s1, unsigned s2,
                 int n_points, int n_score, int n_hyp, int lan, int full,
                 float* __restrict__ f_out,        // [4, B] or [8, n_hyp]
                 int* __restrict__ i_out) {        // [2, B] or [n_hyp]
  constexpr int M = sweep_pnp::kMaxPoints;
  __shared__ float s_X[M], s_Y[M], s_Z[M], s_fx[M], s_fy[M], s_fz[M];
  __shared__ float s_px[M], s_py[M], s_w[M];
  const int tid = threadIdx.x;
  if (tid < M) {
    s_X[tid] = X[3 * tid];
    s_Y[tid] = X[3 * tid + 1];
    s_Z[tid] = X[3 * tid + 2];
    s_fx[tid] = f[3 * tid];
    s_fy[tid] = f[3 * tid + 1];
    s_fz[tid] = f[3 * tid + 2];
    s_px[tid] = pix[2 * tid];
    s_py[tid] = pix[2 * tid + 1];
    s_w[tid] = mask[tid];
  }
  __syncthreads();

  const int g = blockIdx.x * kThreads + tid;
  const int r = g >> 3, s = g & 7;
  const int B = n_hyp / 8;
  const unsigned flat =
      static_cast<unsigned>((r / lan) * 8 * lan + s * lan + r % lan);
  const unsigned seeds[3] = {s0, s1, s2};
  const sweep_pnp::Pool pool{s_X, s_Y, s_Z, s_fx, s_fy, s_fz, s_px, s_py, s_w};
  float msac[sweep_pnp::kRoots], count[sweep_pnp::kRoots];
  int packed;
  sweep_pnp::eval(flat, seeds, vmask[0], n_points, n_score, thr_sq, ay, pool,
                  msac, count, &packed);

  if (full) {
    const long long o = static_cast<long long>(s) * B + r;
#pragma unroll
    for (int k = 0; k < sweep_pnp::kRoots; ++k) {
      f_out[static_cast<long long>(k) * n_hyp + o] = msac[k];
      f_out[static_cast<long long>(4 + k) * n_hyp + o] = count[k];
    }
    i_out[o] = packed;
    return;
  }
  float a_msac, a_count, b_msac, b_count;
  int a_root, b_root;
  sweep_pnp::best_roots(msac, count, &a_msac, &a_count, &a_root, &b_msac,
                        &b_count, &b_root);
  records::reduce_and_write(a_msac, a_count, packed + a_root * 4096, b_msac,
                            b_count, packed + b_root * 4096, sweep_pnp::kBig,
                            s, r, B, f_out, i_out);
}

}  // namespace

// C entry point, bound with ctypes.  block_h must be a multiple of 256 that
// divides n_hyp.  Launches on `stream` (PyTorch's current stream), does not
// synchronise, and returns cudaGetLastError().
extern "C" int sweep_pnp_launch(const float* X, const float* f,
                                const float* pix, const float* mask,
                                const int* vmask, float thr_sq, float ay,
                                unsigned s0, unsigned s1, unsigned s2,
                                int n_points, int n_score, int n_hyp,
                                int block_h, int full, float* f_out,
                                int* i_out, void* stream) {
  if (n_hyp <= 0 || block_h <= 0 || block_h % kThreads != 0 ||
      n_hyp % block_h != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sweep_pnp_kernel<<<n_hyp / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      X, f, pix, mask, vmask, thr_sq, ay, s0, s1, s2, n_points, n_score,
      n_hyp, block_h / 8, full, f_out, i_out);
  return static_cast<int>(cudaGetLastError());
}
