// Fused P3P-RANSAC sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `pnp_ransac_sweep`
// (ransac_tpu/ops/pallas/sweep_pnp.py, kernel body `_make_kernel`).  Each
// thread is one 3-point sample: counter-PRNG draw (remainders by
// multiply-high, rt::Divider), then Grunert's P3P with its four roots,
// depth polish and triad pose (sweep_pnp.cuh); the block's valid poses are
// gathered and scored over every point (pnp_queue.cuh).  The TPU kernel's
// records are kept: with LAN = block_h / 8, record r = b * LAN + l covers
// the flat ids b * block_h + s * LAN + l, s = 0..7; the best root of each
// sample under both rules is reduced over the record's eight samples (three
// xor shuffles among eight neighbouring lanes) to two winners, min MSAC and
// (max count, min MSAC), each with its root id in bits 12-13 of the packed
// sample.  With `full` set every (sample, root) writes its own record,
// root-major, at root * n_hyp + s * B + r (B = n_hyp / 8), and the packed
// sample at s * B + r.
//
// What bounds it on this card: the FP32 pipe's issue rate.  The solve is
// ~1,200 operations a sample with ~30 exact divisions and long serial
// chains (12 resolvent-cubic steps); the score is ~24 operations a point
// and pose, but only ~40% of the (sample, root) pairs of uniform inputs are
// valid, so only those are scored: the compaction turns the warp-divergent
// root loop into full warps, and the `Fused` score issues each product-sum
// after the camera point as one FFMA and the reciprocal on the MUFU pipe.
// The point table is one 16-byte and one 8-byte broadcast load a point.
//
// Rounding: the solve rounds each operation on its own, as the plain
// PyTorch version (`ransac_tpu_torch.ops.sweep_pnp`) does, so samples,
// poses and validity are the plain version's bit for bit; rsqrt is rsqrtf,
// which is what torch.rsqrt computes on the card.  The score is `Fused`, so
// counts and MSAC agree with the plain version in their decisions
// (`ops.sweep_pnp.hold_full` / `hold_reduced`), not bit for bit; its
// `Exact` instantiation is the plain version's arithmetic bit for bit.

#include <cuda_runtime.h>

#include "pnp_queue.cuh"
#include "records.cuh"
#include "sweep_pnp.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPerLane = 1;      // poses a thread scores against each point load
using Score = rt::Fused;         // the score's arithmetic policy
constexpr int kM = sweep_pnp::kMaxPoints;

// The 3 draw seeds and their divisors n_points - j, passed by value.
struct Draws {
  unsigned seed[3];
  rt::Divider div[3];
};

__global__ void __launch_bounds__(kThreads)
sweep_pnp_kernel(const float* __restrict__ X,      // [16, 3]
                 const float* __restrict__ f,      // [16, 3] unit bearings
                 const float* __restrict__ pix,    // [16, 2] (x, ay * y)
                 const float* __restrict__ mask,   // [16]
                 const int* __restrict__ vmask,    // [1] sample bitmask
                 float thr_sq, float ay,
                 const float* __restrict__ thr_sq_p,  // [1] or null
                 const float* __restrict__ ay_p,      // [1] or null
                 Draws draws, int n_score, int n_hyp,
                 int lan, int full,
                 float* __restrict__ f_out,        // [4, B] or [8, n_hyp]
                 int* __restrict__ i_out) {        // [2, B] or [n_hyp]
  __shared__ __align__(16) float s_xyzw[4 * kM];
  __shared__ __align__(8) float s_pix[2 * kM];
  __shared__ pnp_queue::Queue<kThreads> queue;
  __shared__ float s_f[3][kM];
  const int tid = threadIdx.x;
  if (thr_sq_p != nullptr) thr_sq = *thr_sq_p;
  if (ay_p != nullptr) ay = *ay_p;
  if (tid < kM) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s_xyzw[4 * tid + c] = X[3 * tid + c];
      s_f[c][tid] = f[3 * tid + c];
    }
    s_xyzw[4 * tid + 3] = mask[tid];
    s_pix[2 * tid] = pix[2 * tid];
    s_pix[2 * tid + 1] = pix[2 * tid + 1];
  }
  __syncthreads();

  const int g = blockIdx.x * kThreads + tid;
  const int r = g >> 3, s = g & 7;
  const int B = n_hyp / 8;
  const unsigned flat =
      static_cast<unsigned>((r / lan) * 8 * lan + s * lan + r % lan);
  int i[3];
  rt::draw_sample_fast<3>(flat, draws.seed, draws.div, i);
  const int vm = vmask[0];
  const bool sample_valid = (((vm >> i[0]) & (vm >> i[1]) & (vm >> i[2])) & 1) == 1;
  float P[3][3], F[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      P[j][c] = s_xyzw[4 * i[j] + c];
      F[j][c] = s_f[c][i[j]];
    }
  }
  const int packed = i[0] + i[1] * 16 + i[2] * 256;
  sweep_pnp::Solve sv;
  sweep_pnp::solve(P, F, &sv);
  const unsigned long long slots = queue.push(sv, F, sample_valid, ay);
  __syncthreads();
  queue.score<Score, kPerLane>(sweep_pnp::Table{s_xyzw, s_pix}, n_score, thr_sq);
  __syncthreads();
  float msac[sweep_pnp::kRoots], count[sweep_pnp::kRoots];
  queue.results(slots, msac, count);

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
// divides n_hyp, and 3 <= n_points <= n_score <= 16.  Where thr_sq_p or ay_p
// is not null, the kernel reads that value from the card instead of the
// float beside it.  Launches on `stream` (PyTorch's current stream), does
// not synchronise, and returns cudaGetLastError().
extern "C" int sweep_pnp_launch(const float* X, const float* f,
                                const float* pix, const float* mask,
                                const int* vmask, float thr_sq, float ay,
                                const float* thr_sq_p, const float* ay_p,
                                unsigned s0, unsigned s1, unsigned s2,
                                int n_points, int n_score, int n_hyp,
                                int block_h, int full, float* f_out,
                                int* i_out, void* stream) {
  if (n_hyp <= 0 || block_h <= 0 || block_h % 256 != 0 || n_hyp % block_h != 0 ||
      n_points < 3 || n_points > n_score || n_score > kM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Draws draws{{s0, s1, s2}, {}};
  for (int j = 0; j < 3; ++j) draws.div[j] = rt::make_divider(n_points - j);
  sweep_pnp_kernel<<<n_hyp / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      X, f, pix, mask, vmask, thr_sq, ay, thr_sq_p, ay_p, draws, n_score, n_hyp,
      block_h / 8, full, f_out, i_out);
  return static_cast<int>(cudaGetLastError());
}
