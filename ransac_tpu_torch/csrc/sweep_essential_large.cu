// Large-pool 8-point essential-matrix RANSAC sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `essential_ransac_sweep_large`
// (ransac_tpu/ops/pallas/sweep_essential_large.py, kernel body
// `_make_kernel`) for pools of up to 1024 correspondences: the fused path of
// the two-view pipeline.  A call is three launches from one C call:
//
// - sweep_essential_large_prep_kernel does what the JAX wrapper does in
//   XLA: counts the valid points, normalizes both images with one shared
//   scale (masked centroids, mean distance over both point sets:
//   large::pool_norm, two passes of column-wise pairwise tree sums),
//   scales the squared threshold, and writes the table in the shuffled
//   valid-first pool order padded with zero rows to a multiple of 16, the
//   pool order, n_valid, and the centroids and scale (the caller re-solves
//   the winner in this frame).  It is n_rows / 32 blocks of 1024 threads:
//   each stages every row in shared memory, takes the sums (three
//   barriers), and gives 32 rows their slots, a warp a row counting the
//   smaller pool words (large::pool_slot), so each block writes 32 table
//   rows.
// - sweep_essential_large_solve_kernel: a thread a hypothesis draws its 8
//   windowed counter samples and solves its canonical F
//   (sweep_essential_large.cuh `solve`), left in the prep buffer.
// - sweep_essential_large_kernel: a block of 256 threads owns one record,
//   the 8 hypotheses of a TPU kernel's record: with LAN = block_h / 8,
//   record r = b * LAN + l covers the flat ids b * block_h + s * LAN + l,
//   s = 0..7.  Warp s scores hypothesis s, lane l the rows l, l + 32, ...
//   of the table in shared memory (its n_rows rows only, so that a full
//   SM's blocks fit: `score_lane`); a fixed tree of shuffles adds the
//   lanes' pairs, and the first warp reduces the block's record
//   (records.cuh) with the min-MSAC and (max count, min MSAC) winners and
//   their flat ids; MSAC is scaled back by 1 / s^2 as it is written.  With
//   `full` set every hypothesis writes its own (msac, count, flat) at s * B
//   + r instead, B = n_hyp / 8.
//
// The solve and the score are programmatic dependent launches: each
// lets the next be scheduled as it starts, and its blocks wait
// (griddepcontrol.wait) for the kernel before it before they read its
// output, so the launches overlap the kernels before them.
//
// What bounds it on this card: FP32 CUDA-core arithmetic, ~300 dependent
// operations a hypothesis for the solve against ~25 a table row.  One
// thread a hypothesis filled a quarter of the card at the two-view pool's
// 8192 hypotheses (32 blocks) and walked 480 rows on the ILP of 4
// accumulator pairs; a warp a hypothesis makes 8192 x 32 threads of short
// row loops, 1024 blocks of 256 (with fewer, larger blocks the early
// placement of a dependent launch spread them unevenly, PERF.md).  The
// solve is ~4% of the operations but a long dependent chain: in a kernel
// of its own, on 8192 threads, it no longer holds each score block (and
// its registers) for its latency.  The score takes the `Fused` policy of
// fp32_rn.cuh (each product-sum one FFMA, MUFU's reciprocal of the Sampson
// denominator, one instruction for each NaN-propagating min and max), about
// half the issue slots of `Exact` with its IEEE division.
//
// Rounding: the prep and the solve round every operation on its own, in the
// order of the plain PyTorch version (`ransac_tpu_torch.ops.sweep_essential_
// large`): the table, pool order, normalization, samples, F and validity
// are the plain version's bit for bit (rsqrt is rsqrtf, torch.rsqrt on the
// card).  The score is fused and sums each hypothesis' rows in another
// association (32 lanes and a tree where the plain version has 4 pairs), so
// the two agree in their decisions: counts equal but where points at the
// Sampson cut explain a flip, MSAC within 1e-4 relative on >= 99% of
// hypotheses and 1e-3 on all (`ops.sweep.hold_full` / `hold_reduced` with
// `ops.sweep_essential_large.cut_margins`, held on the card by
// chip_smoke.py).  The header's `Exact` instantiation of this layout agrees
// with the plain version to the association alone (host build).

#include <cuda_runtime.h>

#include "records.cuh"
#include "sampler_large.cuh"
#include "sweep_essential_large.cuh"

namespace {

using Score = rt::Fused;         // the Sampson score's policy
constexpr int kG = sweep_essential_large::kLanes;  // lanes a hypothesis
constexpr int kThreads = 8 * kG;  // a score block: one record
constexpr int kPrepThreads = 1024;
constexpr int kM = sweep_essential_large::kMaxPoints;
constexpr int kStage = large::padded(kM);  // floats of a staged prep column
// The prep buffer: five columns of kM floats (u1, v1, u2, v2, weight) in
// pool order, then thr^2 * s^2, 1 / s^2, m1 (2), m2 (2) and s.
constexpr int kThr = 5 * kM, kInvS2 = kThr + 1, kM1 = kThr + 2, kM2 = kThr + 4,
              kScale = kThr + 6;
constexpr int kPrepFloats = kScale + 1;
// The solves follow in the same buffer: [10, n_hyp] floats from kSolved.
constexpr int kSolved = kPrepFloats;
constexpr int kSolveThreads = 128;

// The 8 draw seeds and the window seed, passed by value.
struct Seeds {
  unsigned s[9];
};

__global__ void __launch_bounds__(kPrepThreads)
sweep_essential_large_prep_kernel(const float* __restrict__ x1,   // [n, 2]
                                  const float* __restrict__ x2,   // [n, 2]
                                  const float* __restrict__ mask, // [n]
                                  float threshold_sq, unsigned shuffle_seed,
                                  int n, float* __restrict__ prep,
                                  int* __restrict__ aux) {        // [n + 1]
  using namespace rt;
  __shared__ unsigned long long words[kM];
  __shared__ float raw[5 * kStage];  // m, u1, v1, u2, v2 of row r at padded(r)
  __shared__ float cols[8 * 32];
  // The sweep may be scheduled now: it waits for this grid's end (and its
  // writes) before it reads them.
  asm volatile("griddepcontrol.launch_dependents;");
  const int t = threadIdx.x;
  const bool in = t < n;
  const float v[5] = {in ? mask[t] : 0.0f, in ? x1[2 * t] : 0.0f,
                      in ? x1[2 * t + 1] : 0.0f, in ? x2[2 * t] : 0.0f,
                      in ? x2[2 * t + 1] : 0.0f};
#pragma unroll
  for (int c = 0; c < 5; ++c) raw[c * kStage + large::padded(t)] = v[c];
  words[t] = in ? large::pool_word(t, large::shuffle_key(t, shuffle_seed, v[0] > 0.0f))
                : large::kPadWord;
  __syncthreads();
  float nrm[8];  // cnt, m1 (2), m2 (2), distance sums (2), n_valid
  large::pool_norm(raw, kStage, n, cols, nrm);
  const float s = div(1.4142135623730951f,
                      max_nan(div(add(nrm[5], nrm[6]), mul(2.0f, nrm[0])), 1e-12f));

  // Warp w puts table row r = 32 * blockIdx.x + w at its slot, lane c < 4
  // column c (u1, v1, u2, v2 normalized), lane 4 the weight.
  const int r = blockIdx.x * (kPrepThreads / 32) + (t >> 5), lane = t & 31;
  if (r < large::table_rows(n)) {
    const int slot = large::pool_slot(words, r, n);
    if (lane < 5) {
      const float x = r < n ? raw[(lane + 1) % 5 * kStage + large::padded(r)] : 0.0f;
      prep[lane * kM + slot] = lane == 4 ? x : r < n ? mul(sub(x, nrm[1 + lane]), s) : 0.0f;
    }
    if (lane == 5 && r < n) aux[slot] = r;
  }
  if (blockIdx.x == 0 && t == 0) {
    prep[kThr] = mul(mul(threshold_sq, s), s);
    prep[kInvS2] = rcp(mul(s, s));
    prep[kM1] = nrm[1];
    prep[kM1 + 1] = nrm[2];
    prep[kM2] = nrm[3];
    prep[kM2 + 1] = nrm[4];
    prep[kScale] = s;
    aux[n] = static_cast<int>(nrm[7]);
  }
}

// The flat id of hypothesis s of record r (LAN = lan records a block).
__device__ __forceinline__ int flat_id(int r, int s, int lan) {
  return (r / lan) * 8 * lan + s * lan + r % lan;
}

// One thread a hypothesis, hypothesis g = 8 r + s: its windowed sample and
// canonical F, left for the score at solved[c * n_hyp + g] (F's 9 entries,
// then 1 where valid).
__global__ void __launch_bounds__(kSolveThreads)
sweep_essential_large_solve_kernel(float* __restrict__ prep,
                                   const int* __restrict__ aux, int n,
                                   Seeds seeds, int lan, int n_hyp) {
  // The score may be scheduled now; wait for the prep's table.
  asm volatile("griddepcontrol.launch_dependents;");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int g = blockIdx.x * kSolveThreads + threadIdx.x;
  const sweep_essential_large::Table t{prep, prep + kM, prep + 2 * kM,
                                       prep + 3 * kM, prep + 4 * kM};
  float F[9];
  const bool ok = sweep_essential_large::solve(
      static_cast<unsigned>(flat_id(g / 8, g % 8, lan)), seeds.s, aux[n], 8 * lan, t, F);
  float* solved = prep + kSolved;
#pragma unroll
  for (int c = 0; c < 9; ++c) solved[c * n_hyp + g] = F[c];
  solved[9 * n_hyp + g] = ok ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
sweep_essential_large_kernel(const float* __restrict__ prep,
                             const int* __restrict__ aux, int n, int lan,
                             int B, int full,
                             float* __restrict__ f_out,   // [4, B] or [2, 8B]
                             int* __restrict__ i_out) {   // [2, B] or [8B]
  extern __shared__ float tab[];  // [5, n_rows]: the table's columns
  __shared__ float s_rec[2][8];   // msac, count
  // With a programmatic launch, wait for the solves (a no-op otherwise).
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int tid = threadIdx.x;
  const int n_rows = large::table_rows(n);
  for (int k = tid; k < n_rows; k += kThreads) {
#pragma unroll
    for (int c = 0; c < 5; ++c) tab[c * n_rows + k] = prep[c * kM + k];
  }
  // Warp h scores the block's hypothesis h, 8 r + h overall.
  const int h = tid / kG, lane = tid % kG, n_hyp = 8 * B;
  const float* solved = prep + kSolved + blockIdx.x * 8 + h;
  float F[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) F[c] = solved[c * n_hyp];
  const bool ok = solved[9 * n_hyp] != 0.0f;
  __syncthreads();

  const sweep_essential_large::Table t{tab, tab + n_rows, tab + 2 * n_rows,
                                       tab + 3 * n_rows, tab + 4 * n_rows};
  float cnt, ms;
  sweep_essential_large::score_lane<Score>(F, t, lane, n_rows, prep[kThr], &cnt, &ms);
#pragma unroll
  for (int off = kG / 2; off >= 1; off >>= 1) {
    cnt = rt::add(cnt, __shfl_down_sync(0xffffffffu, cnt, off));
    ms = rt::add(ms, __shfl_down_sync(0xffffffffu, ms, off));
  }
  if (lane == 0) {
    s_rec[0][h] = ok ? ms : large::kBig;
    s_rec[1][h] = ok ? cnt : -1.0f;
  }
  __syncthreads();
  if (tid >= 32) return;
  // The first warp: lane l holds hypothesis s = l % 8 (lanes 8-31 repeat
  // the record, as records::reduce takes a full warp, and write nothing).
  const int s = tid % 8, r = blockIdx.x;
  const int flat = flat_id(r, s, lan);
  const float msac = s_rec[0][s], count = s_rec[1][s];
  const float inv_s2 = prep[kInvS2];
  if (full) {
    if (tid < 8) {
      const long long o = static_cast<long long>(s) * B + r;
      f_out[o] = sweep::rescale(msac, inv_s2);
      f_out[8LL * B + o] = count;
      i_out[o] = flat;
    }
    return;
  }
  records::Record rec =
      records::reduce(msac, count, flat, msac, count, flat, large::kBig);
  if (tid == 0) {
    rec.msac_m = sweep::rescale(rec.msac_m, inv_s2);
    rec.msac_c = sweep::rescale(rec.msac_c, inv_s2);
    records::write(rec, r, B, f_out, i_out);
  }
}

// Launch `kernel` on `st` as a programmatic dependent launch: its blocks
// may be placed before the previous kernel on the stream ends (each waits
// for it with griddepcontrol.wait before it reads its output).
template <class... Params, class... Args>
cudaError_t launch(void (*kernel)(Params...), int grid, int block, int smem,
                   cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace

// C entry point, bound with ctypes.  x1/x2 [n, 2] (normalized camera
// coordinates) and mask [n], 8 <= n valid, n <= 1024; seeds s0-s7 draw, s8
// places the windows, s9 shuffles the pool; block_h a multiple of 256 that
// divides n_hyp; prep a device buffer of kPrepFloats + 10 n_hyp floats
// (5127 of the prep's own, then the solves), aux of n + 1 ints (the pool
// order, then n_valid).  `full`: every hypothesis' record (f_out [2, n_hyp], i_out [n_hyp]) instead of the reduced ones
// (f_out [4, B], i_out [2, B]).  Launches the three kernels on `stream`, does
// not synchronise, and returns cudaGetLastError().
extern "C" int sweep_essential_large_launch(const float* x1, const float* x2,
                                            const float* mask,
                                            float threshold_sq, unsigned s0,
                                            unsigned s1, unsigned s2,
                                            unsigned s3, unsigned s4,
                                            unsigned s5, unsigned s6,
                                            unsigned s7, unsigned s8,
                                            unsigned s9, int n,
                                            int n_hyp, int block_h, int full,
                                            float* prep, int* aux,
                                            float* f_out, int* i_out,
                                            void* stream) {
  static_assert(kPrepFloats == 5127, "ops/sweep_essential_large.py PREP_FLOATS");
  if (n < 1 || n > kM || n_hyp <= 0 || block_h <= 0 || block_h % 256 != 0 ||
      n_hyp % block_h != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Seeds seeds{{s0, s1, s2, s3, s4, s5, s6, s7, s8}};
  const int B = n_hyp / 8;
  const int n_rows = (n + 15) / 16 * 16;  // large::table_rows
  sweep_essential_large_prep_kernel<<<(n_rows + 31) / 32, kPrepThreads, 0, st>>>(
      x1, x2, mask, threshold_sq, s9, n, prep, aux);
  // The score blocks hold the table's n_rows rows, not kM: up to 8 blocks
  // of 256 threads (the card's 2048 a SM) fit an SM's shared memory.  Set
  // on every call: the attribute is the current device's.
  cudaError_t err = cudaFuncSetAttribute(sweep_essential_large_kernel,
                                         cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) {
    err = launch(sweep_essential_large_solve_kernel, n_hyp / kSolveThreads, kSolveThreads,
                 0, st, prep, aux, n, seeds, block_h / 8, n_hyp);
  }
  if (err == cudaSuccess) {
    err = launch(sweep_essential_large_kernel, B, kThreads,
                 5 * n_rows * static_cast<int>(sizeof(float)), st, prep, aux, n,
                 block_h / 8, B, full, f_out, i_out);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
