// The valid (sample, root) poses of a block, gathered and scored together
// (the P3P sweeps, csrc/sweep_pnp.cu and csrc/sweep_pnp_large.cu).
//
// A thread solves one sample and gets four poses, of which a sample of
// uniform points holds ~1.5 valid on average.  Scoring all four in the
// thread that solved them would run the point loop for every root a warp
// has valid in any lane.  So each warp appends its valid poses to its own
// region of a shared-memory queue (a ballot and a prefix count per root,
// no block barrier), and after one barrier the block's threads score the
// whole queue, kPerLane poses a thread against each point load, taking the
// entries in order so that only the last warp of a pass runs part-empty.
// Each (msac, count) goes back into its entry, and after a second barrier
// the owners read their roots' results; an invalid root gets (3.4e38, -1)
// and is never scored.  What a valid pose scores does not depend on who
// scores it, so the records are those of a sample-by-sample loop.

#pragma once

#include "sweep_pnp.cuh"

namespace pnp_queue {

template <int kThreads>
struct Queue {
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kPerWarp = 32 * sweep_pnp::kRoots;

  float4 entry[kWarps * kPerWarp][3];  // a pose's rows; (msac, count) after
  int total[kWarps];                   // valid poses of each warp

  // Solve the four roots of this thread's sample (root_pose) and append the
  // valid poses to the warp's region.  Returns the entries, 16 bits a root,
  // 0xFFFF for an invalid root.  Every lane of the warp must call it.
  __device__ __forceinline__ unsigned long long push(const sweep_pnp::Solve& s,
                                                     const float F[3][3],
                                                     bool sample_valid, float ay) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    unsigned long long slots = 0;
    int n = 0;
#pragma unroll 1
    for (int k = 0; k < sweep_pnp::kRoots; ++k) {
      sweep_pnp::Pose p;
      const bool v = sweep_pnp::root_pose(s, F, sample_valid, k, ay, &p);
      const unsigned b = __ballot_sync(0xffffffffu, v);
      const int e = warp * kPerWarp + n + __popc(b & below);
      if (v) {
#pragma unroll
        for (int r = 0; r < 3; ++r)
          entry[e][r] = make_float4(p.m[r][0], p.m[r][1], p.m[r][2], p.m[r][3]);
      }
      slots |= static_cast<unsigned long long>(v ? e : 0xFFFF) << (16 * k);
      n += __popc(b);
    }
    if (lane == 0) total[warp] = n;
    return slots;
  }

  // Score every queued pose over the first n_score table rows (policy P,
  // K poses a thread), each result into its entry.  Call between the two
  // barriers.
  template <class P, int K>
  __device__ __forceinline__ void score(const sweep_pnp::Table& tab, int n_score,
                                        float thr_sq) {
    int start[kWarps + 1];
    start[0] = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) start[w + 1] = start[w] + total[w];
    const int n_valid = start[kWarps];
    for (int e0 = threadIdx.x * K; e0 < n_valid; e0 += kThreads * K) {
      sweep_pnp::Pose p[K];
      int at[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        // Past the end a thread scores its own first entry again (and
        // keeps nothing of it): no other thread writes there.
        const int e = e0 + j < n_valid ? e0 + j : e0;
        int w = 0;
#pragma unroll
        for (int v = 1; v < kWarps; ++v) w += e >= start[v] ? 1 : 0;
        at[j] = w * kPerWarp + e - start[w];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const float4 row = entry[at[j]][r];
          p[j].m[r][0] = row.x;
          p[j].m[r][1] = row.y;
          p[j].m[r][2] = row.z;
          p[j].m[r][3] = row.w;
        }
      }
      float msac[K], count[K];
      sweep_pnp::score_poses<P, K>(p, tab, n_score, thr_sq, msac, count);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (e0 + j < n_valid)
          *reinterpret_cast<float2*>(&entry[at[j]][0]) = make_float2(msac[j], count[j]);
      }
    }
  }

  // This thread's four roots' (msac, count) after the second barrier.
  __device__ __forceinline__ void results(unsigned long long slots, float* msac,
                                          float* count) const {
#pragma unroll
    for (int k = 0; k < sweep_pnp::kRoots; ++k) {
      const int e = static_cast<int>((slots >> (16 * k)) & 0xFFFF);
      msac[k] = sweep_pnp::kBig;
      count[k] = -1.0f;
      if (e != 0xFFFF) {
        const float2 res = *reinterpret_cast<const float2*>(&entry[e][0]);
        msac[k] = res.x;
        count[k] = res.y;
      }
    }
  }
};

}  // namespace pnp_queue
