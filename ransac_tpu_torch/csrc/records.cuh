// Block-reduced records of the sweep kernels (sweep.cu, sweep_pnp.cu, the
// large-pool sweeps and sweep_essential.cu).
//
// The TPU kernels reduce each lane's 8 sublanes to two records: row 0 by
// min MSAC, then the smallest packed sample, then that sample's max count;
// row 1 by max count, then min MSAC, then the smallest packed sample
// (ransac_tpu/ops/pallas/sweep.py:217-237).  Here the 8 hypotheses of a
// record are 8 neighbouring lanes of a warp; three xor shuffles give each of
// them the group's min or max, and the selections are made exactly as the
// TPU's (NaN-propagating min/max, as jnp.min/jnp.max).

#pragma once

#include "fp32_rn.cuh"

namespace records {

__device__ __forceinline__ float group_min(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v = rt::min_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v = rt::max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int group_min_int(int v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The two records of a group of eight hypotheses.
struct Record {
  float msac_m, count_m, msac_c, count_c;
  int packed_m, packed_c;
};

// Reduce the group's (ma, ca, pa) by the MSAC rule and (mb, cb, pb) by the
// count rule; ties go to the smallest sample key, and `sentinel` stands for
// a hypothesis that is not selected.  Every lane of the warp must call it;
// every lane of the group gets the group's records.
__device__ __forceinline__ Record reduce(float ma, float ca, int pa, float mb,
                                         float cb, int pb, float big,
                                         int sentinel = 1 << 30) {
  Record rec;
  rec.msac_m = group_min(ma);
  const bool selm = ma == rec.msac_m;
  rec.packed_m = group_min_int(selm ? pa : sentinel);
  rec.count_m = group_max(selm && pa == rec.packed_m ? ca : -2.0f);
  rec.count_c = group_max(cb);
  const bool selc = cb == rec.count_c;
  rec.msac_c = group_min(selc ? mb : big);
  rec.packed_c = group_min_int(selc && mb == rec.msac_c ? pb : sentinel);
  return rec;
}

// reduce() with the packed samples ordered as unsigned 32-bit integers, as
// the 8-point sweep orders them (ransac_tpu/ops/pallas/sweep_essential.py:
// 272-286): its eight 4-bit indices fill the int, so a sample whose last
// index is 8 or more is negative as a signed value.  The keys are the
// samples with the sign bit flipped, compared signed, and the sentinel is
// 2^31 - 1 (the unsigned 0xFFFFFFFF, which no sample of distinct indices
// reaches).
__device__ __forceinline__ Record reduce_unsigned(float ma, float ca, int pa,
                                                  float mb, float cb, int pb,
                                                  float big) {
  constexpr int kSign = static_cast<int>(0x80000000u);
  Record rec = reduce(ma, ca, pa ^ kSign, mb, cb, pb ^ kSign, big, 0x7fffffff);
  rec.packed_m ^= kSign;
  rec.packed_c ^= kSign;
  return rec;
}

// Record r of f_out [4, B] (msac_m, count_m, msac_c, count_c) and i_out
// [2, B] (packed_m, packed_c).
__device__ __forceinline__ void write(const Record& rec, int r, int B,
                                      float* f_out, int* i_out) {
  f_out[r] = rec.msac_m;
  f_out[B + r] = rec.count_m;
  f_out[2 * B + r] = rec.msac_c;
  f_out[3 * B + r] = rec.count_c;
  i_out[r] = rec.packed_m;
  i_out[B + r] = rec.packed_c;
}

// reduce, then lane s == 0 of the group writes record r.
__device__ __forceinline__ void reduce_and_write(float ma, float ca, int pa,
                                                 float mb, float cb, int pb,
                                                 float big, int s, int r, int B,
                                                 float* f_out, int* i_out) {
  const Record rec = reduce(ma, ca, pa, mb, cb, pb, big);
  if (s == 0) write(rec, r, B, f_out, i_out);
}

}  // namespace records
