// Block-reduced records of the sweep kernels (sweep.cu, sweep_pnp.cu, the
// large-pool sweeps and sweep_essential.cu).
//
// The TPU kernels reduce each lane's 8 sublanes to two records: row 0 by
// min MSAC, then the smallest packed sample, then that sample's max count;
// row 1 by max count, then min MSAC, then the smallest packed sample
// (ransac_tpu/ops/pallas/sweep.py:217-237).  Here the 8 hypotheses of a
// record are 8 / K neighbouring lanes of a warp holding K each (K = 1 but in
// rows 2 and 7); register reductions and xor shuffles give each lane the
// group's min or max, and the selections are made exactly as the TPU's
// (NaN-propagating min/max, as jnp.min/jnp.max).

#pragma once

#include "fp32_rn.cuh"

namespace records {

// A record's 8 hypotheses sit in 8 / K neighbouring lanes, K in registers
// each: the K values are reduced in registers, then log2(8 / K) xor shuffles
// give every lane of the group the result.  min and max are exact and
// associative, so the order does not change a record.
template <int K>
__device__ __forceinline__ float group_min(const float* v) {
  float m = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = rt::min_nan(m, v[k]);
#pragma unroll
  for (int off = 1; off < 8 / K; off <<= 1)
    m = rt::min_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

template <int K>
__device__ __forceinline__ float group_max(const float* v) {
  float m = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = rt::max_nan(m, v[k]);
#pragma unroll
  for (int off = 1; off < 8 / K; off <<= 1)
    m = rt::max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

template <int K>
__device__ __forceinline__ int group_min_int(const int* v) {
  int m = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) m = min(m, v[k]);
#pragma unroll
  for (int off = 1; off < 8 / K; off <<= 1)
    m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// The two records of a group of eight hypotheses.
struct Record {
  float msac_m, count_m, msac_c, count_c;
  int packed_m, packed_c;
};

// Reduce the group's (ma, ca, pa) by the MSAC rule and (mb, cb, pb) by the
// count rule, K hypotheses a lane; ties go to the smallest sample key, and
// `sentinel` stands for a hypothesis that is not selected.  Every lane of
// the warp must call it; every lane of the group gets the group's records.
template <int K>
__device__ __forceinline__ Record reduce_k(const float* ma, const float* ca,
                                           const int* pa, const float* mb,
                                           const float* cb, const int* pb,
                                           float big, int sentinel) {
  Record rec;
  float f[K];
  int p[K];
  rec.msac_m = group_min<K>(ma);
#pragma unroll
  for (int k = 0; k < K; ++k) p[k] = ma[k] == rec.msac_m ? pa[k] : sentinel;
  rec.packed_m = group_min_int<K>(p);
#pragma unroll
  for (int k = 0; k < K; ++k)
    f[k] = ma[k] == rec.msac_m && pa[k] == rec.packed_m ? ca[k] : -2.0f;
  rec.count_m = group_max<K>(f);
  rec.count_c = group_max<K>(cb);
#pragma unroll
  for (int k = 0; k < K; ++k) f[k] = cb[k] == rec.count_c ? mb[k] : big;
  rec.msac_c = group_min<K>(f);
#pragma unroll
  for (int k = 0; k < K; ++k)
    p[k] = cb[k] == rec.count_c && mb[k] == rec.msac_c ? pb[k] : sentinel;
  rec.packed_c = group_min_int<K>(p);
  return rec;
}

// reduce_k with one hypothesis a lane (eight lanes a record).
__device__ __forceinline__ Record reduce(float ma, float ca, int pa, float mb,
                                         float cb, int pb, float big,
                                         int sentinel = 1 << 30) {
  return reduce_k<1>(&ma, &ca, &pa, &mb, &cb, &pb, big, sentinel);
}

// reduce_k of K (msac, count, packed) a lane under both rules, with the
// packed samples ordered as unsigned 32-bit integers, as the 8-point sweep
// orders them (ransac_tpu/ops/pallas/sweep_essential.py:272-286): its eight
// 4-bit indices fill the int, so a sample whose last index is 8 or more is
// negative as a signed value.  The keys are the samples with the sign bit
// flipped, compared signed, and the sentinel is 2^31 - 1 (the unsigned
// 0xFFFFFFFF, which no sample of distinct indices reaches).
template <int K>
__device__ __forceinline__ Record reduce_unsigned(const float* m, const float* c,
                                                  const int* p, float big) {
  constexpr int kSign = static_cast<int>(0x80000000u);
  int key[K];
#pragma unroll
  for (int k = 0; k < K; ++k) key[k] = p[k] ^ kSign;
  Record rec = reduce_k<K>(m, c, key, m, c, key, big, 0x7fffffff);
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
