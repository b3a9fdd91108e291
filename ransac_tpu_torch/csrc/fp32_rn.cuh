// Float32 arithmetic rounded one operation at a time, shared by the sweep
// kernels (sweep.cu, sweep_pnp.cu) and their per-hypothesis headers.
//
// On the device every product, sum, difference and quotient goes through the
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn),
// which nvcc never contracts into an FMA, so a kernel rounds exactly as its
// plain PyTorch version, which runs each operation as its own tensor op.
// min/max propagate NaN as torch.minimum/torch.maximum do (fminf/fmaxf
// would drop it).
//
// Without __CUDACC__ the same helpers are plain C++ float operations, so the
// per-hypothesis headers also build as host code (compiled with
// -ffp-contract=off) and can be held against the plain version on a machine
// without a GPU.  There rsqrt is 1/sqrt rounded twice; on the device it is
// rsqrtf.

#pragma once

#include <math.h>
#include <string.h>

#ifdef __CUDACC__
#define RT_FN __device__ __forceinline__
#else
#define RT_FN inline
#endif

namespace rt {

#ifdef __CUDACC__
RT_FN float mul(float a, float b) { return __fmul_rn(a, b); }
RT_FN float add(float a, float b) { return __fadd_rn(a, b); }
RT_FN float sub(float a, float b) { return __fsub_rn(a, b); }
RT_FN float div(float a, float b) { return __fdiv_rn(a, b); }
RT_FN float sqrt_rn(float a) { return __fsqrt_rn(a); }
RT_FN float rsqrt32(float a) { return rsqrtf(a); }
RT_FN int as_int(float a) { return __float_as_int(a); }
RT_FN float as_float(int a) { return __int_as_float(a); }
#else
RT_FN float mul(float a, float b) { return a * b; }
RT_FN float add(float a, float b) { return a + b; }
RT_FN float sub(float a, float b) { return a - b; }
RT_FN float div(float a, float b) { return a / b; }
RT_FN float sqrt_rn(float a) { return sqrtf(a); }
RT_FN float rsqrt32(float a) { return 1.0f / sqrtf(a); }
RT_FN int as_int(float a) { int i; memcpy(&i, &a, sizeof i); return i; }
RT_FN float as_float(int a) { float f; memcpy(&f, &a, sizeof f); return f; }
#endif

RT_FN float rcp(float a) { return div(1.0f, a); }
RT_FN float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
RT_FN float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
RT_FN float clip(float x, float lo, float hi) {
  return min_nan(max_nan(x, lo), hi);
}

// murmur3 32-bit finalizer (ransac_tpu/ops/pallas/sweep.py:65-72).
RT_FN unsigned fmix(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// K-subset Fisher-Yates of the TPU kernels (sweep.py:89-106): draw
// r_j = fmix(flat ^ seed_j) mod (n - j), unsigned, then shift r_j past each
// earlier pick in ascending order (the picks sorted by an insertion network).
template <int K>
RT_FN void draw_sample(unsigned flat, const unsigned* seeds, int n_points,
                       int* idx) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    int r = static_cast<int>(fmix(flat ^ seeds[j]) %
                             static_cast<unsigned>(n_points - j));
    int sorted[K];
#pragma unroll
    for (int p = 0; p < j; ++p) {
      int ins = idx[p];
#pragma unroll
      for (int q = 0; q < p; ++q) {
        const int lo = sorted[q] < ins ? sorted[q] : ins;
        const int hi = sorted[q] < ins ? ins : sorted[q];
        sorted[q] = lo;
        ins = hi;
      }
      sorted[p] = ins;
    }
#pragma unroll
    for (int q = 0; q < j; ++q) r += (r >= sorted[q]) ? 1 : 0;
    idx[j] = r;
  }
}

}  // namespace rt
