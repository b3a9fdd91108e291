// Float32 arithmetic rounded one operation at a time, shared by the sweep
// kernels (sweep.cu, sweep_pnp.cu, ...) and their per-hypothesis headers.
//
// On the device every product, sum, difference and quotient goes through the
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn),
// which nvcc never contracts into an FMA, so a kernel rounds exactly as its
// plain PyTorch version, which runs each operation as its own tensor op
// (the `Exact` policy; `Fused` places its FMAs explicitly).
// min/max propagate NaN as torch.minimum/torch.maximum do (fminf/fmaxf
// would drop it).
//
// Without __CUDACC__ the same helpers are plain C++ float operations, so the
// per-hypothesis headers also build as host code (compiled with
// -ffp-contract=off) and can be held against the plain version on a machine
// without a GPU.  There rsqrt is 1/sqrt rounded twice; on the device it is
// rsqrtf.
//
// The per-hypothesis headers take their arithmetic from a policy (`Exact`
// or `Fused`, below) where rows 2 and 7 need another rounding than the
// rows that share their algebra.  `Divider` and `draw_sample_fast` draw the
// counter samples without a run-time `%`.

#pragma once

#include <math.h>
#include <string.h>

#ifdef __CUDACC__
#define RT_FN __device__ __forceinline__
#define RT_HD __host__ __device__ __forceinline__
#else
#define RT_FN inline
#define RT_HD inline
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
// `mod(j, h)` is h mod (n - j).
template <int K, class Mod>
RT_FN void draw_sample_with(unsigned flat, const unsigned* seeds, Mod mod,
                            int* idx) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    int r = static_cast<int>(mod(j, fmix(flat ^ seeds[j])));
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

template <int K>
RT_FN void draw_sample(unsigned flat, const unsigned* seeds, int n_points,
                       int* idx) {
  draw_sample_with<K>(
      flat, seeds,
      [n_points](int j, unsigned h) {
        return h % static_cast<unsigned>(n_points - j);
      },
      idx);
}

// n / d and n mod d for every 32-bit n by one multiply-high: Granlund and
// Montgomery's round-up method with the add fix-up (1994, fig. 4.1), exact
// for 1 <= d <= 2^31.  make_divider runs once per call, on the host.
struct Divider {
  unsigned d, m;
  int s1, s2;
};

RT_HD Divider make_divider(unsigned d) {
  int l = 0;  // ceil(log2 d)
  while ((1ull << l) < d) ++l;
  Divider v;
  v.d = d;
  v.m = static_cast<unsigned>(((1ull << 32) * ((1ull << l) - d)) / d + 1);
  v.s1 = l < 1 ? l : 1;
  v.s2 = l < 1 ? 0 : l - 1;
  return v;
}

RT_HD unsigned umulhi(unsigned a, unsigned b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return static_cast<unsigned>((static_cast<unsigned long long>(a) * b) >> 32);
#endif
}

RT_HD unsigned udiv(unsigned n, const Divider& v) {
  const unsigned t = umulhi(n, v.m);
  return (t + ((n - t) >> v.s1)) >> v.s2;
}

RT_HD unsigned umod(unsigned n, const Divider& v) { return n - udiv(n, v) * v.d; }

// draw_sample with divs[j] = make_divider(n_points - j): the same samples.
template <int K>
RT_FN void draw_sample_fast(unsigned flat, const unsigned* seeds,
                            const Divider* divs, int* idx) {
  draw_sample_with<K>(
      flat, seeds, [divs](int j, unsigned h) { return umod(h, divs[j]); }, idx);
}

// The arithmetic policies of the per-hypothesis headers.  `Exact` rounds
// every operation on its own, in the plain versions' order, as every kernel
// but rows 2 and 7 does.  `Fused` (the kernels of rows 2 and 7)
// rounds each product-sum once: __fmaf_rn on the card, fmaf on the host (the
// host build runs with -ffp-contract=off, so the source fixes the rounding on
// both), takes MUFU's reciprocal, rcp.approx.ftz.f32 (at most 1 ulp off;
// its inputs are never subnormal), where the TPU kernels took
// pl.reciprocal(approx=True), and the NaN-propagating min and max as one
// instruction each (min.NaN / max.NaN: the same values as min_nan and
// max_nan).  The host build's Fused reciprocal is the exact 1 / x.
struct Exact {
  static constexpr bool kFused = false;
  static RT_FN float mul(float a, float b) { return rt::mul(a, b); }
  static RT_FN float add(float a, float b) { return rt::add(a, b); }
  static RT_FN float sub(float a, float b) { return rt::sub(a, b); }
  // a b + c
  static RT_FN float mad(float a, float b, float c) { return add(mul(a, b), c); }
  // a b - c d
  static RT_FN float prod_diff(float a, float b, float c, float d) {
    return sub(mul(a, b), mul(c, d));
  }
  // a b + c d
  static RT_FN float prod_sum(float a, float b, float c, float d) {
    return add(mul(a, b), mul(c, d));
  }
  // a x + b y + c
  static RT_FN float dot_add(float a, float x, float b, float y, float c) {
    return add(add(mul(a, x), mul(b, y)), c);
  }
  static RT_FN float rcp(float a) { return rt::rcp(a); }
  // a / b: the IEEE quotient
  static RT_FN float quot(float a, float b) { return div(a, b); }
  static RT_FN float min(float a, float b) { return min_nan(a, b); }
  static RT_FN float max(float a, float b) { return max_nan(a, b); }
};

struct Fused {
  static constexpr bool kFused = true;
  static RT_FN float mul(float a, float b) { return rt::mul(a, b); }
  static RT_FN float add(float a, float b) { return rt::add(a, b); }
  static RT_FN float sub(float a, float b) { return rt::sub(a, b); }
  static RT_FN float mad(float a, float b, float c) {
#ifdef __CUDACC__
    return __fmaf_rn(a, b, c);
#else
    return fmaf(a, b, c);
#endif
  }
  static RT_FN float prod_diff(float a, float b, float c, float d) {
    return mad(a, b, -mul(c, d));
  }
  static RT_FN float prod_sum(float a, float b, float c, float d) {
    return mad(a, b, mul(c, d));
  }
  static RT_FN float dot_add(float a, float x, float b, float y, float c) {
    return mad(a, x, mad(b, y, c));
  }
  static RT_FN float rcp(float a) {
#ifdef __CUDACC__
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
    return r;
#else
    return 1.0f / a;
#endif
  }
  // a / b as a times MUFU's reciprocal of b
  static RT_FN float quot(float a, float b) { return mul(a, rcp(b)); }
  // min_nan / max_nan as one FMNMX.NAN each (sm_80 and later).
  static RT_FN float min(float a, float b) {
#ifdef __CUDACC__
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
#else
    return min_nan(a, b);
#endif
  }
  static RT_FN float max(float a, float b) {
#ifdef __CUDACC__
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
#else
    return max_nan(a, b);
#endif
  }
};

}  // namespace rt
