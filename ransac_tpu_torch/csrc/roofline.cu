// Roofline probes for Hopper (sm_90a): the FP32 issue-rate chains and the
// tensor-core product chain.
//
// Replaces the Pallas TPU kernels of ransac_tpu/ops/pallas/roofline.py:
// `_run_chain` (bodies `_fma_kernel` and `_mixed_kernel`) and `_run_mxu`
// (body `_mxu_kernel`).  Each computes what its TPU body computes, from a
// scalar seed, with no input in device memory:
//
// - roofline_chain_kernel, kind 0 (fma): on an [8, 512] tile, element
//   e = r * 512 + c, a = e * 1e-9 + (1 + s * 1e-9), b = e * 1e-12 + 1e-9 and
//   8 chains x_c = e * 1e-6 + 0.1 (c + 1); n_iters trips of 32 steps
//   x_c = fma(x_c, a, b) on every chain; out = x_0 + x_1 + ... + x_7.
//   __fmaf_rn: the probe measures the FMA unit (the plain version rounds
//   x * a + b twice, so the two agree within a tolerance).
// - kind 1 (mixed): thr = e * 1e-9 + (0.5 + s * 1e-9), one = e * 1e-12 +
//   1.000001; n_iters trips of 8 groups x = (x <= thr ? x * one : x + thr),
//   x = min(x, 4 thr) on every chain.  Every operation rounded on its own:
//   bit for bit the plain version.
// - roofline_mxu_kernel: a [512, 512] with a[r][k] = (r - k) 1e-6 + 1e-3 +
//   s 1e-12 and b[k][n] = (n - k) 1e-6 + 1e-3, then n_iters times
//   a = (a @ b) * 1e-3, on the tensor cores in TF32 with float32
//   accumulation (mma.sync m16n8k8).
//
// One [8, 512] tile is 4,096 threads, about one warp per SM, far too few to
// reach the card's issue rate; a TPU tile of the mxu chain is one program.
// So a launch computes `tiles` (`replicas`) independent copies, copy i from
// the seed s + i; copy 0 is the JAX function.  The probes time a launch with
// CUDA events and count the work of every copy.
//
// What bounds them: the chains, FP32 issue (132 SMs x 128 lanes, an FMA
// being 2 FLOPs); each thread runs 8 independent chains to cover the
// latency, and 33 tiles put 32 warps on each SM.  The product chain, the
// tensor cores' TF32 rate: row r of a_{i+1} depends only on row r of a_i,
// so a block owns a 64-row panel of one replica (held in shared memory as
// TF32) and iterates the whole chain with no synchronization between blocks.
// b (1 MB in f32) does not fit in shared memory, but it is a Toeplitz matrix:
// b[k][n] depends on n - k only, so its 1,023 distinct values sit in shared
// memory and a B fragment is one load per element at a fixed offset.  Each
// of the 8 warps owns 64 columns: 4 x 8 tiles of m16n8, 128 accumulators a
// thread.  A simple kernel, not the card's fastest path (wgmma, TMA): that
// is later work.

#include <cuda_runtime.h>

#include "fp32_rn.cuh"

namespace {

constexpr int kSub = 8, kLan = 512, kTile = kSub * kLan;
constexpr int kChains = 8, kUnroll = 32;
constexpr int kChainThreads = 256;

// Decimal constants as Python writes them: the double, rounded to float.
__host__ __device__ constexpr float f32(double x) { return static_cast<float>(x); }

// _lane_pattern(scale, offset) at element e (roofline.py:43-50).
__device__ __forceinline__ float lane_pattern(int e, float scale, float offset) {
  return rt::add(rt::mul(static_cast<float>(e), scale), offset);
}

__global__ void __launch_bounds__(kChainThreads)
roofline_chain_kernel(float seed, int n_iters, int kind,
                      float* __restrict__ out) {  // [tiles, 8, 512]
  using namespace rt;
  const int g = blockIdx.x * kChainThreads + threadIdx.x;
  const int tile = g / kTile, e = g % kTile;
  const float s = add(seed, static_cast<float>(tile));
  float x[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) x[c] = lane_pattern(e, f32(1e-6), f32(0.1 * (c + 1)));
  if (kind == 0) {
    const float a = lane_pattern(e, f32(1e-9), add(1.0f, mul(s, f32(1e-9))));
    const float b = lane_pattern(e, f32(1e-12), f32(1e-9));
    for (int it = 0; it < n_iters; ++it) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int c = 0; c < kChains; ++c) x[c] = __fmaf_rn(x[c], a, b);
      }
    }
  } else {
    const float thr = lane_pattern(e, f32(1e-9), add(0.5f, mul(s, f32(1e-9))));
    const float one = lane_pattern(e, f32(1e-12), f32(1.000001));
    const float thr4 = mul(thr, 4.0f);
    for (int it = 0; it < n_iters; ++it) {
#pragma unroll
      for (int u = 0; u < kUnroll / 4; ++u) {
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          // compare, select of a product and a sum, min; the values stay
          // finite, so fminf is jnp.minimum.
          const float y = x[c] <= thr ? mul(x[c], one) : add(x[c], thr);
          x[c] = fminf(y, thr4);
        }
      }
    }
  }
  float acc = x[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) acc = add(acc, x[c]);
  out[g] = acc;
}

constexpr int kDim = 512;               // m = k = n of the product chain
constexpr int kPanel = 64;              // rows of a per block
constexpr int kPanels = kDim / kPanel;  // blocks per replica
constexpr int kStride = kDim + 4;       // padded panel row (words): conflict-free A loads
constexpr int kMxuThreads = 256;        // 8 warps, 64 columns each
constexpr int kMT = kPanel / 16;        // m16 tiles per warp
constexpr int kNT = 64 / 8;             // n8 tiles per warp
constexpr int kToeplitz = 2 * kDim - 1;
constexpr int kMxuSmem = (kPanel * kStride + kToeplitz) * 4;

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a b for one m16n8k8 tile: TF32 inputs, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kMxuThreads, 1)
roofline_mxu_kernel(float seed, int n_iters,
                    float* __restrict__ out) {  // [replicas, 512, 512]
  using namespace rt;
  extern __shared__ unsigned smem[];
  unsigned* panel = smem;                    // [kPanel][kStride], TF32
  unsigned* toe = smem + kPanel * kStride;   // b[k][n] = toe[n - k + kDim - 1]
  const int replica = blockIdx.x / kPanels;
  const int row0 = (blockIdx.x % kPanels) * kPanel;
  const float s_term = mul(add(seed, static_cast<float>(replica)), f32(1e-12));
  for (int i = threadIdx.x; i < kToeplitz; i += kMxuThreads) {
    toe[i] = to_tf32(add(mul(static_cast<float>(i - (kDim - 1)), f32(1e-6)), f32(1e-3)));
  }
  for (int i = threadIdx.x; i < kPanel * kDim; i += kMxuThreads) {
    const int r = i / kDim, k = i % kDim;
    const float v = add(add(mul(static_cast<float>(row0 + r - k), f32(1e-6)), f32(1e-3)),
                        s_term);
    panel[r * kStride + k] = to_tf32(v);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;   // fragment row group, column pair
  const int col0 = warp * 64;
  float acc[kMT][kNT][4];
  for (int it = 0; it < n_iters; ++it) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;

    for (int k0 = 0; k0 < kDim; k0 += 8) {
      unsigned a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const unsigned* p = panel + (mt * 16 + gq) * kStride + k0 + tq;
        a[mt][0] = p[0];
        a[mt][1] = p[8 * kStride];
        a[mt][2] = p[4];
        a[mt][3] = p[8 * kStride + 4];
      }
      // B fragment: b0 = b[k0 + tq][n], b1 = b[k0 + tq + 4][n], n = col0 + 8 nt + gq.
      const unsigned* tb = toe + (col0 + gq - k0 - tq + kDim - 1);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const unsigned b0 = tb[8 * nt], b1 = tb[8 * nt - 4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) mma_tf32(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();  // every warp is done reading the panel
    const bool last = it + 1 == n_iters;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int r = mt * 16 + gq, c = col0 + 8 * nt + 2 * tq;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int rr = r + (q >> 1) * 8, cc = c + (q & 1);
          const float v = mul(acc[mt][nt][q], f32(1e-3));
          if (last) {
            out[(static_cast<long long>(replica) * kDim + row0 + rr) * kDim + cc] = v;
          } else {
            panel[rr * kStride + cc] = to_tf32(v);
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// C entry points, bound with ctypes.  Each launches on `stream` (PyTorch's
// current stream), does not synchronise, and returns cudaGetLastError().
//
// roofline_chain_launch: kind 0 = fma, 1 = mixed; out [tiles, 8, 512].
extern "C" int roofline_chain_launch(float seed, int n_iters, int kind,
                                     int tiles, float* out, void* stream) {
  if (n_iters < 0 || tiles < 1 || (kind != 0 && kind != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  roofline_chain_kernel<<<tiles * (kTile / kChainThreads), kChainThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(seed, n_iters,
                                                               kind, out);
  return static_cast<int>(cudaGetLastError());
}

// roofline_mxu_launch: n_iters >= 1; out [replicas, 512, 512], the chain's
// final a of each replica (the JAX function returns rows 0-7 of replica 0).
extern "C" int roofline_mxu_launch(float seed, int n_iters, int replicas,
                                   float* out, void* stream) {
  if (n_iters < 1 || replicas < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      roofline_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMxuSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  roofline_mxu_kernel<<<replicas * kPanels, kMxuThreads, kMxuSmem,
                        static_cast<cudaStream_t>(stream)>>>(seed, n_iters, out);
  return static_cast<int>(cudaGetLastError());
}
