// One problem of the batched Levenberg-Marquardt kernels: the LMs of the
// engines' two refits, `ransac_tpu_torch.ops.lm.refine_homography` (8
// parameters, h33 = 1, forward transfer error; run on the card inside the
// fused homography refit, csrc/refit.cu) and `refine_pose` (6 parameters,
// rotation vector then translation, reprojection error; csrc/lm.cu and the
// fused pose refit).
//
// The arithmetic is that of the plain loop (`ops.lm.levenberg_marquardt`
// with `_homography_residuals` / `_pose_residuals`), in float32:
// - the residuals are written once, for a scalar type T, from the same
//   expressions as `apply_h` (w guarded at |w| < 1e-12) and `exp_so3`
//   (theta = sqrt(theta2 + eps^2) - eps, the Taylor branch below theta2 =
//   1e-8) with `project_points` (1 / z guarded);
// - with T = Dual<n> they carry the n forward-mode tangents of x, which is
//   what `vmap(jacfwd)` computes: a guarded or branched region gets the
//   derivative of the branch taken;
// - the step solves (H + lam clamp(diag H, 1e-12)) dx = -g by
//   `solve_unrolled`'s elimination (first maximum of |pivot|, the row swap
//   as its one-hot blend, pivots and the back substitution's divisors
//   guarded at 1e-12);
// - accept, damping and done are `levenberg_marquardt`'s, at its defaults.
// Every operation rounds on its own (fp32_rn.cuh: no FMA, IEEE division
// and square root), so non-finite values propagate as in torch.  Sums are
// the lanes': lane l takes points l, l + 32, ... in order and a butterfly
// of 32 lanes adds their shares (`WarpLanes` on the card, `SerialLanes` here),
// where torch's matrix products and sums add in their own order.  So the
// two agree to float32 rounding along the trajectory, not bit for bit.
//
// Without __CUDACC__ this builds as host C++ (the CPU tests hold it against
// the plain loop).

#pragma once

#include "fp32_rn.cuh"

namespace lm {

constexpr int kLanes = 32;
// levenberg_marquardt's defaults, which refine_homography and refine_pose use.
constexpr float kDampingInit = 1e-3f;
constexpr float kDampingUp = 10.0f;
constexpr float kDampingDown = 0.1f;
constexpr float kRtol = 1e-10f;
constexpr float kDampingMax = 1e8f;
constexpr float kGuard = 1e-12f;

// A value and its N forward-mode tangents.
template <int N>
struct Dual {
  float v;
  float d[N];
};

// The operations of the residuals on float and on Dual<N>; a float operand
// of a Dual operation is a constant (no tangent).
RT_FN float value(float a) { return a; }
template <int N> RT_FN float value(const Dual<N>& a) { return a.v; }

template <class T> struct Lift { static RT_FN T of(float c) { return c; } };
template <int N> struct Lift<Dual<N>> {
  static RT_FN Dual<N> of(float c) {
    Dual<N> r;
    r.v = c;
    for (int k = 0; k < N; ++k) r.d[k] = 0.0f;
    return r;
  }
};

RT_FN float add(float a, float b) { return rt::add(a, b); }
RT_FN float sub(float a, float b) { return rt::sub(a, b); }
RT_FN float mul(float a, float b) { return rt::mul(a, b); }
RT_FN float div(float a, float b) { return rt::div(a, b); }
RT_FN float neg(float a) { return -a; }
RT_FN float sqrt_of(float a) { return rt::sqrt_rn(a); }
RT_FN float sin_of(float a) { return sinf(a); }
RT_FN float cos_of(float a) { return cosf(a); }

template <int N> RT_FN Dual<N> add(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = rt::add(a.v, b.v);
  for (int k = 0; k < N; ++k) r.d[k] = rt::add(a.d[k], b.d[k]);
  return r;
}
template <int N> RT_FN Dual<N> add(const Dual<N>& a, float c) {
  Dual<N> r = a;
  r.v = rt::add(a.v, c);
  return r;
}
template <int N> RT_FN Dual<N> add(float c, const Dual<N>& a) {
  Dual<N> r = a;
  r.v = rt::add(c, a.v);
  return r;
}
template <int N> RT_FN Dual<N> sub(const Dual<N>& a, float c) {
  Dual<N> r = a;
  r.v = rt::sub(a.v, c);
  return r;
}
template <int N> RT_FN Dual<N> sub(float c, const Dual<N>& a) {
  Dual<N> r;
  r.v = rt::sub(c, a.v);
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}
template <int N> RT_FN Dual<N> neg(const Dual<N>& a) {
  Dual<N> r;
  r.v = -a.v;
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}
// (a b)' = a' b + a b'.
template <int N> RT_FN Dual<N> mul(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = rt::mul(a.v, b.v);
  for (int k = 0; k < N; ++k)
    r.d[k] = rt::add(rt::mul(a.d[k], b.v), rt::mul(a.v, b.d[k]));
  return r;
}
template <int N> RT_FN Dual<N> mul(const Dual<N>& a, float c) {
  Dual<N> r;
  r.v = rt::mul(a.v, c);
  for (int k = 0; k < N; ++k) r.d[k] = rt::mul(a.d[k], c);
  return r;
}
template <int N> RT_FN Dual<N> mul(float c, const Dual<N>& a) {
  Dual<N> r;
  r.v = rt::mul(c, a.v);
  for (int k = 0; k < N; ++k) r.d[k] = rt::mul(c, a.d[k]);
  return r;
}
// (a / b)' = (a' - b' (a / b)) / b.
template <int N> RT_FN Dual<N> div(const Dual<N>& a, const Dual<N>& b) {
  Dual<N> r;
  r.v = rt::div(a.v, b.v);
  for (int k = 0; k < N; ++k)
    r.d[k] = rt::div(rt::sub(a.d[k], rt::mul(b.d[k], r.v)), b.v);
  return r;
}
template <int N> RT_FN Dual<N> div(const Dual<N>& a, float c) {
  Dual<N> r;
  r.v = rt::div(a.v, c);
  for (int k = 0; k < N; ++k) r.d[k] = rt::div(a.d[k], c);
  return r;
}
// 1 / a (torch's reciprocal); (1 / a)' = -a' (1 / a) (1 / a).
RT_FN float rcp(float a) { return rt::div(1.0f, a); }
template <int N> RT_FN Dual<N> rcp(const Dual<N>& a) {
  Dual<N> r;
  r.v = rt::div(1.0f, a.v);
  for (int k = 0; k < N; ++k) r.d[k] = rt::mul(rt::mul(-a.d[k], r.v), r.v);
  return r;
}
// sqrt(a)' = a' / (2 sqrt(a)).
template <int N> RT_FN Dual<N> sqrt_of(const Dual<N>& a) {
  Dual<N> r;
  r.v = rt::sqrt_rn(a.v);
  const float twice = rt::mul(2.0f, r.v);
  for (int k = 0; k < N; ++k) r.d[k] = rt::div(a.d[k], twice);
  return r;
}
template <int N> RT_FN Dual<N> sin_of(const Dual<N>& a) {
  Dual<N> r;
  r.v = sinf(a.v);
  const float c = cosf(a.v);
  for (int k = 0; k < N; ++k) r.d[k] = rt::mul(a.d[k], c);
  return r;
}
template <int N> RT_FN Dual<N> cos_of(const Dual<N>& a) {
  Dual<N> r;
  r.v = cosf(a.v);
  const float s = -sinf(a.v);
  for (int k = 0; k < N; ++k) r.d[k] = rt::mul(a.d[k], s);
  return r;
}

// `_guard(x, eps)`: eps (a constant) where |x| < eps, else x.
template <class T> RT_FN T guard(const T& a) {
  return fabsf(value(a)) < kGuard ? Lift<T>::of(kGuard) : a;
}

// ------------------------------------------------------------------ models
// The models' weights w_i are W (float, or bool: an inlier mask as 0 / 1).
//
// `_homography_residuals` of one problem: x = (h11 .. h32), h33 = 1; point
// i's residuals ((u - dst_x) w_i, (v - dst_y) w_i) of (u, v) = apply_h.
template <class W>
struct HomographyOf {
  static constexpr int kParams = 8;
  static constexpr int kFrame = 8;  // the residuals' per-problem values: x
  const float* src;  // [n, 2]
  const float* dst;  // [n, 2]
  const W* w;        // [n]
  int n;

  template <class T> RT_FN void frame(const T* x, T* f) const {
    for (int k = 0; k < kFrame; ++k) f[k] = x[k];
  }

  template <class T> RT_FN void residuals(const T* h, int i, T* r) const {
    const float x = src[2 * i], y = src[2 * i + 1], wi = static_cast<float>(w[i]);
    const T den = guard(add(add(mul(h[6], x), mul(h[7], y)), 1.0f));
    const T u = div(add(add(mul(h[0], x), mul(h[1], y)), h[2]), den);
    const T v = div(add(add(mul(h[3], x), mul(h[4], y)), h[5]), den);
    r[0] = mul(sub(u, dst[2 * i]), wi);
    r[1] = mul(sub(v, dst[2 * i + 1]), wi);
  }
};

// `exp_so3` of the rotation vector r: R [9] row-major.
template <class T> RT_FN void exp_so3(const T* r, T* R) {
  const T theta2 = add(add(mul(r[0], r[0]), mul(r[1], r[1])), mul(r[2], r[2]));
  const T theta = sub(sqrt_of(add(theta2, 1e-16f)), 1e-8f);
  const bool small = value(theta2) < 1e-8f;
  const T a = small ? sub(1.0f, div(theta2, 6.0f)) : div(sin_of(theta), theta);
  const T b = small ? sub(0.5f, div(theta2, 24.0f))
                    : div(sub(1.0f, cos_of(theta)), theta2);
  const T zero = Lift<T>::of(0.0f);
  const T K[9] = {zero, neg(r[2]), r[1], r[2], zero, neg(r[0]), neg(r[1]), r[0], zero};
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const T kk = add(add(mul(K[3 * i], K[j]), mul(K[3 * i + 1], K[3 + j])),
                       mul(K[3 * i + 2], K[6 + j]));
      R[3 * i + j] = add(add(i == j ? 1.0f : 0.0f, mul(a, K[3 * i + j])), mul(b, kk));
    }
  }
}

// `_pose_residuals` of one problem: x = (rvec, tvec); point i's residuals
// ((u - pixel_x) w_i, (v - pixel_y) w_i) of `project_points` with K.
template <class W>
struct PoseOf {
  static constexpr int kParams = 6;
  static constexpr int kFrame = 12;  // R row-major, then t
  const float* X;    // [n, 3]
  const float* pix;  // [n, 2]
  const float* K;    // [3, 3]
  const W* w;        // [n]
  int n;

  template <class T> RT_FN void frame(const T* x, T* f) const {
    exp_so3(x, f);
    for (int k = 0; k < 3; ++k) f[9 + k] = x[3 + k];
  }

  template <class T> RT_FN void residuals(const T* f, int i, T* r) const {
    const float* p = X + 3 * i;
    T c[3];
    for (int j = 0; j < 3; ++j)
      c[j] = add(add(add(mul(p[0], f[3 * j]), mul(p[1], f[3 * j + 1])),
                     mul(p[2], f[3 * j + 2])), f[9 + j]);
    const T inv_z = rcp(guard(c[2]));
    const T u = add(mul(K[0], mul(c[0], inv_z)), K[2]);
    const T v = add(mul(K[4], mul(c[1], inv_z)), K[5]);
    const float wi = static_cast<float>(w[i]);
    r[0] = mul(sub(u, pix[2 * i]), wi);
    r[1] = mul(sub(v, pix[2 * i + 1]), wi);
  }
};
using Pose = PoseOf<float>;

// ------------------------------------------------------------ lane shares
// Entries of the normal equations a lane accumulates: g [n], then the upper
// triangle of J^T J row by row [n (n + 1) / 2].
template <class M>
constexpr int kTerms = M::kParams + M::kParams * (M::kParams + 1) / 2;

// Lane `lane`'s share of sum r^2 at x.
template <class M> RT_FN float cost_share(const M& m, const float* x, int lane) {
  float f[M::kFrame];
  m.frame(x, f);
  float s = 0.0f;
  for (int i = lane; i < m.n; i += kLanes) {
    float r[2];
    m.residuals(f, i, r);
    s = rt::add(rt::add(s, rt::mul(r[0], r[0])), rt::mul(r[1], r[1]));
  }
  return s;
}

// The residuals r [2] and their Jacobian rows J [2][n] at x of point i.
template <class M>
RT_FN void jacobian_rows(const M& m, const Dual<M::kParams>* f, int i,
                         float* r, float (*J)[M::kParams]) {
  Dual<M::kParams> rd[2];
  m.residuals(f, i, rd);
  for (int c = 0; c < 2; ++c) {
    r[c] = rd[c].v;
    for (int k = 0; k < M::kParams; ++k) J[c][k] = rd[c].d[k];
  }
}

// x with its tangents (x_k's the k-th unit vector), through the frame.
template <class M>
RT_FN void dual_frame(const M& m, const float* x, Dual<M::kParams>* f) {
  constexpr int N = M::kParams;
  Dual<N> xd[N];
  for (int j = 0; j < N; ++j) {
    xd[j].v = x[j];
    for (int k = 0; k < N; ++k) xd[j].d[k] = j == k ? 1.0f : 0.0f;
  }
  m.frame(xd, f);
}

// Lane `lane`'s share of (g = J^T r, J^T J upper) at x: acc [kTerms<M>].
template <class M> RT_FN void normal_share(const M& m, const float* x, int lane, float* acc) {
  constexpr int N = M::kParams;
  Dual<N> f[M::kFrame];
  dual_frame(m, x, f);
  for (int k = 0; k < kTerms<M>; ++k) acc[k] = 0.0f;
  for (int i = lane; i < m.n; i += kLanes) {
    float r[2], J[2][N];
    jacobian_rows(m, f, i, r, J);
    for (int c = 0; c < 2; ++c) {
      for (int j = 0; j < N; ++j) acc[j] = rt::add(acc[j], rt::mul(J[c][j], r[c]));
      int t = N;
      for (int j = 0; j < N; ++j)
        for (int l = j; l < N; ++l, ++t) acc[t] = rt::add(acc[t], rt::mul(J[c][j], J[c][l]));
    }
  }
}

// The butterfly of the lanes' shares v [kLanes][K], one lane after another:
// at offsets 16, 8, 4, 2, 1 lane l adds lane l ^ offset's value to its own,
// as the card's __shfl_xor_sync tree does; every lane ends with the same
// sums (the addition commutes), returned in out [K].
template <int K> RT_FN void butterfly(float (*v)[K], float* out) {
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    float next[kLanes][K];
    for (int l = 0; l < kLanes; ++l)
      for (int k = 0; k < K; ++k) next[l][k] = rt::add(v[l][k], v[l ^ off][k]);
    for (int l = 0; l < kLanes; ++l)
      for (int k = 0; k < K; ++k) v[l][k] = next[l][k];
  }
  for (int k = 0; k < K; ++k) out[k] = v[0][k];
}

// The lanes' policies.  `sum<K>(share, out)`: each lane's share of K sums
// (share(lane, acc) adds lane's points into acc [K], zeroed first), then
// the butterfly, which leaves out [K] the same in every lane.
// `rows(n, f)`: f(r) for r < n, row r in lane r % 32, where f(r) writes
// only what no other row's f reads; then the lanes meet (`sync`).
#ifdef __CUDACC__
// The lanes of one warp (csrc/lm.cu, csrc/refit.cu): one after another in
// the butterfly as __shfl_xor_sync adds them.
struct WarpLanes {
  int lane;

  template <int K, class F> __device__ __forceinline__ void sum(F share, float* out) const {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = 0.0f;
    share(lane, out);
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) out[k] = rt::add(out[k], __shfl_xor_sync(0xffffffffu, out[k], off));
    }
  }
  template <class F> __device__ __forceinline__ void rows(int n, F f) const {
    for (int r = lane; r < n; r += kLanes) f(r);
    __syncwarp();
  }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
};
#else
// The 32 lanes of a warp run one after another (the host build).
struct SerialLanes {
  template <int K, class F> void sum(F share, float* out) const {
    float v[kLanes][K];
    for (int l = 0; l < kLanes; ++l) {
      for (int k = 0; k < K; ++k) v[l][k] = 0.0f;
      share(l, v[l]);
    }
    butterfly<K>(v, out);
  }
  template <class F> void rows(int n, F f) const {
    for (int r = 0; r < n; ++r) f(r);
  }
  void sync() const {}
};
#endif

// sum r^2 at x, and (g = J^T r, J^T J upper) at x into acc [kTerms<M>].
template <class M, class Lanes> RT_FN float cost(const M& m, const float* x, const Lanes& lanes) {
  float out[1];
  lanes.template sum<1>([&](int l, float* a) { a[0] = cost_share(m, x, l); }, out);
  return out[0];
}
template <class M, class Lanes>
RT_FN void normal(const M& m, const float* x, float* acc, const Lanes& lanes) {
  lanes.template sum<kTerms<M>>([&](int l, float* a) { normal_share(m, x, l, a); }, acc);
}

// ------------------------------------------------------------------- step
// `solve_unrolled`'s elimination of the augmented M [N][N + 1] (A, then b)
// into x [N]: the pivot row the first maximum of |M[r][k]|, r >= k (a NaN
// the maximum, as torch.argmax takes it), the row swap as its one-hot blend,
// pivots and the back substitution's divisors guarded at 1e-12.
template <int N> RT_FN void eliminate(float (&M)[N][N + 1], float* x) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int piv = k;
    float best = fabsf(M[k][k]);
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      const float a = fabsf(M[r][k]);
      if (best == best && (a != a || a > best)) {
        piv = r;
        best = a;
      }
    }
    float prow[N + 1], rowk[N + 1];
#pragma unroll
    for (int j = k; j <= N; ++j) {
      rowk[j] = M[k][j];
      prow[j] = M[k][j];
#pragma unroll
      for (int r = k + 1; r < N; ++r)
        if (r == piv) prow[j] = M[r][j];
    }
    // The swap as solve_unrolled's one-hot blend: rows - sel (pivot - row k).
#pragma unroll
    for (int r = k; r < N; ++r) {
      const float sel = r == piv ? 1.0f : 0.0f;
#pragma unroll
      for (int j = k; j <= N; ++j)
        M[r][j] = rt::sub(M[r][j], rt::mul(sel, rt::sub(prow[j], rowk[j])));
    }
    const float inv = rt::div(1.0f, guard(prow[k]));
#pragma unroll
    for (int r = k + 1; r < N; ++r) {
      const float f = rt::mul(M[r][k], inv);
#pragma unroll
      for (int j = k; j <= N; ++j) M[r][j] = rt::sub(M[r][j], rt::mul(f, prow[j]));
    }
#pragma unroll
    for (int j = k; j <= N; ++j) M[k][j] = prow[j];
  }
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    float rhs = M[k][N];
    if (k + 1 < N) {
      float s = rt::mul(M[k][k + 1], x[k + 1]);
#pragma unroll
      for (int j = k + 2; j < N; ++j) s = rt::add(s, rt::mul(M[k][j], x[j]));
      rhs = rt::sub(rhs, s);
    }
    x[k] = rt::mul(rhs, rt::div(1.0f, guard(M[k][k])));
  }
}

// dx solving (H + lam clamp(diag H, 1e-12)) dx = -g, from acc (g, then the
// upper triangle of H).
template <int N> RT_FN void solve_step(const float* acc, float lam, float* dx) {
  float M[N][N + 1];
  int t = N;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int l = j; l < N; ++l, ++t) {
      M[j][l] = acc[t];
      M[l][j] = acc[t];
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    M[j][j] = rt::add(M[j][j], rt::mul(lam, rt::max_nan(M[j][j], kGuard)));
    M[j][N] = -acc[j];
  }
  eliminate<N>(M, dx);
}

// ------------------------------------------------------------------- loop
struct State {
  float cost;
  float lam;
  int iterations;
  bool done;
};

// The whole LM of one problem from x (updated in place): at most max_iters
// passes, each the normal equations at x, the step, the trial cost at
// x + dx and `levenberg_marquardt`'s accept, damping and done; a done
// problem no longer changes, so it leaves the loop.  `lanes` gives the
// warp's sums.
template <class M, class Lanes>
RT_FN State run(const M& m, float* x, int max_iters, const Lanes& lanes) {
  constexpr int N = M::kParams;
  State s{rt::mul(0.5f, cost(m, x, lanes)), kDampingInit, 0, false};
  for (int p = 0; p < max_iters && !s.done; ++p) {
    float acc[kTerms<M>], dx[N], x_new[N];
    normal(m, x, acc, lanes);
    solve_step<N>(acc, s.lam, dx);
    for (int k = 0; k < N; ++k) x_new[k] = rt::add(x[k], dx[k]);
    const float cost_new = rt::mul(0.5f, cost(m, x_new, lanes));
    const bool accept = cost_new < s.cost;
    const float lam_new = accept
        ? rt::max_nan(rt::mul(s.lam, kDampingDown), 1e-12f)
        : rt::min_nan(rt::mul(s.lam, kDampingUp), kDampingMax);
    const bool improved = fabsf(rt::sub(s.cost, cost_new))
        <= rt::mul(kRtol, rt::max_nan(s.cost, 1e-30f));
    if (accept) {
      for (int k = 0; k < N; ++k) x[k] = x_new[k];
      s.cost = cost_new;
    }
    s.lam = lam_new;
    s.done = (accept && improved) || lam_new >= kDampingMax;
    ++s.iterations;
  }
  return s;
}

// refine_homography's start: H0 [9] row-major over h33 (1 where |h33| <
// 1e-12), its first 8 entries.
RT_FN void homography_start(const float* H0, float* x) {
  const float h33 = fabsf(H0[8]) < kGuard ? 1.0f : H0[8];
  for (int k = 0; k < 8; ++k) x[k] = rt::div(H0[k], h33);
}

}  // namespace lm
