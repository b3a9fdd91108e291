"""Host build of the port's per-hypothesis kernel arithmetic.

``ransac_tpu_torch/csrc/sweep.cuh`` and ``sweep_pnp.cuh`` hold the
arithmetic of one hypothesis of the sweep kernels; without ``__CUDACC__``
they compile as plain C++.  ``load()`` builds them with the host C++
compiler (``-ffp-contract=off``: every operation rounded on its own, as
on the card) into a small library that evaluates every hypothesis in the
kernels' full-record order, so the CPU tests can hold the kernels'
arithmetic against the plain PyTorch versions bit for bit.  Returns None
where there is no C++ compiler.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parents[1] / "ransac_tpu_torch" / "csrc"

SHIM = r"""
#include "sweep.cuh"
#include "sweep_pnp.cuh"

extern "C" void sweep_full(const float* src, const float* dst,
    const float* mask, float threshold, const unsigned* seeds, int n_points,
    int n_score, int n_hyp, float* f_out, int* i_out) {
  float ps[3], pd[3];
  sweep::norm_params(src, n_points, ps);
  sweep::norm_params(dst, n_points, pd);
  float sx[16] = {}, sy[16] = {}, dx[16] = {}, dy[16] = {}, w[16] = {};
  for (int i = 0; i < n_score; ++i) {
    sx[i] = rt::mul(rt::sub(src[2 * i], ps[0]), ps[2]);
    sy[i] = rt::mul(rt::sub(src[2 * i + 1], ps[1]), ps[2]);
    dx[i] = rt::mul(rt::sub(dst[2 * i], pd[0]), pd[2]);
    dy[i] = rt::mul(rt::sub(dst[2 * i + 1], pd[1]), pd[2]);
    w[i] = mask[i];
  }
  const sweep::Pool p{sx, sy, dx, dy, w};
  const int vmask = sweep::sample_bitmask(mask, n_score);
  const float thr_sq = sweep::threshold_sq(threshold, pd[2]);
  const float inv_s2 = rt::rcp(rt::mul(pd[2], pd[2]));
  const int B = n_hyp / 8;
  for (int g = 0; g < n_hyp; ++g) {
    const int r = g >> 3, s = g & 7;
    const unsigned flat = (unsigned)((r >> 8) * 2048 + s * 256 + (r & 255));
    const long o = (long)s * B + r;
    float m;
    sweep::eval(flat, seeds, vmask, n_points, n_score, thr_sq, p, &m,
                &f_out[n_hyp + o], &i_out[o]);
    f_out[o] = sweep::rescale(m, inv_s2);
  }
}

extern "C" void sweep_pnp_full(const float* X, const float* f,
    const float* pix, const float* mask, float thr_sq, float ay, int vmask,
    const unsigned* seeds, int n_points, int n_score, int n_hyp, int block_h,
    float* f_out, int* i_out) {
  float a[9][16];
  for (int i = 0; i < 16; ++i) {
    for (int c = 0; c < 3; ++c) { a[c][i] = X[3 * i + c]; a[3 + c][i] = f[3 * i + c]; }
    a[6][i] = pix[2 * i]; a[7][i] = pix[2 * i + 1]; a[8][i] = mask[i];
  }
  const sweep_pnp::Pool p{a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8]};
  const int B = n_hyp / 8, lan = block_h / 8;
  for (int g = 0; g < n_hyp; ++g) {
    const int r = g >> 3, s = g & 7;
    const unsigned flat = (unsigned)((r / lan) * 8 * lan + s * lan + r % lan);
    const long o = (long)s * B + r;
    float m[4], c[4];
    sweep_pnp::eval(flat, seeds, vmask, n_points, n_score, thr_sq, ay, p, m, c,
                    &i_out[o]);
    for (int k = 0; k < 4; ++k) {
      f_out[(long)k * n_hyp + o] = m[k];
      f_out[(long)(4 + k) * n_hyp + o] = c[k];
    }
  }
}
"""


def load(tmp_dir: Path):
    """Build the shim into ``tmp_dir`` and load it (None without g++)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    src = tmp_dir / "kernel_host_shim.cpp"
    lib = tmp_dir / "libkernel_host_shim.so"
    src.write_text(SHIM)
    subprocess.run([cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(CSRC), "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def _p(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def sweep_full(lib, src, dst, mask, threshold: float, seeds, n_points,
               n_hyp):
    """Full records (f [2, n_hyp] = rescaled msac, counts; i [n_hyp]) of
    the homography sweep on raw points, the kernel's prologue included."""
    f = torch.empty((2, n_hyp), dtype=torch.float32)
    i = torch.empty((n_hyp,), dtype=torch.int32)
    s = np.array(seeds, dtype=np.uint32)
    lib.sweep_full(_p(src), _p(dst), _p(mask), ctypes.c_float(threshold),
                   s.ctypes.data_as(ctypes.c_void_p), n_points, src.shape[0],
                   n_hyp, _p(f), _p(i))
    return f, i


def sweep_pnp_full(lib, X_p, f_p, pix_p, mask_p, thr_sq: float, ay: float,
                   vmask: int, seeds, n_points, n_score, n_hyp, block_h):
    """Full records (f [8, n_hyp], i [n_hyp]) of the P3P sweep."""
    f = torch.empty((8, n_hyp), dtype=torch.float32)
    i = torch.empty((n_hyp,), dtype=torch.int32)
    s = np.array(seeds, dtype=np.uint32)
    lib.sweep_pnp_full(_p(X_p), _p(f_p), _p(pix_p), _p(mask_p),
                       ctypes.c_float(thr_sq), ctypes.c_float(ay),
                       ctypes.c_int(vmask), s.ctypes.data_as(ctypes.c_void_p),
                       n_points, n_score, n_hyp, block_h, _p(f), _p(i))
    return f, i
