"""Fused RANSAC scoring: the CUDA kernels' wrappers and their plain
PyTorch versions.

Port of ``ransac_tpu.ops.pallas.score``: given H models and N <= 16
correspondences, per-model inlier counts and truncated MSAC scores
without an [H, N] residual tensor in device memory.  ``homography_scores``
takes models [H,3,3] and divides by w exactly (|w| < 1e-12 guarded);
``pnp_scores`` takes poses [H,12] (R row-major, then t) with normalized
pixel coordinates, and points at z <= 1e-6 score e^2 = 1e12.  Counts
exclude masked points.

For CPU tensors the wrappers compute the plain versions; for CUDA tensors
they launch ``csrc/score.cu`` or raise.  Kernel and plain version agree
bit for bit on the same inputs.  ``homography_scores_ref`` and
``pnp_scores_ref`` are the engine-path formulations (residual, then
square), as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops.homography import transfer_errors
from ransac_tpu_torch.ops.sweep import check_inputs

MAX_POINTS = 16

#: Kernel launches in this process, per kernel.  Only the CUDA path adds to
#: them, one per launch; the plain versions never do.
LAUNCHES = {"homography_scores": 0, "pnp_scores": 0}


def _pad_points(pts, mask, width):
    n = pts.shape[0]
    if n > MAX_POINTS:
        raise ValueError(f"at most {MAX_POINTS} points, got {n}")
    pts_p = pts.new_zeros((MAX_POINTS, width), dtype=torch.float32)
    pts_p[:n, :pts.shape[1]] = pts
    mask_p = pts.new_zeros((MAX_POINTS,), dtype=torch.float32)
    mask_p[:n] = mask.to(torch.float32)
    return pts_p, mask_p


def _thr_sq(threshold) -> float:
    t = np.float32(float(threshold))  # a number or a 0-d tensor on any device
    return float(t * t)


def _h_plain(m, src_p, dst_p, mask_p, thr_sq):
    """Per-model score loop over the 16 padded points (score.py:53-75)."""
    count = torch.zeros_like(m[:, 0])
    msac = torch.zeros_like(m[:, 0])
    for n in range(MAX_POINTS):
        x, y = src_p[n, 0], src_p[n, 1]
        u = m[:, 0] * x + m[:, 1] * y + m[:, 2]
        v = m[:, 3] * x + m[:, 4] * y + m[:, 5]
        w = m[:, 6] * x + m[:, 7] * y + m[:, 8]
        inv_w = 1.0 / torch.where(w.abs() < 1e-12, 1e-12, w)
        du = u * inv_w - dst_p[n, 0]
        dv = v * inv_w - dst_p[n, 1]
        e2 = du * du + dv * dv
        count = count + torch.where(e2 <= thr_sq, 1.0, 0.0) * mask_p[n]
        msac = msac + torch.clamp(e2, max=thr_sq) * mask_p[n]
    return count, msac


def _pnp_plain(m, X_p, pix_p, mask_p, thr_sq):
    """Per-pose score loop over the 16 padded points (score.py:118-144)."""
    count = torch.zeros_like(m[:, 0])
    msac = torch.zeros_like(m[:, 0])
    for n in range(MAX_POINTS):
        X, Y, Z = X_p[n, 0], X_p[n, 1], X_p[n, 2]
        xc = m[:, 0] * X + m[:, 1] * Y + m[:, 2] * Z + m[:, 9]
        yc = m[:, 3] * X + m[:, 4] * Y + m[:, 5] * Z + m[:, 10]
        zc = m[:, 6] * X + m[:, 7] * Y + m[:, 8] * Z + m[:, 11]
        behind = zc <= 1e-6
        inv_z = 1.0 / torch.where(behind, 1.0, zc)
        du = xc * inv_z - pix_p[n, 0]
        dv = yc * inv_z - pix_p[n, 1]
        e2 = torch.where(behind, 1e12, du * du + dv * dv)
        count = count + torch.where(e2 <= thr_sq, 1.0, 0.0) * mask_p[n]
        msac = msac + torch.clamp(e2, max=thr_sq) * mask_p[n]
    return count, msac


def _launch(name, m, pts_p, pix_p, mask_p, thr_sq):
    """Launch ``<name>_launch`` of ``csrc/score.cu`` on the current stream."""
    dev = m.device
    check_inputs(name, dev, models=(m, torch.float32),
                 points=(pts_p, torch.float32), pixels=(pix_p, torch.float32),
                 mask=(mask_p, torch.float32))
    H = m.shape[0]
    count = torch.empty(H, dtype=torch.float32, device=dev)
    msac = torch.empty(H, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(_build.load(), f"{name}_launch")(
            m.data_ptr(), pts_p.data_ptr(), pix_p.data_ptr(), mask_p.data_ptr(),
            thr_sq, H, count.data_ptr(), msac.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}_launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return count, msac


def _h_kernel(m, src_p, dst_p, mask_p, thr_sq):
    return _launch("homography_scores", m, src_p, dst_p, mask_p, thr_sq)


def _pnp_kernel(m, X_p, pix_p, mask_p, thr_sq):
    return _launch("pnp_scores", m, X_p, pix_p, mask_p, thr_sq)


def _h_scores(models, src, dst, point_mask, threshold, core):
    m = models.reshape(models.shape[0], 9).to(torch.float32).contiguous()
    src_p, mask_p = _pad_points(src, point_mask, 2)
    dst_p, _ = _pad_points(dst, point_mask, 2)
    return core(m, src_p, dst_p, mask_p, _thr_sq(threshold))


def _pnp_scores(models, Xw, pix_n, point_mask, threshold, core):
    m = models.to(torch.float32).contiguous()
    X_p, mask_p = _pad_points(Xw, point_mask, 3)
    pix_p, _ = _pad_points(pix_n, point_mask, 2)
    return core(m, X_p, pix_p, mask_p, _thr_sq(threshold))


def homography_scores(models, src, dst, point_mask, threshold):
    """models [H,3,3]; src/dst [N<=16,2] -> (counts [H] f32, msac [H] f32).
    CUDA tensors go through the kernel (or raise), CPU tensors through the
    plain version."""
    core = _h_plain if models.device.type == "cpu" else _h_kernel
    return _h_scores(models, src, dst, point_mask, threshold, core)


def pnp_scores(models, Xw, pix_n, point_mask, threshold):
    """models [H,12] (R row-major 9 + t 3); Xw [N<=16,3]; pix_n [N,2]
    normalized coords; threshold in normalized units -> (counts, msac)."""
    core = _pnp_plain if models.device.type == "cpu" else _pnp_kernel
    return _pnp_scores(models, Xw, pix_n, point_mask, threshold, core)


def homography_scores_plain(models, src, dst, point_mask, threshold):
    """The kernel's plain PyTorch version on any device."""
    return _h_scores(models, src, dst, point_mask, threshold, _h_plain)


def pnp_scores_plain(models, Xw, pix_n, point_mask, threshold):
    """The kernel's plain PyTorch version on any device."""
    return _pnp_scores(models, Xw, pix_n, point_mask, threshold, _pnp_plain)


# ------------------------------------------------------- engine-path forms
def homography_scores_ref(models, src, dst, point_mask, threshold):
    """Transfer errors, squared, thresholded (score.py:184-193)."""
    r = transfer_errors(models, src, dst)  # [H, N]
    thr_sq = threshold * threshold
    r_sq = torch.where(torch.isfinite(r), r * r, math.inf)
    pm = point_mask.bool()[None, :]
    counts = ((r_sq <= thr_sq) & pm).sum(-1).to(torch.float32)
    msac = torch.where(pm, torch.clamp(r_sq, max=thr_sq), 0.0).sum(-1)
    return counts, msac


def pnp_scores_ref(models, Xw, pix_n, point_mask, threshold):
    """Reprojection errors with cheirality, thresholded (score.py:196-212)."""
    R = models[:, :9].reshape(-1, 3, 3)
    t = models[:, 9:12]
    Xc = Xw @ R.transpose(-1, -2) + t[:, None, :]
    z = Xc[..., 2]
    ok = z > 1e-6
    uv = Xc[..., :2] / torch.where(ok, z, 1.0)[..., None]
    e2 = torch.where(ok, ((uv - pix_n) ** 2).sum(-1), 1e12)
    thr_sq = threshold * threshold
    pm = point_mask.bool()[None, :]
    counts = ((e2 <= thr_sq) & pm).sum(-1).to(torch.float32)
    msac = torch.where(pm, torch.clamp(e2, max=thr_sq), 0.0).sum(-1)
    return counts, msac
