"""Fused RANSAC scoring: the CUDA kernels' wrappers and their plain
PyTorch versions.

Port of ``ransac_tpu.ops.pallas.score``: given H models and N <= 16
correspondences, per-model inlier counts and truncated MSAC scores
without an [H, N] residual tensor in device memory.  ``homography_scores``
takes models [H,3,3] and divides by w exactly (|w| < 1e-12 guarded);
``pnp_scores`` takes poses [H,12] (R row-major, then t) with normalized
pixel coordinates, and points at z <= 1e-6 score e^2 = 1e12.  Counts
exclude masked points.

The JAX kernels score 16 rows: the n real points, then padding rows that
are all one zero point of weight 0.  The plain versions here pad as they
do (``_pad_points``) and score the n real rows and one zero row when
n < 16 (``_rows``): the same sums bit for bit, so a model with a
non-finite entry that meets a zero coordinate gets the JAX kernels' NaN
MSAC.

For CPU tensors the wrappers compute the plain versions; for CUDA tensors
they launch ``csrc/score.cu`` or raise.  Each is one launch a call on the
card: the kernel reads the caller's raw points [n, 3] or [n, 2] and mask
[n] itself.  The plain versions round every operation on its own; the
kernels round each product-sum once (FMA) and take MUFU's reciprocal of w
or z (a pose's camera point keeps the plain order), so the two agree in
their decisions (``hold``: counts equal but where points at the inlier
cut explain a flip, ``cut_margins`` / ``pose_cut_margins``; MSAC within
rtol 1e-4 on >= 99% of the models, 1e-3 on all; NaN alike).
``homography_scores_ref`` and ``pnp_scores_ref`` are the engine-path
formulations (residual, then square), as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops.homography import transfer_errors
from ransac_tpu_torch.ops.sweep import COUNT_CUT, MSAC_MOST, MSAC_RTOL, MSAC_RTOL_ALL

MAX_POINTS = 16


def _pad_points(pts, mask, width):
    n = pts.shape[0]
    if n > MAX_POINTS:
        raise ValueError(f"at most {MAX_POINTS} points, got {n}")
    pts_p = pts.new_zeros((MAX_POINTS, width), dtype=torch.float32)
    pts_p[:n, :pts.shape[1]] = pts
    mask_p = pts.new_zeros((MAX_POINTS,), dtype=torch.float32)
    mask_p[:n] = mask.to(torch.float32)
    return pts_p, mask_p


def _rows(n: int) -> int:
    """The rows whose sums equal the JAX kernel's 16: the n real points and
    one zero row when n < 16 (``score::rows``)."""
    return min(n + 1, MAX_POINTS)


def _thr_sq(threshold) -> float:
    t = np.float32(float(threshold))  # a number or a 0-d tensor on any device
    return float(t * t)


def thr_sq_of(threshold):
    """fl(t)^2 in float32 where the threshold lies: ``_thr_sq`` of a number,
    or a 0-d float32 tensor squared on a tensor's device."""
    if isinstance(threshold, torch.Tensor):
        t = _build.f32_of(threshold)
        return t * t
    return _thr_sq(threshold)


def _h_errors(m, src, dst, mask):
    """(squared transfer error [H], weight) of models m [H, 9] at each row
    of src/dst [n <= 16, 2] padded to the JAX kernel's 16 (``_rows``), in
    the kernel's order of operations (score.py:53-75)."""
    src_p, mask_p = _pad_points(src, mask, 2)
    dst_p, _ = _pad_points(dst, mask, 2)
    for k in range(_rows(src.shape[0])):
        x, y = src_p[k, 0], src_p[k, 1]
        u = m[:, 0] * x + m[:, 1] * y + m[:, 2]
        v = m[:, 3] * x + m[:, 4] * y + m[:, 5]
        w = m[:, 6] * x + m[:, 7] * y + m[:, 8]
        inv_w = 1.0 / torch.where(w.abs() < 1e-12, 1e-12, w)
        du = u * inv_w - dst_p[k, 0]
        dv = v * inv_w - dst_p[k, 1]
        yield du * du + dv * dv, mask_p[k]


def _pnp_errors(m, Xw, pix_n, mask):
    """(squared reprojection error [H], weight) of poses m [H, 12] at each
    row of Xw [n <= 16, 3] / pix_n [n, 2] padded to the JAX kernel's 16
    (``_rows``), in the kernel's order of operations (score.py:118-144):
    1e12 where the camera point has z <= 1e-6."""
    X_p, mask_p = _pad_points(Xw, mask, 3)
    pix_p, _ = _pad_points(pix_n, mask, 2)
    for k in range(_rows(Xw.shape[0])):
        X, Y, Z = X_p[k, 0], X_p[k, 1], X_p[k, 2]
        xc = m[:, 0] * X + m[:, 1] * Y + m[:, 2] * Z + m[:, 9]
        yc = m[:, 3] * X + m[:, 4] * Y + m[:, 5] * Z + m[:, 10]
        zc = m[:, 6] * X + m[:, 7] * Y + m[:, 8] * Z + m[:, 11]
        behind = zc <= 1e-6
        inv_z = 1.0 / torch.where(behind, 1.0, zc)
        du = xc * inv_z - pix_p[k, 0]
        dv = yc * inv_z - pix_p[k, 1]
        yield torch.where(behind, 1e12, du * du + dv * dv), mask_p[k]


def _accumulate(m, errors, thr_sq):
    """The per-model score loop over ``errors``: (counts, msac) [H]."""
    count = torch.zeros_like(m[:, 0])
    msac = torch.zeros_like(m[:, 0])
    for e2, wt in errors:
        count = count + torch.where(e2 <= thr_sq, 1.0, 0.0) * wt
        msac = msac + torch.clamp(e2, max=thr_sq) * wt
    return count, msac


def _h_plain(m, src, dst, mask, thr_sq):
    """Per-model score loop (score.py:53-75) of models [H, 9]."""
    return _accumulate(m, _h_errors(m, src, dst, mask), thr_sq)


def _pnp_plain(m, Xw, pix_n, mask, thr_sq):
    """Per-pose score loop (score.py:118-144) of poses [H, 12]."""
    return _accumulate(m, _pnp_errors(m, Xw, pix_n, mask), thr_sq)


def _margins(m, errors, thr_sq):
    near_in = torch.zeros_like(m[:, 0])
    near_out = torch.zeros_like(m[:, 0])
    for e2, wt in errors:
        near = ((e2 - thr_sq).abs() / thr_sq <= COUNT_CUT) & (wt > 0)
        near_in = near_in + torch.where(near & (e2 <= thr_sq), wt, 0.0)
        near_out = near_out + torch.where(near & (e2 > thr_sq), wt, 0.0)
    return near_in, near_out


def _rows_of(models, width, hyp):
    return models.reshape(models.shape[0], width).to(torch.float32)[
        torch.as_tensor(hyp, dtype=torch.int64, device=models.device)]


def cut_margins(models, src, dst, point_mask, threshold, hyp):
    """How far homographies ``hyp`` (indices) sit from their inlier cuts, in
    the plain version's arithmetic: (the weight of the points of weight > 0
    that are inliers with |e2 - thr^2| / thr^2 <= COUNT_CUT; the weight of
    such outliers), each [len(hyp)].  A kernel that rounds otherwise may
    lower a count by at most the first and raise it by at most the
    second."""
    m = _rows_of(models, 9, hyp)
    thr_sq = thr_sq_of(threshold)
    return _margins(m, _h_errors(m, src, dst, point_mask), thr_sq)


def pose_cut_margins(models, Xw, pix_n, point_mask, threshold, hyp):
    """``cut_margins`` of poses ``hyp`` of models [H, 12] over Xw / pix_n."""
    m = _rows_of(models, 12, hyp)
    thr_sq = thr_sq_of(threshold)
    return _margins(m, _pnp_errors(m, Xw, pix_n, point_mask), thr_sq)


def hold(out_k, out_p, margins) -> dict:
    """(counts, msac) [H] of a scorer kernel (rows 3 and 4) against the
    plain version's: counts equal but where a model's points at the inlier
    cut (``margins(hyp)``: ``cut_margins`` or ``pose_cut_margins`` of those
    models) explain the difference, in its direction and size; MSAC within
    MSAC_RTOL on MSAC_MOST of the models and MSAC_RTOL_ALL on all, NaN on
    both sides alike.  Returns the readings, ``flipped`` (the models whose
    count moved) and ``failures`` (empty when every criterion held)."""
    c_k, m_k = (t.double() for t in out_k)
    c_p, m_p = (t.double() for t in out_p)
    fails = []
    flipped = torch.nonzero(c_k != c_p).flatten()
    if len(flipped):
        near_in, near_out = (t.to(flipped.device).double() for t in margins(flipped))
        d = c_k[flipped] - c_p[flipped]
        at_cut = (d >= -near_in) & (d <= near_out)
        if not bool(at_cut.all()):
            fails.append(f"{int((~at_cut).sum())} count flips off the cut")
    nan_k, nan_p = torch.isnan(m_k), torch.isnan(m_p)
    if not torch.equal(nan_k, nan_p):
        fails.append("NaN MSAC in one version only")
    both = ~(nan_k | nan_p)
    rel = torch.where(m_k[both] == m_p[both], 0.0,
                      (m_k[both] - m_p[both]).abs() / m_p[both].abs())
    within = float((rel <= MSAC_RTOL).double().mean()) if len(rel) else 1.0
    max_rel = float(rel.max()) if len(rel) else 0.0
    if within < MSAC_MOST or max_rel > MSAC_RTOL_ALL:
        fails.append(f"MSAC within {MSAC_RTOL} on {within}, max rel {max_rel}")
    return {"count_flips": len(flipped),
            "counts_equal_fraction": float((c_k == c_p).double().mean()),
            "msac_within_1e-4_fraction": within, "max_rel_err": max_rel,
            "flipped": flipped, "failures": fails}


def _launch(kernel, m, a, b, mask, thr_sq):
    """Launch ``<kernel>_launch`` of ``csrc/score.cu`` on the current
    stream: models m [H, 9] or [H, 12], the raw points a [n <= 16, 2 or 3]
    and b [n, 2] and mask [n]; one launch, no padding.  ``thr_sq``, a
    number or a 0-d tensor, goes by value or by pointer (``_build.f32_arg``)."""
    dev = m.device
    a, b, mask = (t.to(torch.float32).contiguous() for t in (a, b, mask))
    _build.check_inputs(kernel, dev, models=(m, torch.float32), points=(a, torch.float32),
                        pixels=(b, torch.float32), mask=(mask, torch.float32))
    n = a.shape[0]
    if n > MAX_POINTS or b.shape[0] != n or mask.shape[0] != n:
        raise ValueError(f"at most {MAX_POINTS} points, points and mask alike; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(mask.shape)}")
    if m.data_ptr() % 16:  # the kernel copies 16-byte chunks of the models
        m = m.clone()
    H = m.shape[0]
    count = torch.empty(H, dtype=torch.float32, device=dev)
    msac = torch.empty(H, dtype=torch.float32, device=dev)
    _build.launch(kernel, dev, m, a, b, mask, *_build.f32_arg(thr_sq, dev), n, H, count, msac)
    return count, msac


def _h_kernel(m, src, dst, mask, thr_sq):
    """Row 3's kernel on homographies m [H, 9], src/dst [n, 2], mask [n]."""
    return _launch("homography_scores", m, src, dst, mask, thr_sq)


def _pnp_kernel(m, Xw, pix_n, mask, thr_sq):
    """Row 4's kernel on poses m [H, 12], Xw [n, 3], pix_n [n, 2], mask [n]."""
    return _launch("pnp_scores", m, Xw, pix_n, mask, thr_sq)


def _h_scores(models, src, dst, point_mask, threshold, core):
    m = models.reshape(models.shape[0], 9).to(torch.float32).contiguous()
    return core(m, src, dst, point_mask, thr_sq_of(threshold))


def _pnp_scores(models, Xw, pix_n, point_mask, threshold, core):
    m = models.to(torch.float32).contiguous()
    return core(m, Xw, pix_n, point_mask, thr_sq_of(threshold))


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
