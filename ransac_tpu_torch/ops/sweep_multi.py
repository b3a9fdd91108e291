"""Candidate-axis exhaustive homography-RANSAC sweep: the CUDA kernel's
wrapper and its plain PyTorch version.

Port of ``ransac_tpu.ops.pallas.sweep_multi.multi_candidate_sweep``.  The
localization search is (C candidate cameras) x (a shared table of H
exhaustive 4-point samples); one launch scores every hypothesis and keeps,
per candidate, the min-MSAC record (ties to the smallest packed sample)
with its inlier count and packed sample ``i0 + 16 i1 + 256 i2 + 4096 i3``.
The TPU kernel returned [C, H/8] sublane records; this one returns [C].

The wrapper normalizes exactly as the JAX wrapper does: the shared pixels
are moved to their masked centroid and scaled to mean distance sqrt(2),
the threshold is scaled along, plane points are padded to 16, and MSAC is
scaled back by 1/s^2 with the 3.4e38 invalid sentinel kept.

For a CPU tensor the wrapper computes the plain version; for a CUDA tensor
it launches the kernel (``csrc/sweep_multi.cu``) or raises.  The kernel
divides where the TPU kernel took an approximate reciprocal, so against
the JAX package MSAC agrees to f32 rounding (rtol 1e-4 in the tests);
against the plain version on the same inputs it agrees bit for bit.
"""

from __future__ import annotations

import math

import torch

from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops.sweep import check_inputs

BLOCK_H = 1024      # sample tables are padded to a multiple of this
MAX_POINTS = 16     # 4-bit fields of the packed sample
INVALID = 3.4e38    # MSAC of an invalid (collinear-frame) hypothesis

#: Kernel launches in this process.  Only the CUDA path adds to it, one per
#: launch; the plain version never does.
LAUNCHES = 0


def _normalize(src_all, dst, point_mask, threshold):
    """(src_p [C,16,2], dst_p [16,2], mask_p [16], thr_sq [1], inv_s2)."""
    C, n_src = src_all.shape[:2]
    n = dst.shape[0]
    if n > MAX_POINTS or n_src > MAX_POINTS:
        raise ValueError(f"at most {MAX_POINTS} points, got {max(n, n_src)}")
    pm = point_mask.to(dst.dtype)
    n_w = torch.clamp(pm.sum(), min=1.0)
    dm = (dst * pm[:, None]).sum(0) / n_w
    dd = torch.sqrt(((dst - dm) ** 2).sum(-1))
    s_dst = math.sqrt(2.0) / torch.clamp((dd * pm).sum() / n_w, min=1e-12)

    src_p = src_all.new_zeros((C, MAX_POINTS, 2), dtype=torch.float32)
    src_p[:, :n_src] = src_all
    dst_p = dst.new_zeros((MAX_POINTS, 2), dtype=torch.float32)
    dst_p[:n] = (dst - dm) * s_dst
    mask_p = dst.new_zeros((MAX_POINTS,), dtype=torch.float32)
    mask_p[:n] = pm
    thr_sq = ((torch.as_tensor(threshold, dtype=torch.float32, device=dst.device)
               * s_dst) ** 2).reshape(1)
    return src_p, dst_p, mask_p, thr_sq, 1.0 / (s_dst * s_dst)


def _sweep_plain(src_p, dst_p, mask_p, thr_sq, idx, n):
    """The kernel's arithmetic on tensors: a gather over [C, H] per sample
    slot, the same operations in the same order (so the same rounding),
    and the same reduction and tie rule."""
    sx = [src_p[:, idx[j], 0] for j in range(4)]   # [C, H]
    sy = [src_p[:, idx[j], 1] for j in range(4)]
    dx = [dst_p[idx[j], 0] for j in range(4)]      # [H]
    dy = [dst_p[idx[j], 1] for j in range(4)]

    def det3(px, py, qx, qy, rx, ry):
        return (qx - px) * (ry - py) - (rx - px) * (qy - py)

    def frame(xs, ys):
        d0 = det3(xs[0], ys[0], xs[1], ys[1], xs[2], ys[2])
        l1 = det3(xs[3], ys[3], xs[1], ys[1], xs[2], ys[2])
        l2 = det3(xs[0], ys[0], xs[3], ys[3], xs[2], ys[2])
        l3 = det3(xs[0], ys[0], xs[1], ys[1], xs[3], ys[3])
        M = [[l1 * xs[0], l2 * xs[1], l3 * xs[2]],
             [l1 * ys[0], l2 * ys[1], l3 * ys[2]],
             [l1, l2, l3]]
        ok = ((d0.abs() > 1e-7) & (l1.abs() > 1e-7)
              & (l2.abs() > 1e-7) & (l3.abs() > 1e-7))
        return M, ok

    A, ok_s = frame(sx, sy)
    B, ok_d = frame(dx, dy)
    adj = [[A[1][1] * A[2][2] - A[1][2] * A[2][1],
            A[0][2] * A[2][1] - A[0][1] * A[2][2],
            A[0][1] * A[1][2] - A[0][2] * A[1][1]],
           [A[1][2] * A[2][0] - A[1][0] * A[2][2],
            A[0][0] * A[2][2] - A[0][2] * A[2][0],
            A[0][2] * A[1][0] - A[0][0] * A[1][2]],
           [A[1][0] * A[2][1] - A[1][1] * A[2][0],
            A[0][1] * A[2][0] - A[0][0] * A[2][1],
            A[0][0] * A[1][1] - A[0][1] * A[1][0]]]
    Hm = [B[r][0] * adj[0][c] + B[r][1] * adj[1][c] + B[r][2] * adj[2][c]
          for r in range(3) for c in range(3)]

    cnt = [torch.zeros_like(Hm[0]) for _ in range(4)]
    ms = [torch.zeros_like(Hm[0]) for _ in range(4)]
    for p in range(n):
        x = src_p[:, p, 0, None]
        y = src_p[:, p, 1, None]
        u = Hm[0] * x + Hm[1] * y + Hm[2]
        v = Hm[3] * x + Hm[4] * y + Hm[5]
        w = Hm[6] * x + Hm[7] * y + Hm[8]
        a = u - dst_p[p, 0] * w
        b = v - dst_p[p, 1] * w
        r2 = a * a + b * b
        w2 = torch.clamp(w * w, min=1e-30)
        t = thr_sq * w2
        wp = mask_p[p]
        cnt[p % 4] = cnt[p % 4] + torch.where(r2 <= t, wp, 0.0)
        ms[p % 4] = ms[p % 4] + torch.minimum(r2, t) / w2 * wp
    count = cnt[0] + cnt[1] + cnt[2] + cnt[3]
    msac = torch.where(ok_s & ok_d, ms[0] + ms[1] + ms[2] + ms[3], INVALID)
    packed = (idx[0] + idx[1] * 16 + idx[2] * 256 + idx[3] * 4096).expand_as(msac)

    msac_m = msac.amin(1, keepdim=True)
    sel = msac == msac_m
    packed_m = torch.where(sel, packed, 2 ** 30).amin(1, keepdim=True)
    count_m = torch.where(sel & (packed == packed_m), count, -2.0).amax(1)
    return msac_m[:, 0], count_m, packed_m[:, 0]


def _sweep_kernel(src_p, dst_p, mask_p, thr_sq, idx, n):
    """Launch ``csrc/sweep_multi.cu`` on PyTorch's current stream."""
    global LAUNCHES
    C, H = src_p.shape[0], idx.shape[1]
    check_inputs("sweep_multi", src_p.device, src=(src_p, torch.float32),
                 dst=(dst_p, torch.float32), mask=(mask_p, torch.float32),
                 thr_sq=(thr_sq, torch.float32), sample_idx=(idx, torch.int32))
    if idx.shape[0] != 4 or H % BLOCK_H or not 4 <= n <= MAX_POINTS:
        raise ValueError(f"sample_idx must be [4, k*{BLOCK_H}] and "
                         f"4 <= n <= {MAX_POINTS}; got {tuple(idx.shape)}, n={n}")
    fn = _build.load().sweep_multi_launch
    msac = torch.empty(C, dtype=torch.float32, device=src_p.device)
    count = torch.empty(C, dtype=torch.float32, device=src_p.device)
    packed = torch.empty(C, dtype=torch.int32, device=src_p.device)
    with torch.cuda.device(src_p.device):
        err = fn(src_p.data_ptr(), dst_p.data_ptr(), mask_p.data_ptr(),
                 thr_sq.data_ptr(), idx.data_ptr(), C, H, n,
                 msac.data_ptr(), count.data_ptr(), packed.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sweep_multi_launch failed: CUDA error {err}")
    LAUNCHES += 1
    return msac, count, packed


def _sweep(src_all, dst, point_mask, sample_idx, threshold, core):
    src_p, dst_p, mask_p, thr_sq, inv_s2 = _normalize(
        src_all, dst, point_mask, threshold)
    msac_n, count, packed = core(src_p, dst_p, mask_p, thr_sq, sample_idx,
                                 dst.shape[0])
    msac = torch.where(msac_n >= 3e38, INVALID, msac_n * inv_s2)
    return msac, count, packed


def multi_candidate_sweep(
    src_all: torch.Tensor,     # [C, <=16, 2] per-candidate plane points
    dst: torch.Tensor,         # [N<=16, 2] shared pixels
    point_mask: torch.Tensor,  # [N]
    sample_idx: torch.Tensor,  # [4, H] int32, H a multiple of BLOCK_H
    threshold,
):
    """One sweep over (C candidates x H hypotheses).  Returns per-candidate
    winner records ``(msac [C], count [C], packed [C])``.

    CUDA tensors go through the hand-written kernel (or raise); CPU
    tensors through the plain version."""
    core = _sweep_plain if src_all.device.type == "cpu" else _sweep_kernel
    return _sweep(src_all, dst, point_mask, sample_idx, threshold, core)


def multi_candidate_sweep_ref(src_all, dst, point_mask, sample_idx, threshold):
    """The plain PyTorch version on any device (what the CPU path runs;
    the card's reference for the kernel)."""
    return _sweep(src_all, dst, point_mask, sample_idx, threshold,
                  _sweep_plain)
