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
it launches the kernel (``csrc/sweep_multi.cu``) or raises.  The plain
version divides where the TPU kernel took an approximate reciprocal, so
against the JAX package MSAC agrees to f32 rounding (rtol 1e-4 in the
tests).  The kernel rounds each product-sum once (FMA) and takes MUFU's
reciprocal, so it agrees with the plain version in its decisions
(``hold_full``, ``hold_reduced``, on the full records of
``_sweep_kernel(..., full=True)`` and ``_sweep_plain(..., full=True)``,
with ``cut_margins``); its header's exact instantiation is the plain
version bit for bit (the host-build tests).
"""

from __future__ import annotations

import math

import torch

from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops.sweep import (MSAC_RTOL_ALL,
                                        det_cut_margin, frame_dets,
                                        hold_full, points_at_cut,
                                        solve_frames)

BLOCK_H = 1024      # sample tables are padded to a multiple of this
MAX_POINTS = 16     # 4-bit fields of the packed sample
INVALID = 3.4e38    # MSAC of an invalid (collinear-frame) hypothesis


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


def _sweep_plain(src_p, dst_p, mask_p, thr_sq, idx, n, full=False):
    """The kernel's arithmetic on tensors: a gather over [C, H] per sample
    slot, the same operations in the same order (so the same rounding),
    and the same reduction and tie rule: (msac [C], count [C], packed [C]),
    or with ``full`` every sample's (msac, count, packed) [C, H]."""
    sx = [src_p[:, idx[j], 0] for j in range(4)]   # [C, H]
    sy = [src_p[:, idx[j], 1] for j in range(4)]
    dx = [dst_p[idx[j], 0] for j in range(4)]      # [H]
    dy = [dst_p[idx[j], 1] for j in range(4)]
    Hm, ok = solve_frames(sx, sy, dx, dy)

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
    msac = torch.where(ok, ms[0] + ms[1] + ms[2] + ms[3], INVALID)
    packed = (idx[0] + idx[1] * 16 + idx[2] * 256 + idx[3] * 4096).expand_as(msac)
    if full:
        return msac, count, packed.to(torch.int32)
    return reduce_candidates(msac, count, packed)


def reduce_candidates(msac, count, packed):
    """Each candidate's record of [C, H] samples: (min MSAC, its count, its
    packed sample) [C], ties to the smallest packed sample."""
    msac_m = msac.amin(1, keepdim=True)
    sel = msac == msac_m
    packed_m = torch.where(sel, packed, 2 ** 30).amin(1, keepdim=True)
    count_m = torch.where(sel & (packed == packed_m), count, -2.0).amax(1)
    return msac_m[:, 0], count_m, packed_m[:, 0].to(packed.dtype)


def _sweep_kernel(src_p, dst_p, mask_p, thr_sq, idx, n, full=False):
    """Launch ``csrc/sweep_multi.cu`` on PyTorch's current stream (``full``:
    every sample's record, as ``_sweep_plain``)."""
    C, H = src_p.shape[0], idx.shape[1]
    _build.check_inputs("sweep_multi", src_p.device, src=(src_p, torch.float32),
                        dst=(dst_p, torch.float32), mask=(mask_p, torch.float32),
                        thr_sq=(thr_sq, torch.float32), sample_idx=(idx, torch.int32))
    if idx.shape[0] != 4 or H % BLOCK_H or not 4 <= n <= MAX_POINTS:
        raise ValueError(f"sample_idx must be [4, k*{BLOCK_H}] and "
                         f"4 <= n <= {MAX_POINTS}; got {tuple(idx.shape)}, n={n}")
    shape = (C, H) if full else (C,)
    msac = torch.empty(shape, dtype=torch.float32, device=src_p.device)
    count = torch.empty(shape, dtype=torch.float32, device=src_p.device)
    packed = torch.empty(C, dtype=torch.int32, device=src_p.device)
    _build.launch("sweep_multi", src_p.device, src_p, dst_p, mask_p, thr_sq, idx,
                  C, H, n, int(full), msac, count, packed)
    if full:
        packed = (idx[0] + idx[1] * 16 + idx[2] * 256 + idx[3] * 4096).expand(C, H)
    return msac, count, packed


def cut_margins(src_p, dst_p, mask_p, thr_sq, idx, n, hyp):
    """``ops.sweep.cut_margins`` of the candidate sweep: for samples ``hyp``
    (indices c * H + h into the flattened full records) of a
    ``_sweep_plain`` call on these arguments, in its arithmetic, (the weight
    of the scored points of weight > 0 that are inliers within COUNT_CUT of
    the inlier cut; the weight of such outliers; min over the 8 frame
    determinants of ||det| - 1e-7|), each [len(hyp)]; each candidate
    projects its own plane points."""
    H = idx.shape[1]
    hyp = torch.as_tensor(hyp, dtype=torch.int64, device=src_p.device)
    c, i = hyp // H, idx[:, hyp % H].long()
    sx = [src_p[c, i[j], 0] for j in range(4)]
    sy = [src_p[c, i[j], 1] for j in range(4)]
    dx = [dst_p[i[j], 0] for j in range(4)]
    dy = [dst_p[i[j], 1] for j in range(4)]
    Hm, _ = solve_frames(sx, sy, dx, dy)
    det_margin = det_cut_margin(frame_dets(sx, sy) + frame_dets(dx, dy))
    near_in, near_out = points_at_cut(Hm, src_p[c, :n, 0].T, src_p[c, :n, 1].T,
                                      dst_p[:n, 0], dst_p[:n, 1], mask_p[:n],
                                      thr_sq[0])
    return near_in, near_out, det_margin


def hold_reduced(red_k, red_p, full_k, flipped) -> dict:
    """Each candidate's record (msac, count, packed) [C] of the kernel
    against the plain version's, with the kernel's full records ``full_k``
    ([C, H] each) of the same call and ``flipped`` (``ops.sweep.hold_full``
    on the flattened full records): where the kernel keeps the plain
    sample, its count is equal and its MSAC within MSAC_RTOL_ALL; where it
    keeps another, the plain sample is a near-tie in the kernel's own full
    records (its count the plain record's, its MSAC within MSAC_RTOL_ALL of
    the kernel's record).  A candidate is exempt from the count checks only
    where a flip at a cut can reach its record: a flipped sample that is
    the plain winner, the kernel's, or within MSAC_RTOL_ALL of the kernel's
    record's MSAC."""
    (m_k, c_k, p_k), (m_p, c_p, p_p) = red_k, red_p
    mf, cf, pf = full_k
    flipped = flipped.to(m_k.device)
    fc, fh = flipped // mf.shape[1], flipped % mf.shape[1]
    f_packed = pf[fc, fh]
    reach = ((f_packed == p_p[fc]) | (f_packed == p_k[fc])
             | ((mf[fc, fh].double() / m_k[fc].double() - 1.0).abs() <= MSAC_RTOL_ALL))
    flip_c = torch.zeros(m_k.shape[0], dtype=torch.bool, device=m_k.device)
    flip_c[fc[reach]] = True
    fails = []
    same = p_k == p_p
    rel = torch.where(m_p >= 3e38, (m_k < 3e38).double(),
                      (m_k.double() / m_p.double() - 1.0).abs())
    if bool((same & (((c_k != c_p) & ~flip_c) | (rel > MSAC_RTOL_ALL))).any()):
        fails.append("a kept winner's count or MSAC differs")
    for c in torch.nonzero(~same).flatten().tolist():
        h = torch.nonzero(pf[c] == p_p[c]).flatten()
        ok = (len(h) > 0 and float(cf[c, h[0]]) == float(c_p[c])
              and abs(float(mf[c, h[0]]) / float(m_k[c]) - 1.0) <= MSAC_RTOL_ALL)
        if not ok and not bool(flip_c[c]):
            fails.append(f"candidate {c}: another sample, not a near-tie")
    return {"winners_equal_fraction": float(same.double().mean()),
            "near_ties_used": int((~same).sum()),
            "flip_exempt_candidates": int(flip_c.sum()), "failures": fails}


def hold(out_k, out_p, red_k, red_p, margins) -> tuple[dict, dict]:
    """``ops.sweep.hold_full`` of the full records (msac, count, packed)
    [C, H] of one kernel call and the plain version's, flips explained by
    ``margins(hyp)`` (``cut_margins`` of the call's arguments), and
    ``hold_reduced`` of the two calls' per-candidate records; returns both
    readings (each with ``failures``)."""
    flat_k, flat_p = ([t.reshape(-1) for t in out] for out in (out_k, out_p))
    held = hold_full(flat_k, flat_p, margins)
    flipped = held.pop("flipped")
    return held, hold_reduced(red_k, red_p, out_k, flipped)


def _sweep(src_all, dst, point_mask, sample_idx, threshold, core):
    src_p, dst_p, mask_p, thr_sq, inv_s2 = _normalize(
        src_all, dst, point_mask, threshold)
    msac_n, count, packed = core(src_p, dst_p, mask_p, thr_sq, sample_idx,
                                 dst.shape[0], False)
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
