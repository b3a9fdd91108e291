"""Fused homography-RANSAC sweep: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``ransac_tpu.ops.pallas.sweep.homography_ransac_sweep``, the
repo's headline kernel.  Every hypothesis derives its 4-point sample from
a counter-based PRNG (the murmur3 finalizer of its flat index, hashed with
four per-draw seeds), solves the homography by the division-free
projective-frame method and scores all points with the division-deferred
inlier test; no random tensor and no model is stored.  The records keep
the TPU kernel's layout: record ``r = b * 256 + l`` covers the flat ids
``b * 2048 + s * 256 + l`` (s = 0..7) and holds two winners, row 0 by min
MSAC (ties to the smallest packed sample) and row 1 by (max count, min
MSAC, smallest packed sample).  The sampling is the JAX kernel's bit for
bit, so one seed gives one hypothesis set on both sides.

Points are normalized as the JAX wrapper normalizes them: centroid and
mean distance over the first ``n_points`` rows, unmasked, for src and dst
alike; the threshold is scaled by dst's scale and MSAC scaled back,
keeping the 3.4e38 sentinel of invalid hypotheses (masked or degenerate
samples).  On the card ``csrc/sweep.cu`` does this itself: a one-block
kernel normalizes, the sweep rescales as it writes, and both launch from
one C call, so the wrapper issues no tensor op of its own.

For a CPU tensor the wrapper computes the plain version; for a CUDA
tensor it launches ``csrc/sweep.cu`` or raises.  The plain version rounds
every operation on its own; the kernel rounds each product-sum once (FMA)
and takes MUFU's approximate reciprocal where the TPU kernel took
``pl.reciprocal(approx=True)``, so the two agree in their decisions, not
bit for bit: the same samples and validity, the same counts (a flip only
where a point sits at the inlier cut, ``cut_margins``), MSAC within rtol
1e-4 on >= 99% of hypotheses and 1e-3 on all (``hold_full``,
``hold_reduced``).  The kernel's header under its exact policy is this
version's arithmetic bit for bit (the host-build tests).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ransac_tpu_torch.ops import _build

SUB = 8             # hypotheses per record
LAN = 256           # records per block
BLOCK_H = SUB * LAN
MAX_POINTS = 16     # 4-bit fields of the packed sample
N_ACC = 8           # accumulator pairs of the score loop
PREP_FLOATS = 5 * MAX_POINTS + 3  # csrc/sweep.cu's normalized-pool buffer
INVALID = 3.4e38    # MSAC of an invalid hypothesis
GOLDEN = 0x9E3779B9
_M32 = 0xFFFFFFFF
# Records per chunk of the plain version (bounds its memory, not its result).
PLAIN_CHUNK = 1 << 17


# ------------------------------------------------------------ counter PRNG
def fmix32(x: int) -> int:
    """murmur3 32-bit finalizer on a Python int (sweep.py:65-72)."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def draw_seeds(seed: int, k: int) -> list[int]:
    """The k per-draw seeds fmix(seed + j * 0x9E3779B9), j = 1..k, mod 2^32."""
    return [fmix32((int(seed) + j * GOLDEN) & _M32) for j in range(1, k + 1)]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def fmix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def draw_sample(flat: torch.Tensor, seeds, n_points: int) -> list[torch.Tensor]:
    """len(seeds)-subset Fisher-Yates of the TPU kernels: r_j = fmix(flat ^
    seed_j) mod (n - j), unsigned, shifted past the earlier picks in
    ascending order (sweep.py:89-106).  flat: int64 tensor."""
    idx: list[torch.Tensor] = []
    for j, sj in enumerate(seeds):
        r = fmix(flat ^ sj) % (n_points - j)
        prev_sorted: list[torch.Tensor] = []
        for p in idx:
            ins = p
            out = []
            for s in prev_sorted:
                out.append(torch.minimum(s, ins))
                ins = torch.maximum(s, ins)
            out.append(ins)
            prev_sorted = out
        for s in prev_sorted:
            r = r + (r >= s).long()
        idx.append(r)
    return idx


def sample_bitmask(mask_p: torch.Tensor) -> torch.Tensor:
    """[1] int32: bit n set iff point n may be sampled."""
    bits = torch.where(mask_p > 0,
                       torch.ones_like(mask_p, dtype=torch.int64)
                       << torch.arange(mask_p.shape[0], device=mask_p.device),
                       0)
    return bits.sum().reshape(1).to(torch.int32)


def record_flat_ids(r0: int, r1: int, block_records: int, device) -> torch.Tensor:
    """[SUB, r1 - r0] int64 flat ids of records r0..r1-1 when a block holds
    ``block_records`` records: flat = b * block + s * block_records + l."""
    r = torch.arange(r0, r1, device=device)
    s = torch.arange(SUB, device=device)[:, None]
    return ((r // block_records) * (SUB * block_records) + s * block_records
            + r % block_records)


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 of the same 32 bits (values
    of 2^31 and above wrap to negative, as the TPU's int32 arithmetic)."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def reduce_records(msac, count, packed, big=INVALID, sentinel=2 ** 30):
    """The TPU kernels' sublane reduction over dim 0 of [SUB, R] tensors:
    (msac_m, count_m, msac_c, count_c) and (packed_m, packed_c).  Ties go
    to the smallest packed key; ``sentinel`` stands for a hypothesis that
    is not selected.  Keys are int64 and come back as int32
    (``to_int32``)."""
    msac_m = msac.amin(0)
    selm = msac == msac_m
    packed_m = torch.where(selm, packed, sentinel).amin(0)
    count_m = torch.where(selm & (packed == packed_m), count, -2.0).amax(0)
    count_c = count.amax(0)
    selc = count == count_c
    msac_c = torch.where(selc, msac, big).amin(0)
    packed_c = torch.where(selc & (msac == msac_c), packed, sentinel).amin(0)
    return (torch.stack([msac_m, count_m, msac_c, count_c]),
            to_int32(torch.stack([packed_m, packed_c])))


def rescale(msac: torch.Tensor, inv_s2) -> torch.Tensor:
    """MSAC records back in pixel^2 units; the invalid sentinel stays."""
    return torch.where(msac >= 3e38, INVALID, msac * inv_s2)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt on any device (the kernels'
    __fsqrt_rn): rounding the double sqrt to float32 is exact, while
    torch.sqrt's vectorized CPU path can be off in the last place."""
    return torch.sqrt(x.double()).float()


# ------------------------------------------------------------ the sweep
def _seq_sum(x):
    acc = x[0]
    for k in range(1, x.shape[0]):
        acc = acc + x[k]
    return acc


def centroid_dist(a, n_points):
    """(centroid [2], distance sum) of the first n_points rows of a [n, 2],
    unmasked, summed point by point, square roots correctly rounded, as
    ``sweep::centroid_dist``."""
    a = a[:n_points].to(torch.float32)
    m = _seq_sum(a) / a.new_tensor(float(n_points))  # a tensor divisor: true division
    q = (a - m) ** 2
    return m, _seq_sum(sqrt_rn(q[:, 0] + q[:, 1]))


def _normalize(src, dst, point_mask, threshold, n_points):
    """(src_p [16,2], dst_p [16,2], mask_p [16], thr_sq [1], inv_s2): the
    plain version of the kernel's prologue.

    Sums run point by point, the square root is correctly rounded and the
    scale is a true division, as in ``sweep::norm_params``."""
    n = src.shape[0]

    def norm_params(a):
        m, dsum = centroid_dist(a, n_points)
        den = torch.clamp(dsum / dsum.new_tensor(float(n_points)), min=1e-12)
        return m, torch.full_like(den, math.sqrt(2.0)) / den

    sm, s_src = norm_params(src)
    dm, s_dst = norm_params(dst)
    src_p = src.new_zeros((MAX_POINTS, 2), dtype=torch.float32)
    src_p[:n] = (src - sm) * s_src
    dst_p = src.new_zeros((MAX_POINTS, 2), dtype=torch.float32)
    dst_p[:n] = (dst - dm) * s_dst
    mask_p = src.new_zeros((MAX_POINTS,), dtype=torch.float32)
    mask_p[:n] = point_mask.to(torch.float32)
    thr = (torch.as_tensor(threshold, dtype=torch.float32,
                           device=src.device).reshape(1) * s_dst) ** 2
    return src_p, dst_p, mask_p, thr, 1.0 / (s_dst * s_dst)


def _det3(px, py, qx, qy, rx, ry):
    return (qx - px) * (ry - py) - (rx - px) * (qy - py)


def frame_dets(xs, ys):
    """The 4 determinants (d0, l1, l2, l3) of the projective frame of 4
    points (lists of tensors); the frame is valid when each is above 1e-7
    in magnitude."""
    return [_det3(xs[0], ys[0], xs[1], ys[1], xs[2], ys[2]),
            _det3(xs[3], ys[3], xs[1], ys[1], xs[2], ys[2]),
            _det3(xs[0], ys[0], xs[3], ys[3], xs[2], ys[2]),
            _det3(xs[0], ys[0], xs[1], ys[1], xs[3], ys[3])]


def _frame(xs, ys):
    """Projective frame of 4 points (lists of tensors) and its validity."""
    d0, l1, l2, l3 = frame_dets(xs, ys)
    M = [[l1 * xs[0], l2 * xs[1], l3 * xs[2]],
         [l1 * ys[0], l2 * ys[1], l3 * ys[2]],
         [l1, l2, l3]]
    ok = ((d0.abs() > 1e-7) & (l1.abs() > 1e-7)
          & (l2.abs() > 1e-7) & (l3.abs() > 1e-7))
    return M, ok


def solve_frames(sx, sy, dx, dy):
    """The division-free 4-point homography H = B adj(A) of the projective
    frames A of (sx, sy) and B of (dx, dy) (sweep.py:157-191): (H as a list
    of 9 tensors, row-major; both frames valid)."""
    A, ok_s = _frame(sx, sy)
    Bm, ok_d = _frame(dx, dy)
    adj = [[A[1][1] * A[2][2] - A[1][2] * A[2][1],
            A[0][2] * A[2][1] - A[0][1] * A[2][2],
            A[0][1] * A[1][2] - A[0][2] * A[1][1]],
           [A[1][2] * A[2][0] - A[1][0] * A[2][2],
            A[0][0] * A[2][2] - A[0][2] * A[2][0],
            A[0][2] * A[1][0] - A[0][0] * A[1][2]],
           [A[1][0] * A[2][1] - A[1][1] * A[2][0],
            A[0][1] * A[2][0] - A[0][0] * A[2][1],
            A[0][0] * A[1][1] - A[0][1] * A[1][0]]]
    H = [Bm[r][0] * adj[0][c] + Bm[r][1] * adj[1][c] + Bm[r][2] * adj[2][c]
         for r in range(3) for c in range(3)]
    return H, ok_s & ok_d


def _score_plain(src_p, dst_p, mask_p, thr, seeds, n_points, n_score, n_hyp,
                 full):
    """The kernel's per-hypothesis arithmetic on [SUB, R] tensors of
    hypotheses, in the kernel's order of operations, chunked over records.
    Returns the records in normalized units: full (f [2, n_hyp], i
    [n_hyp]) in s * B + r order, or reduced (f [4, B], i [2, B])."""
    B = n_hyp // SUB
    vmask = sample_bitmask(mask_p)
    thr_sq = thr[0]
    fs, ps = [], []
    for r0 in range(0, B, PLAIN_CHUNK):
        flat = record_flat_ids(r0, min(B, r0 + PLAIN_CHUNK), LAN, src_p.device)
        idx = draw_sample(flat, seeds, n_points)
        ok_bits = ((vmask >> idx[0]) & (vmask >> idx[1]) & (vmask >> idx[2])
                   & (vmask >> idx[3]))
        sx = [src_p[i, 0] for i in idx]
        sy = [src_p[i, 1] for i in idx]
        dx = [dst_p[i, 0] for i in idx]
        dy = [dst_p[i, 1] for i in idx]

        H, ok_h = solve_frames(sx, sy, dx, dy)
        valid = ((ok_bits & 1) == 1) & ok_h

        cnt = [torch.zeros_like(H[0]) for _ in range(N_ACC)]
        ms = [torch.zeros_like(H[0]) for _ in range(N_ACC)]
        for n in range(n_score):
            x, y = src_p[n, 0], src_p[n, 1]
            u = H[0] * x + H[1] * y + H[2]
            v = H[3] * x + H[4] * y + H[5]
            w = H[6] * x + H[7] * y + H[8]
            a = u - dst_p[n, 0] * w
            b = v - dst_p[n, 1] * w
            r2 = a * a + b * b
            w2 = torch.clamp(w * w, min=1e-30)
            t = thr_sq * w2
            iw2 = 1.0 / w2
            k = n % N_ACC
            cnt[k] = cnt[k] + torch.where(r2 <= t, mask_p[n], 0.0)
            ms[k] = ms[k] + torch.minimum(r2, t) * iw2 * mask_p[n]
        count, msac = cnt[0], ms[0]
        for k in range(1, N_ACC):
            count = count + cnt[k]
            msac = msac + ms[k]
        msac = torch.where(valid, msac, INVALID)
        count = torch.where(valid, count, -1.0)
        packed = idx[0] + idx[1] * 16 + idx[2] * 256 + idx[3] * 4096
        if full:
            fs.append(torch.stack([msac, count]))
            ps.append(packed.to(torch.int32))
        else:
            f, p = reduce_records(msac, count, packed)
            fs.append(f)
            ps.append(p)
    if full:  # [2, SUB, B] -> s * B + r order
        return torch.cat(fs, -1).reshape(2, -1), torch.cat(ps, -1).reshape(-1)
    return torch.cat(fs, -1), torch.cat(ps, -1)


def det_cut_margin(dets):
    """min over frame determinants (tensors) of ||det| - 1e-7|."""
    return torch.stack([(d.abs() - 1e-7).abs() for d in dets]).amin(0)


# The decision-level hold of the kernel (FMAs, MUFU's reciprocal) to the
# plain version: MSAC within MSAC_RTOL on MSAC_MOST of the valid hypotheses
# and MSAC_RTOL_ALL on all; a count moves only by scored points at the inlier
# cut (|r2 - t| / t <= COUNT_CUT in the plain arithmetic), a validity only at
# a frame determinant with ||det| - 1e-7| <= DET_CUT (8 ulps of a unit
# product); ``cut_margins``.
MSAC_RTOL, MSAC_MOST, MSAC_RTOL_ALL = 1e-4, 0.99, 1e-3
COUNT_CUT, DET_CUT = 1e-4, 2.0 ** -20


def cut_margins(src, dst, point_mask, threshold, seeds, n_points, n_hyp,
                hyp):
    """How far hypotheses ``hyp`` (indices into the full records, s * B + r
    order) sit from the cuts of their decisions, in the plain version's
    arithmetic: (the weight of the scored points of weight > 0 that are
    inliers within COUNT_CUT of the cut, |r2 - t| / t <= COUNT_CUT; the
    weight of such outliers; min over the 8 frame determinants of ||det| -
    1e-7|), each [len(hyp)].  A kernel that rounds differently
    (``csrc/sweep.cu``'s FMAs) may lower a count by at most the first and
    raise it by at most the second, and flip a validity only where the last
    is small."""
    src_p, dst_p, mask_p, thr, _ = _normalize(src, dst, point_mask, threshold,
                                              n_points)
    n_score = src.shape[0]
    hyp = torch.as_tensor(hyp, dtype=torch.int64, device=src_p.device)
    B = n_hyp // SUB
    s, r = hyp // B, hyp % B
    idx = draw_sample((r // LAN) * BLOCK_H + s * LAN + r % LAN, seeds, n_points)
    xs = [[src_p[i, 0] for i in idx], [dst_p[i, 0] for i in idx]]
    ys = [[src_p[i, 1] for i in idx], [dst_p[i, 1] for i in idx]]
    H, _ = solve_frames(xs[0], ys[0], xs[1], ys[1])
    det_margin = det_cut_margin(frame_dets(xs[0], ys[0]) + frame_dets(xs[1], ys[1]))
    near_in, near_out = points_at_cut(H, src_p[:n_score, 0], src_p[:n_score, 1],
                                      dst_p[:n_score, 0], dst_p[:n_score, 1],
                                      mask_p[:n_score], thr[0])
    return near_in, near_out, det_margin


def points_at_cut(H, x, y, px, py, wt, thr_sq):
    """(near_in, near_out): the weight of the points (1-d tensors x, y, px,
    py, wt) of weight > 0 whose residual under homographies H (9 tensors)
    is within COUNT_CUT of the inlier cut, |r2 - t| / t <= COUNT_CUT, inliers
    and outliers apart, in the plain version's arithmetic."""
    near_in = torch.zeros_like(H[0])
    near_out = torch.zeros_like(H[0])
    for n in range(x.shape[0]):
        w = H[6] * x[n] + H[7] * y[n] + H[8]
        a = H[0] * x[n] + H[1] * y[n] + H[2] - px[n] * w
        b = H[3] * x[n] + H[4] * y[n] + H[5] - py[n] * w
        r2 = a * a + b * b
        t = thr_sq * torch.clamp(w * w, min=1e-30)
        near = ((r2 - t).abs() / t <= COUNT_CUT) & (wt[n] > 0)
        near_in = near_in + torch.where(near & (r2 <= t), wt[n], 0.0)
        near_out = near_out + torch.where(near & (r2 > t), wt[n], 0.0)
    return near_in, near_out


def hold_full(out_k, out_p, margins) -> dict:
    """Full records (msac, counts, packed) [n_hyp] of the kernel against the
    plain version's: samples equal; validity equal but where ``margins(hyp)``
    (``cut_margins`` of those hypotheses) puts a determinant at its cut;
    counts equal but where a hypothesis' points at the inlier cut explain
    the difference, in its direction and size; MSAC by MSAC_RTOL.  Returns
    the readings, ``flipped`` (the flipped hypotheses) and ``failures``
    (empty when every criterion held)."""
    m_k, c_k, p_k = (t.double() if t.is_floating_point() else t for t in out_k)
    m_p, c_p, p_p = (t.double() if t.is_floating_point() else t for t in out_p)
    fails = []
    if not torch.equal(p_k, p_p):
        fails.append("samples differ")
    inv_k, inv_p = m_k >= 3e38, m_p >= 3e38
    vflip = inv_k != inv_p
    cflip = (c_k != c_p) & ~vflip
    flipped = torch.nonzero(vflip | cflip).flatten()
    if len(flipped):
        near_in, near_out, dm = (t.to(flipped.device).double() for t in margins(flipped))
        d = c_k[flipped] - c_p[flipped]
        at_cut = torch.where(vflip[flipped], dm <= DET_CUT,
                             (d >= -near_in) & (d <= near_out))
        if not bool(at_cut.all()):
            fails.append(f"{int((~at_cut).sum())} count or validity flips off a cut")
    both = ~(inv_k | inv_p)
    rel = (m_k[both] / m_p[both] - 1.0).abs()
    within = float((rel <= MSAC_RTOL).double().mean()) if len(rel) else 1.0
    max_rel = float(rel.max()) if len(rel) else 0.0
    if within < MSAC_MOST or max_rel > MSAC_RTOL_ALL:
        fails.append(f"MSAC within {MSAC_RTOL} on {within}, max rel {max_rel}")
    return {"validity_flips": int(vflip.sum()), "count_flips": int(cflip.sum()),
            "counts_equal_fraction": float((c_k == c_p).double().mean()),
            "msac_within_1e-4_fraction": within, "max_rel_err": max_rel,
            "flipped": flipped, "failures": fails}


def hold_reduced(red_k, red_p, full_k, flipped) -> dict:
    """Reduced records (msac, counts, packed) [2, B] of the kernel against
    the plain version's, with the kernel's full records ``full_k`` of the
    same call and ``flipped`` (``hold_full``): the count row's counts equal
    but in records holding a flip at a cut; where a record keeps another
    sample than the plain version's, that sample is a near-tie in the
    kernel's own full records (the plain record's count, MSAC within
    MSAC_RTOL_ALL of the kernel's record)."""
    m_k, c_k, p_k = red_k
    m_p, c_p, p_p = red_p
    B = m_k.shape[1]
    mf, cf, pf = (t.reshape(SUB, B) for t in full_k)
    fails = []
    flip_rec = torch.zeros(B, dtype=torch.bool, device=c_k.device)
    flip_rec[flipped.to(c_k.device) % B] = True
    if bool(((c_k[1] != c_p[1]) & ~flip_rec).any()):
        fails.append("count row differs off a flipped record")
    near = 0
    for row in (0, 1):
        for r in torch.nonzero(p_k[row] != p_p[row]).flatten().tolist():
            s = torch.nonzero(pf[:, r] == p_p[row][r]).flatten()
            ok = (len(s) > 0 and float(cf[s[0], r]) == float(c_p[row][r])
                  and abs(float(mf[s[0], r]) / float(m_k[row][r]) - 1.0) <= MSAC_RTOL_ALL)
            near += 1
            if not ok and not bool(flip_rec[r]):
                fails.append(f"row {row} record {r}: another sample, not a near-tie")
    return {"count_row_equal_fraction": float((c_k[1] == c_p[1]).double().mean()),
            "near_ties_used": near, "failures": fails}


def _sweep_plain(src, dst, point_mask, threshold, seeds, n_points, n_hyp,
                 full):
    """The plain version of one kernel launch: normalize, score, rescale.
    Returns (msac, counts, packed) as ``homography_ransac_sweep`` does."""
    src_p, dst_p, mask_p, thr, inv_s2 = _normalize(
        src, dst, point_mask, threshold, n_points)
    f, i = _score_plain(src_p, dst_p, mask_p, thr, seeds, n_points,
                        src.shape[0], n_hyp, full)
    msac, counts = (f[0], f[1]) if full else (f[0::2], f[1::2])
    return rescale(msac, inv_s2), counts, i


def _sweep_kernel(src, dst, point_mask, threshold, seeds, n_points, n_hyp,
                  full):
    """Launch ``csrc/sweep.cu`` (its normalizing kernel, then the sweep)
    on PyTorch's current stream."""
    dev = src.device
    src = src.to(torch.float32).contiguous()
    dst = dst.to(torch.float32).contiguous()
    mask = point_mask.to(torch.float32).contiguous()
    _build.check_inputs("sweep", dev, src=(src, torch.float32),
                        dst=(dst, torch.float32), mask=(mask, torch.float32))
    n_score = src.shape[0]
    if n_hyp <= 0 or n_hyp % BLOCK_H or not 4 <= n_points <= n_score <= MAX_POINTS:
        raise ValueError(f"n_hyp must be a positive multiple of {BLOCK_H} and "
                         f"4 <= n_points <= n <= {MAX_POINTS}; got n_hyp={n_hyp}, "
                         f"n_points={n_points}, n={n_score}")
    B = n_hyp // SUB
    prep = torch.empty((PREP_FLOATS,), dtype=torch.float32, device=dev)
    if full:
        f = torch.empty((2, n_hyp), dtype=torch.float32, device=dev)
        i = torch.empty((n_hyp,), dtype=torch.int32, device=dev)
    else:
        f = torch.empty((4, B), dtype=torch.float32, device=dev)
        i = torch.empty((2, B), dtype=torch.int32, device=dev)
    _build.launch("homography_ransac_sweep", dev, src, dst, mask, float(threshold),
                  *seeds, n_points, n_score, n_hyp, int(full), prep, f, i)
    if full:
        return f[0], f[1], i
    return f[0::2], f[1::2], i


def _sweep(seed, src, dst, point_mask, threshold, n_hyp, n_points,
           full_records, core):
    n = src.shape[0]
    if n > MAX_POINTS:
        raise ValueError(f"at most {MAX_POINTS} points, got {n}")
    n_points = n if n_points is None else int(n_points)
    n_hyp = max(int(n_hyp) // BLOCK_H, 1) * BLOCK_H
    return core(src, dst, point_mask, threshold, draw_seeds(seed, 4),
                n_points, n_hyp, full_records)


def homography_ransac_sweep(seed, src: torch.Tensor, dst: torch.Tensor,
                            point_mask: torch.Tensor, threshold, n_hyp: int,
                            n_points: int | None = None,
                            full_records: bool = False):
    """Run the fused sweep over ``n_hyp`` hypotheses (rounded down to a
    multiple of BLOCK_H, at least one block).

    Default: block-reduced records ``(msac [2, B], counts [2, B], packed
    [2, B])``, B = n_hyp / 8; row 0 selects by min MSAC, row 1 by
    (max count, min MSAC).  ``full_records=True``: per-hypothesis ``(msac
    [n_hyp], counts [n_hyp], packed [n_hyp])`` in the TPU kernel's order
    (index s * B + r), for tests and inspection.

    src/dst [N<=16, 2]; ``n_points`` is the sample pool (the first
    n_points rows); scoring uses all rows weighted by ``point_mask``.
    Hypotheses whose sample is degenerate or touches a masked point carry
    msac 3.4e38 and count -1.  ``unpack_sample`` decodes a packed sample.

    CUDA tensors go through the hand-written kernel (or raise); CPU
    tensors through the plain version."""
    core = _sweep_plain if src.device.type == "cpu" else _sweep_kernel
    return _sweep(seed, src, dst, point_mask, threshold, n_hyp, n_points,
                  full_records, core)


def homography_ransac_sweep_ref(seed, src, dst, point_mask, threshold, n_hyp,
                                n_points=None, full_records=False):
    """The plain PyTorch version on any device (what the CPU path runs;
    the card's reference for the kernel)."""
    return _sweep(seed, src, dst, point_mask, threshold, n_hyp, n_points,
                  full_records, _sweep_plain)


def unpack_sample(packed: int) -> np.ndarray:
    p = int(packed)
    return np.array([p & 15, (p >> 4) & 15, (p >> 8) & 15, (p >> 12) & 15],
                    dtype=np.int32)
