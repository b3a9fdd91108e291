"""Fused P3P-RANSAC sweep: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``ransac_tpu.ops.pallas.sweep_pnp.pnp_ransac_sweep``.  Every
sample draws 3 points from the counter PRNG of ``ops.sweep`` (3 per-draw
seeds), solves Grunert's P3P (resultant quartic by a 12-step Newton
resolvent cubic from a Fujiwara bound, Ferrari, 2 polish steps; one
Newton depth polish; triad pose with the world triad shared by the four
roots) and scores all points under each of the four roots with the
division-deferred inlier test, in fx-normalized units made pixel-true by
``ay = fy / fx`` (the pool's y is pre-scaled here, the pose's y-row in the
kernel).  Records keep the TPU kernel's layout: with LAN = block_h / 8,
record ``r = b * LAN + l`` covers the flat ids ``b * block_h + s * LAN +
l`` (s = 0..7) and holds the min-MSAC and (max count, min MSAC) winners,
each with its root id in bits 12-13 of the packed sample.

For a CPU tensor the wrapper computes the plain version; for a CUDA
tensor it launches ``csrc/sweep_pnp.cu`` or raises.  The plain version
is ``solve_poses`` (the four roots' poses and validity) and ``score_pose``
(one pose over the pool), every operation rounded on its own and every
reciprocal an exact division (the TPU took approximate ones).  ``rsqrt``
is ``torch.rsqrt``: on the card the same ``rsqrtf`` as the kernel; on the
CPU it rounds differently in the last place, so Grunert's ill-conditioned
quartics can flip a root's validity.  The kernel solves as the plain
version does (samples, poses and validity bit for bit on the card), scores
only the valid pairs, and rounds each product-sum of the score once
(FMA) and takes MUFU's reciprocal there: it is held to the plain version
by ``hold_full`` / ``hold_reduced`` (``cut_margins`` explains a count
that moves at the inlier cut).  ``valid_root_share`` reads the share of
valid pairs of a call from its inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops import sweep as sw
from ransac_tpu_torch.ops.linalg import _guard
from ransac_tpu_torch.ops.score import thr_sq_of
from ransac_tpu_torch.ops.sweep import (SUB, draw_sample,
                                        draw_seeds, record_flat_ids,
                                        reduce_records, sample_bitmask)
from ransac_tpu_torch.ops.sweep import sqrt_rn as _sqrt

BLOCK_H = 4096
MAX_POINTS = 16
N_ROOTS = 4
N_CUBIC_NEWTON = 12
N_QUARTIC_POLISH = 2
N_DEPTH_POLISH = 1
BIG = 3.4e38
FAR = 3.0e38
# Records per chunk of the plain version (bounds its memory, not its result).
PLAIN_CHUNK = 1 << 15

#: The plain version's rsqrt (the kernel's is rsqrtf, which is what
#: torch.rsqrt computes on the card).
_rsqrt = torch.rsqrt


def _rcp(x):
    return 1.0 / x


def _div3(x):
    """x / 3 as an IEEE division on any device (a Python-scalar divisor
    becomes a multiply by its reciprocal in PyTorch's CUDA kernel)."""
    return x / x.new_full((), 3.0)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _cbrt_upper(x):
    """Upper bound on cbrt(x), x >= 0: exponent-third bit trick x 1.1."""
    xi = torch.clamp(x, min=1e-30).view(torch.int32)
    return (xi // 3 + 0x2A514067).view(torch.float32) * 1.1


def _solve_quartic(b, c, d, e):
    """Real roots of x^4 + b x^3 + c x^2 + d x + e (sweep_pnp.py:84-149):
    (roots list[4], ok list[4])."""
    shift = b / 4.0
    b2 = b * b
    p = c - 3.0 * b2 / 8.0
    q = d - b * c / 2.0 + b2 * b / 8.0
    r = e - b * d / 4.0 + b2 * c / 16.0 - 3.0 * b2 * b2 / 256.0
    cb = p
    cc = p * p / 4.0 - r
    cd = -q * q / 8.0
    m = 2.0 * torch.maximum(cb.abs(), torch.maximum(
        _sqrt(cc.abs()), _cbrt_upper(cd.abs()))) + 1e-6
    lo = torch.full_like(m, -1e6)
    hi = torch.full_like(m, 1e6)
    for _ in range(N_CUBIC_NEWTON):
        f = ((m + cb) * m + cc) * m + cd
        df = (3.0 * m + 2.0 * cb) * m + cc
        m = m - _clip(f * _rcp(_guard(df, 1e-20)), lo, hi)
    m = torch.clamp(m, min=1e-12)
    s = _sqrt(2.0 * m)
    q_term = q * 0.5 * _rcp(s)
    base = p / 2.0 + m
    roots, ok = [], []
    for sign in (1.0, -1.0):
        ccq = base + sign * q_term
        disc2 = s * s / 4.0 - ccq
        good = disc2 >= 0.0
        sq2 = _sqrt(torch.clamp(disc2, min=0.0))
        for pm in (1.0, -1.0):
            roots.append(sign * s / 2.0 + pm * sq2 - shift)
            ok.append(good)
    for i in range(N_ROOTS):
        x = roots[i]
        for _ in range(N_QUARTIC_POLISH):
            f = (((x + b) * x + c) * x + d) * x + e
            df = ((4.0 * x + 3.0 * b) * x + 2.0 * c) * x + d
            x = x - f * _rcp(_guard(df, 1e-20))
        roots[i] = x
    return roots, ok


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub3(a, b):
    return [a[0] - b[0], a[1] - b[1], a[2] - b[2]]


def _cross3(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _eval(flat, seeds, vmask, n_points, n_score, thr_sq, ay, X_p, f_p, pix_p,
          mask_p):
    """Per-(sample, root) (msac, count) lists and the packed samples of the
    [SUB, R] int64 flat ids, in the kernel's order of operations."""
    idx = draw_sample(flat, seeds, n_points)
    sample_valid = (((vmask >> idx[0]) & (vmask >> idx[1])
                     & (vmask >> idx[2])) & 1) == 1
    P = [[X_p[i, c] for c in range(3)] for i in idx]
    F = [[f_p[i, c] for c in range(3)] for i in idx]
    msacs, counts = solve_and_score(P, F, sample_valid, n_score, thr_sq, ay,
                                    X_p, pix_p, mask_p)
    return msacs, counts, idx[0] + idx[1] * 16 + idx[2] * 256


def solve_poses(P, F, sample_valid, ay):
    """Grunert's P3P of the sampled world points P[j] and unit bearings
    F[j] (lists of 3 tensors each): the pose of each of the four roots,
    three rows [R_r0, R_r1, R_r2, t_r] with the y row scaled by ay, and
    its validity: (poses list[4], valid list[4]).  ``csrc/sweep_pnp.cuh``
    ``solve_poses`` in the same order of operations."""
    cos_a = _dot3(F[1], F[2])
    cos_b = _dot3(F[0], F[2])
    cos_g = _dot3(F[0], F[1])
    a2 = _dot3(_sub3(P[1], P[2]), _sub3(P[1], P[2]))
    b2 = torch.clamp(_dot3(_sub3(P[0], P[2]), _sub3(P[0], P[2])), min=1e-12)
    c2 = _dot3(_sub3(P[0], P[1]), _sub3(P[0], P[1]))
    rb2 = _rcp(b2)
    ra = a2 * rb2
    rc = c2 * rb2
    qa2, qa1, qa0 = ra, -2.0 * ra * cos_b, ra
    qc2, qc1, qc0 = rc, -2.0 * rc * cos_b, rc
    n2 = 1.0 - qa2 + qc2
    n1 = -qa1 + qc1
    n0 = -qa0 - 1.0 + qc0
    p2_, p1_, p0_ = -qc2, -qc1, 1.0 - qc0
    d1, d0 = 2.0 * cos_a, -2.0 * cos_g
    c4 = n2 * n2 + p2_ * d1 * d1
    c3 = (2 * n2 * n1 - 2 * cos_g * (n2 * d1) + 2 * p2_ * d1 * d0
          + p1_ * d1 * d1)
    c2_ = (2 * n2 * n0 + n1 * n1 - 2 * cos_g * (n2 * d0 + n1 * d1)
           + p2_ * d0 * d0 + 2 * p1_ * d1 * d0 + p0_ * d1 * d1)
    c1 = (2 * n1 * n0 - 2 * cos_g * (n1 * d0 + n0 * d1)
          + p1_ * d0 * d0 + 2 * p0_ * d1 * d0)
    c0 = n0 * n0 - 2 * cos_g * (n0 * d0) + p0_ * d0 * d0
    c4s = _guard(c4, 1e-12)
    roots, root_ok = _solve_quartic(c3 / c4s, c2_ / c4s, c1 / c4s, c0 / c4s)

    sb = _sqrt(b2)
    u1w = _sub3(P[1], P[0])
    i1w = _rsqrt(_dot3(u1w, u1w) + 1e-30)
    e1w = [u1w[c] * i1w for c in range(3)]
    v1w = _sub3(P[2], P[0])
    dw = _dot3(v1w, e1w)
    vpw = [v1w[c] - dw * e1w[c] for c in range(3)]
    i2w = _rsqrt(_dot3(vpw, vpw) + 1e-30)
    e2w = [vpw[c] * i2w for c in range(3)]
    ew = (e1w, e2w, _cross3(e1w, e2w))
    cw = [_div3(P[0][c] + P[1][c] + P[2][c]) for c in range(3)]

    poses, valids = [], []
    for k in range(N_ROOTS):
        v = roots[k]
        D = d1 * v + d0
        N = (n2 * v + n1) * v + n0
        u = N * _rcp(_guard(D, 1e-9))
        s1 = sb * _rsqrt(torch.clamp(1.0 + v * v - 2.0 * v * cos_b, min=1e-12))
        s2 = u * s1
        s3 = v * s1
        valid = (sample_valid & root_ok[k] & (v > 1e-6) & (u > 1e-6)
                 & (D.abs() > 1e-9))
        for _ in range(N_DEPTH_POLISH):
            r1 = s2 * s2 + s3 * s3 - 2 * s2 * s3 * cos_a - a2
            r2 = s1 * s1 + s3 * s3 - 2 * s1 * s3 * cos_b - b2
            r3 = s1 * s1 + s2 * s2 - 2 * s1 * s2 * cos_g - c2
            j12 = 2 * s2 - 2 * s3 * cos_a
            j13 = 2 * s3 - 2 * s2 * cos_a
            j21 = 2 * s1 - 2 * s3 * cos_b
            j23 = 2 * s3 - 2 * s1 * cos_b
            j31 = 2 * s1 - 2 * s2 * cos_g
            j32 = 2 * s2 - 2 * s1 * cos_g
            det = (- j12 * (0.0 - j23 * j31) + j13 * (j21 * j32 - 0.0))
            rdet = _rcp(_guard(det, 1e-9))
            b1, b2r, b3 = -r1, -r2, -r3
            ds1 = (b1 * (0.0 - j23 * j32) - j12 * (b2r * 0.0 - j23 * b3)
                   + j13 * (b2r * j32 - 0.0 * b3)) * rdet
            ds2 = (0.0 - b1 * (j21 * 0.0 - j23 * j31)
                   + j13 * (j21 * b3 - b2r * j31)) * rdet
            ds3 = (0.0 - j12 * (j21 * b3 - b2r * j31)
                   + b1 * (j21 * j32 - 0.0)) * rdet
            lim = 0.1 * s1.abs() + 1e-6
            s1, s2, s3 = (s1 + _clip(ds1, -lim, lim), s2 + _clip(ds2, -lim, lim),
                          s3 + _clip(ds3, -lim, lim))
        valids.append(valid & (s1 > 0) & (s2 > 0) & (s3 > 0))

        C = [[F[j][c] * (s1, s2, s3)[j] for c in range(3)] for j in range(3)]
        u1 = _sub3(C[1], C[0])
        e1 = [u1[c] * i1w for c in range(3)]
        v1 = _sub3(C[2], C[0])
        e2 = [(v1[c] - dw * e1[c]) * i2w for c in range(3)]
        ec = (e1, e2, _cross3(e1, e2))
        R = [[ec[0][r] * ew[0][c] + ec[1][r] * ew[1][c] + ec[2][r] * ew[2][c]
              for c in range(3)] for r in range(3)]
        ccm = [_div3(C[0][c] + C[1][c] + C[2][c]) for c in range(3)]
        t = [ccm[r] - (R[r][0] * cw[0] + R[r][1] * cw[1] + R[r][2] * cw[2])
             for r in range(3)]
        poses.append([R[0] + [t[0]], [R[1][c] * ay for c in range(3)] + [t[1] * ay],
                      R[2] + [t[2]]])
    return poses, valids


def _point_terms(pose, n, thr_sq, X_p, pix_p):
    """(r2, t2, z2) of pool row n under ``pose``: the squared residual
    (3e38 behind the camera), the inlier bound thr^2 z^2 and z^2, in the
    kernel's order of operations."""
    Xx, Xy, Xz = X_p[n, 0], X_p[n, 1], X_p[n, 2]
    xc, yc, zc = (row[0] * Xx + row[1] * Xy + row[2] * Xz + row[3] for row in pose)
    a_ = xc - pix_p[n, 0] * zc
    b_ = yc - pix_p[n, 1] * zc
    r2 = a_ * a_ + b_ * b_
    z2 = torch.clamp(zc * zc, min=1e-30)
    return torch.where(zc <= 1e-6, FAR, r2), thr_sq * z2, z2


def score_pose(pose, n_score, thr_sq, X_p, pix_p, mask_p):
    """(msac, count) of ``pose`` over the first n_score pool rows: the
    division-deferred score, ``csrc/sweep_pnp.cuh`` ``score_pose`` under
    the ``Exact`` policy."""
    count = msac = torch.zeros_like(pose[0][0])
    for n in range(n_score):
        r2, t2, z2 = _point_terms(pose, n, thr_sq, X_p, pix_p)
        count = count + torch.where(r2 <= t2, mask_p[n], 0.0)
        msac = msac + torch.minimum(r2, t2) * _rcp(z2) * mask_p[n]
    return msac, count


def solve_and_score(P, F, sample_valid, n_score, thr_sq, ay, X_p, pix_p,
                    mask_p):
    """``solve_poses``, then ``score_pose`` of each root: (msac list[4],
    count list[4]); an invalid root gets (3.4e38, -1).  Shared by the
    large-pool sweep."""
    poses, valid = solve_poses(P, F, sample_valid, ay)
    msacs, counts = [], []
    for pose, ok in zip(poses, valid):
        msac, count = score_pose(pose, n_score, thr_sq, X_p, pix_p, mask_p)
        msacs.append(torch.where(ok, msac, BIG))
        counts.append(torch.where(ok, count, -1.0))
    return msacs, counts


def _best_roots(msacs, counts):
    """Best root of each sample under both rules, in root order."""
    a_msac = torch.full_like(msacs[0], BIG)
    a_count = torch.full_like(msacs[0], -1.0)
    a_root = torch.zeros_like(msacs[0], dtype=torch.int64)
    b_msac, b_count, b_root = a_msac.clone(), a_count.clone(), a_root.clone()
    for k in range(N_ROOTS):
        msac, count = msacs[k], counts[k]
        upd = msac < a_msac
        a_count = torch.where(upd, count, a_count)
        a_root = torch.where(upd, k, a_root)
        a_msac = torch.minimum(msac, a_msac)
        upd = (count > b_count) | ((count == b_count) & (msac < b_msac))
        b_count = torch.where(upd, count, b_count)
        b_msac = torch.where(upd, msac, b_msac)
        b_root = torch.where(upd, k, b_root)
    return a_msac, a_count, a_root, b_msac, b_count, b_root


# The decision-level hold of the kernels (their `Fused` score: FMAs, MUFU's
# reciprocal) to the plain version, on full records (root-major, s * B + r
# order): samples and validity equal (the solve is exact), a count moved
# only by scored points at the inlier cut (``cut_margins``), MSAC within
# MSAC_RTOL on MSAC_MOST of the valid pairs and MSAC_RTOL_ALL on all, and
# the plain winner's count equal; rows 5 and 9 share them.
MSAC_RTOL, MSAC_MOST, MSAC_RTOL_ALL, COUNT_CUT = (
    sw.MSAC_RTOL, sw.MSAC_MOST, sw.MSAC_RTOL_ALL, sw.COUNT_CUT)


def root_of(poses, k):
    """The pose of root ``k`` (a tensor of root ids) per element."""
    return [[torch.stack([p[r][c] for p in poses]).gather(0, k[None])[0]
             for c in range(4)] for r in range(3)]


def near_cut(pose, n_score, thr_sq, X_p, pix_p, mask_p):
    """(weight of the scored points of weight > 0 that are inliers within
    COUNT_CUT of the cut, |r2 - t| / t <= COUNT_CUT, under ``pose``; the
    weight of such outliers), in the plain arithmetic."""
    near_in = near_out = torch.zeros_like(pose[0][0])
    for n in range(n_score):
        r2, t2, _ = _point_terms(pose, n, thr_sq, X_p, pix_p)
        near = ((r2 - t2).abs() / t2 <= COUNT_CUT) & (mask_p[n] > 0)
        near_in = near_in + torch.where(near & (r2 <= t2), mask_p[n], 0.0)
        near_out = near_out + torch.where(near & (r2 > t2), mask_p[n], 0.0)
    return near_in, near_out


def cut_margins(X_p, f_p, pix_p, mask_p, thr_sq, ay, seeds, n_points, n_score,
                n_hyp, block_h, hyp):
    """``near_cut`` of (sample, root) pairs ``hyp`` (indices into the full
    records, root * n_hyp + s * B + r) of a ``_sweep_plain`` call with these
    arguments, each [len(hyp)]: a kernel whose score rounds otherwise may
    lower a count by at most the first and raise it by at most the
    second."""
    dev = X_p.device
    hyp = torch.as_tensor(hyp, dtype=torch.int64, device=dev)
    B, lan = n_hyp // SUB, block_h // SUB
    k, o = hyp // n_hyp, hyp % n_hyp
    s, r = o // B, o % B
    idx = draw_sample((r // lan) * block_h + s * lan + r % lan, seeds, n_points)
    vmask = sample_bitmask(mask_p)
    sample_valid = (((vmask >> idx[0]) & (vmask >> idx[1]) & (vmask >> idx[2])) & 1) == 1
    P = [[X_p[i, c] for c in range(3)] for i in idx]
    F = [[f_p[i, c] for c in range(3)] for i in idx]
    thr, ay_t = (torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (thr_sq, ay))
    poses, _ = solve_poses(P, F, sample_valid, ay_t)
    return near_cut(root_of(poses, k), n_score, thr, X_p, pix_p, mask_p)


def hold_full(out_k, out_p, margins) -> dict:
    """Full records (msac, counts, keys) [4 n_hyp] of a kernel against the
    plain version's: samples (keys) and validity equal; counts equal but
    where the pair's points at the inlier cut (``margins(hyp)``, e.g.
    ``cut_margins``) explain the difference, in its direction and size;
    MSAC by MSAC_RTOL; the count of the plain min-MSAC pair equal.  Returns
    the readings, ``flipped`` (the pairs whose count moved) and
    ``failures`` (empty when every criterion held)."""
    m_k, c_k, p_k = (t.double() if t.is_floating_point() else t for t in out_k)
    m_p, c_p, p_p = (t.double() if t.is_floating_point() else t for t in out_p)
    fails = []
    if not torch.equal(p_k, p_p):
        fails.append("samples differ")
    inv_k, inv_p = m_k >= 3e38, m_p >= 3e38
    if not torch.equal(inv_k, inv_p):
        fails.append(f"validity differs on {int((inv_k != inv_p).sum())} pairs")
    flipped = torch.nonzero((c_k != c_p) & (inv_k == inv_p)).flatten()
    if len(flipped):
        near_in, near_out = (t.to(flipped.device).double() for t in margins(flipped))
        d = c_k[flipped] - c_p[flipped]
        if not bool(((d >= -near_in) & (d <= near_out)).all()):
            fails.append(f"{int(((d < -near_in) | (d > near_out)).sum())} count "
                         f"flips off the inlier cut")
    both = ~(inv_k | inv_p)
    rel = (m_k[both] / m_p[both] - 1.0).abs()
    within = float((rel <= MSAC_RTOL).double().mean()) if len(rel) else 1.0
    max_rel = float(rel.max()) if len(rel) else 0.0
    if within < MSAC_MOST or max_rel > MSAC_RTOL_ALL:
        fails.append(f"MSAC within {MSAC_RTOL} on {within}, max rel {max_rel}")
    w = int(m_p.argmin())
    if float(c_k[w]) != float(c_p[w]):
        fails.append(f"plain winner {w}: count {float(c_k[w])} vs {float(c_p[w])}")
    return {"valid_pairs": int((~inv_p).sum()), "count_flips": len(flipped),
            "counts_equal_fraction": float((c_k == c_p).double().mean()),
            "msac_within_1e-4_fraction": within, "max_rel_err": max_rel,
            "plain_winner_count": [float(c_k[w]), float(c_p[w])],
            "flipped": flipped, "failures": fails}


def hold_reduced(red_k, red_p, full_k, flipped) -> dict:
    """Reduced records (msac, counts, keys) [2, B] of a kernel against the
    plain version's, with the kernel's full records ``full_k`` (msac,
    counts, keys [4 n_hyp], root-major) of the same call and ``flipped``
    (``hold_full``): the count row's counts equal but in records holding a
    flipped pair; where a record keeps another (sample, root) than the
    plain version's, that pair is a near-tie in the kernel's own full
    records (the plain record's count, MSAC within MSAC_RTOL_ALL of the
    kernel's record).  Keys: the records' packed (sample, root)."""
    m_k, c_k, p_k = red_k
    m_p, c_p, p_p = red_p
    B = m_k.shape[1]
    mf, cf, pf = (t.reshape(N_ROOTS * SUB, B) for t in full_k)
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
                fails.append(f"row {row} record {r}: another pair, not a near-tie")
    return {"count_row_equal_fraction": float((c_k[1] == c_p[1]).double().mean()),
            "near_ties_used": near, "failures": fails}


def full_keys(packed, n_hyp):
    """The reduced records' keys (packed + root * 4096) of full records'
    packed samples [4 n_hyp]."""
    root = torch.arange(N_ROOTS, device=packed.device).repeat_interleave(n_hyp)
    return packed.long().repeat(N_ROOTS) + root * 4096


def _sweep_plain(X_p, f_p, pix_p, mask_p, thr_sq, ay, seeds, n_points,
                 n_score, n_hyp, block_h, full):
    """The kernel's arithmetic on [SUB, R] tensors of samples, chunked over
    records.  Returns the raw records: full (f [8, n_hyp] = 4 roots' msac
    then 4 roots' counts, i [n_hyp]) in s * B + r order, or reduced
    (f [4, B], i [2, B])."""
    B = n_hyp // SUB
    lan = block_h // SUB
    vmask = sample_bitmask(mask_p)
    thr_sq = torch.as_tensor(thr_sq, dtype=torch.float32, device=X_p.device)
    ay = torch.as_tensor(ay, dtype=torch.float32, device=X_p.device)
    fs, ps = [], []
    for r0 in range(0, B, PLAIN_CHUNK):
        flat = record_flat_ids(r0, min(B, r0 + PLAIN_CHUNK), lan, X_p.device)
        msacs, counts, packed = _eval(flat, seeds, vmask, n_points, n_score,
                                      thr_sq, ay, X_p, f_p, pix_p, mask_p)
        if full:
            fs.append(torch.stack(msacs + counts))
            ps.append(packed.to(torch.int32))
            continue
        a_msac, a_count, a_root, b_msac, b_count, b_root = _best_roots(
            msacs, counts)
        fa, pa = reduce_records(a_msac, a_count, packed + a_root * 4096, BIG)
        fb, pb = reduce_records(b_msac, b_count, packed + b_root * 4096, BIG)
        fs.append(torch.stack([fa[0], fa[1], fb[2], fb[3]]))
        ps.append(torch.stack([pa[0], pb[1]]))
    if full:  # [8, SUB, B] -> s * B + r order
        return torch.cat(fs, -1).reshape(2 * N_ROOTS, -1), torch.cat(ps, -1).reshape(-1)
    return torch.cat(fs, -1), torch.cat(ps, -1)


def _sweep_kernel(X_p, f_p, pix_p, mask_p, thr_sq, ay, seeds, n_points,
                  n_score, n_hyp, block_h, full):
    """Launch ``csrc/sweep_pnp.cu`` on PyTorch's current stream.  ``thr_sq``
    and ``ay``, numbers or 0-d tensors, go by value or by pointer
    (``_build.f32_arg``)."""
    dev = X_p.device
    vmask = sample_bitmask(mask_p)
    (thr_v, thr_t), (ay_v, ay_t) = _build.f32_arg(thr_sq, dev), _build.f32_arg(ay, dev)
    _build.check_inputs("sweep_pnp", dev, X=(X_p, torch.float32),
                        bearings=(f_p, torch.float32), pix=(pix_p, torch.float32),
                        mask=(mask_p, torch.float32), vmask=(vmask, torch.int32))
    if block_h % 256 or n_hyp % block_h or not 3 <= n_points <= n_score <= MAX_POINTS:
        raise ValueError(f"block_h must be a multiple of 256 dividing n_hyp and "
                         f"3 <= n_points <= n <= {MAX_POINTS}; got n_hyp={n_hyp}, "
                         f"block_h={block_h}, n_points={n_points}, n={n_score}")
    B = n_hyp // SUB
    if full:
        f = torch.empty((2 * N_ROOTS, n_hyp), dtype=torch.float32, device=dev)
        i = torch.empty((n_hyp,), dtype=torch.int32, device=dev)
    else:
        f = torch.empty((4, B), dtype=torch.float32, device=dev)
        i = torch.empty((2, B), dtype=torch.int32, device=dev)
    _build.launch("pnp_ransac_sweep", dev, X_p, f_p, pix_p, mask_p, vmask, thr_v, ay_v,
                  thr_t, ay_t, *seeds, n_points, n_score, n_hyp, block_h, int(full), f, i)
    return f, i


def prepare(Xw, pix_n, point_mask, threshold_n, ay):
    """The kernel's inputs: (X_p [16,3], unit bearings f_p [16,3], pixels
    (x, ay * y) pix_p [16,2], mask_p [16], thr_sq, ay), padded with zeros;
    thr_sq and ay hold float32 values where they were given (``thr_sq_of``,
    ``_build.f32_of``): floats for numbers, 0-d tensors for tensors, which the
    kernel reads on the card, so the prep never waits for the device."""
    n = Xw.shape[0]
    if n > MAX_POINTS:
        raise ValueError(f"at most {MAX_POINTS} points, got {n}")
    f = torch.cat([pix_n, torch.ones_like(pix_n[..., :1])], -1)
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    ay_f = _build.f32_of(ay)
    pix_s = torch.stack([pix_n[:, 0], pix_n[:, 1] * ay_f], -1)
    X_p = Xw.new_zeros((MAX_POINTS, 3), dtype=torch.float32)
    X_p[:n] = Xw
    f_p = Xw.new_zeros((MAX_POINTS, 3), dtype=torch.float32)
    f_p[:n] = f
    pix_p = Xw.new_zeros((MAX_POINTS, 2), dtype=torch.float32)
    pix_p[:n] = pix_s
    mask_p = Xw.new_zeros((MAX_POINTS,), dtype=torch.float32)
    mask_p[:n] = point_mask.to(torch.float32)
    return X_p, f_p, pix_p, mask_p, thr_sq_of(threshold_n), ay_f


def _sweep(seed, Xw, pix_n, point_mask, threshold_n, n_hyp, n_points,
           full_records, block_h, ay, core):
    n = Xw.shape[0]
    n_points = n if n_points is None else int(n_points)
    n_hyp = int(n_hyp)
    if block_h is None:
        block_h = min(BLOCK_H, max(SUB, (n_hyp // SUB) * SUB))
    n_hyp = max(n_hyp // block_h, 1) * block_h
    fo, io = core(*prepare(Xw, pix_n, point_mask, threshold_n, ay),
                  draw_seeds(seed, 3), n_points, n, n_hyp, block_h,
                  full_records)
    if full_records:
        return (fo[:N_ROOTS].reshape(-1), fo[N_ROOTS:].reshape(-1),
                io.repeat(N_ROOTS))
    return fo[0::2], fo[1::2], io


def pnp_ransac_sweep(seed, Xw: torch.Tensor, pix_n: torch.Tensor,
                     point_mask: torch.Tensor, threshold_n, n_hyp: int,
                     n_points: int | None = None, full_records: bool = False,
                     block_h: int | None = None, ay=1.0):
    """Fused P3P sweep on normalized coordinates.

    Default: block-reduced records ``(msac [2, B], counts [2, B], packed
    [2, B])``, B = n_hyp / 8; row 0 by min MSAC, row 1 by (max count, min
    MSAC), each the best of its sample's four roots, whose id sits in
    packed bits 12-13 (``unpack_sample3`` ignores it).
    ``full_records=True``: per-(sample, root) ``(msac [4 n_hyp], counts
    [4 n_hyp], packed [4 n_hyp])``, root-major.

    ``threshold_n`` is in fx-normalized units (pixel threshold / fx);
    ``ay = fy / fx`` makes the bound pixel-true under anisotropic K.
    Samples touching ``point_mask == 0`` points are invalid.  CUDA tensors
    go through the kernel (or raise); CPU tensors through the plain
    version."""
    core = _sweep_plain if Xw.device.type == "cpu" else _sweep_kernel
    return _sweep(seed, Xw, pix_n, point_mask, threshold_n, n_hyp, n_points,
                  full_records, block_h, ay, core)


def pnp_ransac_sweep_ref(seed, Xw, pix_n, point_mask, threshold_n, n_hyp,
                         n_points=None, full_records=False, block_h=None,
                         ay=1.0):
    """The plain PyTorch version on any device (what the CPU path runs;
    the card's reference for the kernel)."""
    return _sweep(seed, Xw, pix_n, point_mask, threshold_n, n_hyp, n_points,
                  full_records, block_h, ay, _sweep_plain)


def valid_root_share(seed, Xw, pix_n, point_mask, threshold_n, n_hyp,
                     n_points=None, block_h=None, ay=1.0) -> float:
    """The share of (sample, root) pairs of a sweep call that are valid, read
    from its inputs by the plain version (``counts >= 0`` of its full
    records).  Whatever computes the sweep scores that share of the pairs,
    so it scales the score term of the call's bound
    (``utils.profiling.issued_ops``)."""
    counts = pnp_ransac_sweep_ref(seed, Xw, pix_n, point_mask, threshold_n, n_hyp,
                                  n_points, True, block_h, ay)[1]
    return float((counts >= 0).double().mean())


def unpack_sample3(packed: int) -> np.ndarray:
    p = int(packed)
    return np.array([p & 15, (p >> 4) & 15, (p >> 8) & 15], dtype=np.int32)
