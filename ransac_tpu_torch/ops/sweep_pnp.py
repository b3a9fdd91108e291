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
tensor it launches ``csrc/sweep_pnp.cu`` or raises.  Every reciprocal is
an exact division (the TPU took approximate ones).  ``rsqrt`` is
``torch.rsqrt``: on the card the same ``rsqrtf`` as the kernel, so the two
agree bit for bit there; on the CPU it rounds differently in the last
place, so Grunert's ill-conditioned quartics can flip a root's validity.
"""

from __future__ import annotations

import numpy as np
import torch

from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops.linalg import _guard
from ransac_tpu_torch.ops.score import _thr_sq
from ransac_tpu_torch.ops.sweep import (SUB, check_inputs, draw_sample,
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

#: Kernel launches in this process.  Only the CUDA path adds to it, one per
#: launch; the plain version never does.
LAUNCHES = 0

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


def solve_and_score(P, F, sample_valid, n_score, thr_sq, ay, X_p, pix_p,
                    mask_p):
    """Grunert's P3P of the sampled world points P[j] and unit bearings
    F[j] (lists of 3 tensors each), and the score of each of the four roots
    over the first n_score pool rows: (msac list[4], count list[4]); an
    invalid root gets (3.4e38, -1).  Shared by the large-pool sweep."""
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

    msacs, counts = [], []
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
        valid = valid & (s1 > 0) & (s2 > 0) & (s3 > 0)

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
        Ry = [R[1][c] * ay for c in range(3)]
        ty = t[1] * ay

        count = torch.zeros_like(s1)
        msac = torch.zeros_like(s1)
        for n in range(n_score):
            Xx, Xy, Xz = X_p[n, 0], X_p[n, 1], X_p[n, 2]
            xc = R[0][0] * Xx + R[0][1] * Xy + R[0][2] * Xz + t[0]
            yc = Ry[0] * Xx + Ry[1] * Xy + Ry[2] * Xz + ty
            zc = R[2][0] * Xx + R[2][1] * Xy + R[2][2] * Xz + t[2]
            behind = zc <= 1e-6
            a_ = xc - pix_p[n, 0] * zc
            b_ = yc - pix_p[n, 1] * zc
            r2_ = a_ * a_ + b_ * b_
            z2_ = torch.clamp(zc * zc, min=1e-30)
            t2_ = thr_sq * z2_
            r2_ = torch.where(behind, FAR, r2_)
            count = count + torch.where(r2_ <= t2_, mask_p[n], 0.0)
            msac = msac + torch.minimum(r2_, t2_) * _rcp(z2_) * mask_p[n]
        msacs.append(torch.where(valid, msac, BIG))
        counts.append(torch.where(valid, count, -1.0))
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


def _sweep_plain(X_p, f_p, pix_p, mask_p, thr_sq, ay, seeds, n_points,
                 n_score, n_hyp, block_h, full):
    """The kernel's arithmetic on [SUB, R] tensors of samples, chunked over
    records.  Returns the raw records: full (f [8, n_hyp] = 4 roots' msac
    then 4 roots' counts, i [n_hyp]) in s * B + r order, or reduced
    (f [4, B], i [2, B])."""
    B = n_hyp // SUB
    lan = block_h // SUB
    vmask = sample_bitmask(mask_p)
    thr_sq = torch.tensor(thr_sq, dtype=torch.float32, device=X_p.device)
    ay = torch.tensor(ay, dtype=torch.float32, device=X_p.device)
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
    """Launch ``csrc/sweep_pnp.cu`` on PyTorch's current stream."""
    global LAUNCHES
    dev = X_p.device
    vmask = sample_bitmask(mask_p)
    check_inputs("sweep_pnp", dev, X=(X_p, torch.float32),
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
    with torch.cuda.device(dev):
        err = _build.load().sweep_pnp_launch(
            X_p.data_ptr(), f_p.data_ptr(), pix_p.data_ptr(), mask_p.data_ptr(),
            vmask.data_ptr(), thr_sq, ay, *seeds, n_points, n_score, n_hyp,
            block_h, int(full), f.data_ptr(), i.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sweep_pnp_launch failed: CUDA error {err}")
    LAUNCHES += 1
    return f, i


def prepare(Xw, pix_n, point_mask, threshold_n, ay):
    """The kernel's inputs: (X_p [16,3], unit bearings f_p [16,3], pixels
    (x, ay * y) pix_p [16,2], mask_p [16], thr_sq, ay), padded with zeros;
    thr_sq and ay are Python floats holding float32 values."""
    n = Xw.shape[0]
    if n > MAX_POINTS:
        raise ValueError(f"at most {MAX_POINTS} points, got {n}")
    f = torch.cat([pix_n, torch.ones_like(pix_n[..., :1])], -1)
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    ay_f = float(np.float32(float(ay)))
    pix_s = pix_n * torch.tensor([1.0, ay_f], dtype=pix_n.dtype,
                                 device=pix_n.device)
    X_p = Xw.new_zeros((MAX_POINTS, 3), dtype=torch.float32)
    X_p[:n] = Xw
    f_p = Xw.new_zeros((MAX_POINTS, 3), dtype=torch.float32)
    f_p[:n] = f
    pix_p = Xw.new_zeros((MAX_POINTS, 2), dtype=torch.float32)
    pix_p[:n] = pix_s
    mask_p = Xw.new_zeros((MAX_POINTS,), dtype=torch.float32)
    mask_p[:n] = point_mask.to(torch.float32)
    return X_p, f_p, pix_p, mask_p, _thr_sq(threshold_n), ay_f


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


def unpack_sample3(packed: int) -> np.ndarray:
    p = int(packed)
    return np.array([p & 15, (p >> 4) & 15, (p >> 8) & 15], dtype=np.int32)
