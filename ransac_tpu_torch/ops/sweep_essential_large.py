"""Large-pool 8-point essential-matrix sweep: the CUDA kernel's wrapper, its
plain PyTorch version, and ``minimal_f_canonical``.

Port of ``ransac_tpu.ops.pallas.sweep_essential_large``, the fused RANSAC
of the two-view pipeline for pools of up to 1024 correspondences.  Every
hypothesis draws 8 pool slots with the windowed counter sampler of
``ops.sweep_large`` (seeds 0-7, [8] windows, [9] shuffle), solves F by the
division- and pivot-free canonical-frame method (the adjugate frames of the
first four points of each image, then the generalized cross product of the
other four in that frame; no rank-2 step) and scores every point with the
division-deferred Sampson test.  Both images share one normalization
(masked centroids, one scale from the mean distance over both), so the
Sampson test keeps its meaning and the threshold scales by s^2.  Records
carry flat hypothesis ids; ``sample_indices_for8`` replays a sample and
``minimal_f_canonical`` re-solves it with the kernel's own arithmetic.

For a CPU tensor the wrapper computes the plain version; for a CUDA tensor
it launches ``csrc/sweep_essential_large.cu`` (a one-block prep kernel that
normalizes and builds the shuffled table, then the sweep, from one C call)
or raises.  Divisions are exact where the TPU took approximate
reciprocals; ``rsqrt`` is ``torch.rsqrt`` (``_rsqrt``), the card's
``rsqrtf``.  The kernel's prep and solve round every operation as the
plain version does (the table, pool order, normalization, samples and
validity are equal); its Sampson score rounds each product-sum once
(FMA), takes MUFU's reciprocal, and sums each hypothesis' rows with 32 lanes
and a tree where the plain version keeps 4 accumulator pairs, so the two
agree in their decisions: ``ops.sweep.hold_full`` / ``hold_reduced`` with
this module's ``cut_margins``, on the full records that
``_sweep_kernel(..., full=True)`` and ``_sweep_plain(..., full=True)``
write (the JAX kernel has no such mode).
"""

from __future__ import annotations

import torch

from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops.sweep import (COUNT_CUT, INVALID, SUB, _frame,
                                        draw_seeds,
                                        record_flat_ids, reduce_records,
                                        rescale)
from ransac_tpu_torch.ops.sweep_large import (masked_centroid_scale, n_hyp_for,
                                              pool_table, sample_slots,
                                              shuffle_order, sqrt2_over,
                                              tree_sum)

BLOCK_H = 2048
MAX_POINTS = 1024
N_ACC = 4
N_SEEDS = 10
PREP_FLOATS = 5 * MAX_POINTS + 7   # csrc/sweep_essential_large.cu's prep buffer
SOLVE_FLOATS = 10                  # and after it, a hypothesis' F and validity
# Records per chunk of the plain version (bounds its memory, not its result).
PLAIN_CHUNK = 1 << 14

#: The plain version's rsqrt (the kernel's is rsqrtf, which is what
#: torch.rsqrt computes on the card).
_rsqrt = torch.rsqrt


def sample_indices_for8(flat, seeds, n_valid, block_h: int = BLOCK_H):
    """[..., 8] pool slots of flat hypothesis ids (the replay of
    ``sweep_essential_large.sample_indices_for8``); ``block_h`` is the
    sweep's."""
    return sample_slots(flat, seeds[:8], seeds[8], n_valid, block_h, 8)


def _sq_sum(xs):
    acc = xs[0] * xs[0]
    for x in xs[1:]:
        acc = acc + x * x
    return acc


def _frame_adj(xs, ys):
    """Adjugate frame of 4 points scaled to unit Frobenius norm (a list of
    rows of tensors) and its validity."""
    A, ok = _frame(xs, ys)
    T = [[A[1][1] * A[2][2] - A[1][2] * A[2][1],
          A[0][2] * A[2][1] - A[0][1] * A[2][2],
          A[0][1] * A[1][2] - A[0][2] * A[1][1]],
         [A[1][2] * A[2][0] - A[1][0] * A[2][2],
          A[0][0] * A[2][2] - A[0][2] * A[2][0],
          A[0][2] * A[1][0] - A[0][0] * A[1][2]],
         [A[1][0] * A[2][1] - A[1][1] * A[2][0],
          A[0][1] * A[2][0] - A[0][0] * A[2][1],
          A[0][0] * A[1][1] - A[0][1] * A[1][0]]]
    inv = _rsqrt(torch.clamp(_sq_sum([t for row in T for t in row]), min=1e-30))
    return [[t * inv for t in row] for row in T], ok


def canonical_f(u1, v1, u2, v2):
    """The canonical-frame 8-point solve (sweep_essential_large.py:63-148)
    of 8 sampled pairs (lists of 8 tensors): (F as 9 tensors, row-major, of
    unit Frobenius norm; valid)."""
    T1, ok1 = _frame_adj(u1[:4], v1[:4])
    T2, ok2 = _frame_adj(u2[:4], v2[:4])
    rows = []
    for j in range(4, 8):
        p = T1[0][0] * u1[j] + T1[0][1] * v1[j] + T1[0][2]
        q = T1[1][0] * u1[j] + T1[1][1] * v1[j] + T1[1][2]
        r = T1[2][0] * u1[j] + T1[2][1] * v1[j] + T1[2][2]
        s = T2[0][0] * u2[j] + T2[0][1] * v2[j] + T2[0][2]
        t = T2[1][0] * u2[j] + T2[1][1] * v2[j] + T2[1][2]
        w = T2[2][0] * u2[j] + T2[2][1] * v2[j] + T2[2][2]
        c0 = s * q
        rows.append([s * r - c0, t * p - c0, t * r - c0, w * p - c0, w * q - c0])
    m01, m23 = {}, {}
    for i in range(5):
        for j in range(i + 1, 5):
            m01[i, j] = rows[0][i] * rows[1][j] - rows[0][j] * rows[1][i]
            m23[i, j] = rows[2][i] * rows[3][j] - rows[2][j] * rows[3][i]

    def det4(a, b, c, d):
        return (m01[a, b] * m23[c, d] - m01[a, c] * m23[b, d]
                + m01[a, d] * m23[b, c] + m01[b, c] * m23[a, d]
                - m01[b, d] * m23[a, c] + m01[c, d] * m23[a, b])

    f13 = det4(1, 2, 3, 4)
    f21 = -det4(0, 2, 3, 4)
    f23 = det4(0, 1, 3, 4)
    f31 = -det4(0, 1, 2, 4)
    f32 = det4(0, 1, 2, 3)
    f12 = -(f13 + f21 + f23 + f31 + f32)
    P = [[f12 * T1[1][c] + f13 * T1[2][c] for c in range(3)],
         [f21 * T1[0][c] + f23 * T1[2][c] for c in range(3)],
         [f31 * T1[0][c] + f32 * T1[1][c] for c in range(3)]]
    F = [T2[0][r] * P[0][c] + T2[1][r] * P[1][c] + T2[2][r] * P[2][c]
         for r in range(3) for c in range(3)]
    fn2 = _sq_sum(F)
    finv = _rsqrt(torch.clamp(fn2, min=1e-36))
    return [f * finv for f in F], ok1 & ok2 & (fn2 > 1e-30)


def sampson(F, a, b, c, d, wp, thr_sq, cnt, ms):
    """The division-deferred Sampson test of F (9 tensors) on the
    correspondence (a, b) <-> (c, d) of weight wp, added to one accumulator
    pair (cnt, ms): inlier iff (x2' F x1)^2 <= thr^2 max(denom, 1e-12);
    MSAC term min(num, thr^2 dmax) / dmax.  Returns the new pair."""
    fx0 = F[0] * a + F[1] * b + F[2]
    fx1 = F[3] * a + F[4] * b + F[5]
    fx2 = F[6] * a + F[7] * b + F[8]
    ft0 = F[0] * c + F[3] * d + F[6]
    ft1 = F[1] * c + F[4] * d + F[7]
    e = c * fx0 + d * fx1 + fx2
    denom = fx0 * fx0 + fx1 * fx1 + ft0 * ft0 + ft1 * ft1
    dmax = torch.clamp(denom, min=1e-12)
    n2 = e * e
    t2 = thr_sq * dmax
    return (cnt + torch.where(n2 <= t2, wp, 0.0),
            ms + torch.minimum(n2, t2) * (1.0 / dmax) * wp)


def minimal_f_canonical(x1s: torch.Tensor, x2s: torch.Tensor):
    """(F [..., 3, 3], ok [...]) of normalized 8-point samples x1s/x2s
    [..., 8, 2], with the kernel's arithmetic: the re-solve of a replayed
    winner scores what the sweep scored."""
    F, ok = canonical_f(*([x[..., j, c] for j in range(8)]
                          for x, c in ((x1s, 0), (x1s, 1), (x2s, 0), (x2s, 1))))
    return torch.stack(F, -1).reshape(*F[0].shape, 3, 3), ok


# ------------------------------------------------------------ the sweep
def _prepare(x1, x2, point_mask, threshold_sq, seeds):
    """The plain version of the prep kernel: (table [n_rows, 5], thr_sq,
    inv_s2, n_valid, order, (m1 [2], m2 [2], s))."""
    x1 = x1.to(torch.float32)
    x2 = x2.to(torch.float32)
    maskf = point_mask.to(torch.float32)
    order = shuffle_order(seeds[9], maskf)
    wsum = torch.clamp(tree_sum(maskf), min=1.0)
    m1x, m1y, d1 = masked_centroid_scale(x1, maskf, wsum)
    m2x, m2y, d2 = masked_centroid_scale(x2, maskf, wsum)
    s = sqrt2_over((d1 + d2) / (2.0 * wsum))
    table = pool_table([(x1[:, 0] - m1x) * s, (x1[:, 1] - m1y) * s,
                        (x2[:, 0] - m2x) * s, (x2[:, 1] - m2y) * s], maskf, order)
    thr = torch.tensor(float(threshold_sq), dtype=torch.float32, device=x1.device)
    return (table, thr * s * s, 1.0 / (s * s), (maskf > 0).sum(), order,
            (torch.stack([m1x, m1y]), torch.stack([m2x, m2y]), s))


def _score_plain(table, thr_sq, seeds, n_valid, n_hyp, block_h, full=False):
    """The kernel's per-hypothesis arithmetic on [SUB, R] tensors, chunked
    over records, normalized units: reduced records (f [4, B], i [2, B]),
    or with ``full`` every hypothesis' (f [2, n_hyp] = msac, count; i
    [n_hyp] flat ids) in s * B + r order."""
    B = n_hyp // SUB
    lan = block_h // SUB
    n_rows = table.shape[0]
    cols = table.unbind(1)
    fs, ps = [], []
    for r0 in range(0, B, PLAIN_CHUNK):
        flat = record_flat_ids(r0, min(B, r0 + PLAIN_CHUNK), lan, table.device)
        slot = sample_slots(flat, seeds[:8], seeds[8], n_valid, block_h, 8)
        g = table[slot]  # [SUB, R, 8, 5]
        F, valid = canonical_f(*([g[..., j, c] for j in range(8)] for c in range(4)))
        valid = valid & (n_valid >= 8)
        cnt = [torch.zeros_like(F[0]) for _ in range(N_ACC)]
        ms = [torch.zeros_like(F[0]) for _ in range(N_ACC)]
        for n in range(n_rows):
            k = n % N_ACC
            cnt[k], ms[k] = sampson(F, *(col[n] for col in cols), thr_sq,
                                    cnt[k], ms[k])
        count, msac = cnt[0], ms[0]
        for k in range(1, N_ACC):
            count = count + cnt[k]
            msac = msac + ms[k]
        msac = torch.where(valid, msac, INVALID)
        count = torch.where(valid, count, -1.0)
        if full:
            fs.append(torch.stack([msac, count]))
            ps.append(flat.to(torch.int32))
            continue
        f, p = reduce_records(msac, count, flat)
        fs.append(f)
        ps.append(p)
    if full:  # [2, SUB, B] -> s * B + r order
        return torch.cat(fs, -1).reshape(2, -1), torch.cat(ps, -1).reshape(-1)
    return torch.cat(fs, -1), torch.cat(ps, -1)


def _sweep_plain(x1, x2, point_mask, threshold_sq, seeds, n_hyp, block_h,
                 full=False):
    """The plain version of one kernel call: (f, i, n_valid, order, (m1,
    m2, s)) with MSAC rescaled; f [4, B], i [2, B], or with ``full`` f [2,
    n_hyp], i [n_hyp] (``_score_plain``)."""
    table, thr, inv_s2, n_valid, order, norm = _prepare(
        x1, x2, point_mask, threshold_sq, seeds)
    f, i = _score_plain(table, thr, seeds, n_valid, n_hyp, block_h, full)
    if full:
        return torch.stack([rescale(f[0], inv_s2), f[1]]), i, n_valid, order, norm
    f = torch.stack([rescale(f[0], inv_s2), f[1], rescale(f[2], inv_s2), f[3]])
    return f, i, n_valid, order, norm


def cut_margins(x1, x2, point_mask, threshold_sq, seeds, n_hyp, block_h, hyp):
    """``ops.sweep.cut_margins`` of the large-pool essential sweep: for
    hypotheses ``hyp`` (indices into the full records, s * B + r order) of
    a ``_sweep_plain`` call with these arguments, in its arithmetic over the
    pool table, (the weight of the points of weight > 0 whose Sampson error
    is within COUNT_CUT of the inlier cut, |n2 - t2| / t2 <= COUNT_CUT,
    inliers; the weight of such outliers; and inf for the determinant
    margin: the solve is exact, so no validity may flip), each
    [len(hyp)]."""
    table, thr, _, n_valid, _, _ = _prepare(x1, x2, point_mask, threshold_sq,
                                            seeds)
    hyp = torch.as_tensor(hyp, dtype=torch.int64, device=table.device)
    B, lan = n_hyp // SUB, block_h // SUB
    s, r = hyp // B, hyp % B
    flat = (r // lan) * block_h + s * lan + r % lan
    g = table[sample_slots(flat, seeds[:8], seeds[8], n_valid, block_h, 8)]
    F, _ = canonical_f(*([g[:, j, c] for j in range(8)] for c in range(4)))
    near_in = torch.zeros_like(F[0])
    near_out = torch.zeros_like(F[0])
    for a, b, c, d, wp in table.unbind(0):
        fx0 = F[0] * a + F[1] * b + F[2]
        fx1 = F[3] * a + F[4] * b + F[5]
        ft0 = F[0] * c + F[3] * d + F[6]
        ft1 = F[1] * c + F[4] * d + F[7]
        e = c * fx0 + d * fx1 + (F[6] * a + F[7] * b + F[8])
        t2 = thr * torch.clamp(fx0 * fx0 + fx1 * fx1 + ft0 * ft0 + ft1 * ft1, min=1e-12)
        n2 = e * e
        near = ((n2 - t2).abs() / t2 <= COUNT_CUT) & (wp > 0)
        near_in = near_in + torch.where(near & (n2 <= t2), wp, 0.0)
        near_out = near_out + torch.where(near & (n2 > t2), wp, 0.0)
    return near_in, near_out, torch.full_like(near_in, float("inf"))


def _sweep_kernel(x1, x2, point_mask, threshold_sq, seeds, n_hyp, block_h,
                  full=False):
    """Launch ``csrc/sweep_essential_large.cu`` on PyTorch's current stream
    (``full``: every hypothesis' record, as ``_sweep_plain``)."""
    dev = x1.device
    x1 = x1.to(torch.float32).contiguous()
    x2 = x2.to(torch.float32).contiguous()
    mask = point_mask.to(torch.float32).contiguous()
    _build.check_inputs("sweep_essential_large", dev, x1=(x1, torch.float32),
                        x2=(x2, torch.float32), mask=(mask, torch.float32))
    n = x1.shape[0]
    if block_h % 256 or n_hyp % block_h or not 1 <= n <= MAX_POINTS:
        raise ValueError(f"block_h must be a multiple of 256 dividing n_hyp and "
                         f"1 <= n <= {MAX_POINTS}; got n_hyp={n_hyp}, "
                         f"block_h={block_h}, n={n}")
    B = n_hyp // SUB
    prep = torch.empty((PREP_FLOATS + SOLVE_FLOATS * n_hyp,), dtype=torch.float32,
                       device=dev)
    aux = torch.empty((n + 1,), dtype=torch.int32, device=dev)
    f = torch.empty((2, n_hyp) if full else (4, B), dtype=torch.float32, device=dev)
    i = torch.empty((n_hyp,) if full else (2, B), dtype=torch.int32, device=dev)
    _build.launch("essential_ransac_sweep_large", dev, x1, x2, mask, float(threshold_sq),
                  *seeds, n, n_hyp, block_h, int(full), prep, aux, f, i)
    k = 5 * MAX_POINTS
    norm = (prep[k + 2:k + 4], prep[k + 4:k + 6], prep[k + 6])
    return f, i, aux[n].long(), aux[:n].long(), norm


def _sweep(seed, x1, x2, point_mask, threshold_sq, n_hyp, block_h, core):
    n = x1.shape[0]
    if n > MAX_POINTS:
        raise ValueError(f"at most {MAX_POINTS} points, got {n}")
    block_h = BLOCK_H if block_h is None else int(block_h)
    seeds = draw_seeds(seed, N_SEEDS)
    f, i, n_valid, order, norm = core(x1, x2, point_mask, threshold_sq, seeds,
                                      n_hyp_for(n_hyp, n, block_h), block_h)
    return f[0::2], f[1::2], i, (seeds, n_valid, order, norm)


def essential_ransac_sweep_large(seed, x1: torch.Tensor, x2: torch.Tensor,
                                 point_mask: torch.Tensor, threshold_sq,
                                 n_hyp: int, block_h: int | None = None):
    """Large-pool fused 8-point sweep on normalized camera coordinates.

    ``threshold_sq`` is the Sampson bound in squared normalized units.
    Returns ``(msac [2, B], counts [2, B], flat_id [2, B], aux)``, B = n_hyp
    / 8 (whole blocks, at least 4 when n > 64); row 0 by min MSAC, row 1 by
    (max count, min MSAC).  ``aux = (seeds, n_valid, order, (m1, m2, s))``:
    replay with ``sample_indices_for8(flat, seeds, n_valid, block_h)`` and
    ``order``; the sweep's frame is ``(x - m) * s``.  Needs >= 8 valid
    points and N <= 1024.  CUDA tensors go through the kernel (or raise);
    CPU tensors through the plain version."""
    core = _sweep_plain if x1.device.type == "cpu" else _sweep_kernel
    return _sweep(seed, x1, x2, point_mask, threshold_sq, n_hyp, block_h, core)


def essential_ransac_sweep_large_ref(seed, x1, x2, point_mask, threshold_sq,
                                     n_hyp, block_h=None):
    """The plain PyTorch version on any device (what the CPU path runs; the
    card's reference for the kernel)."""
    return _sweep(seed, x1, x2, point_mask, threshold_sq, n_hyp, block_h,
                  _sweep_plain)
