"""Large-pool homography-RANSAC sweep and the windowed counter sampler of
the large-pool sweeps: the CUDA kernel's wrapper and its plain PyTorch
version.

Port of ``ransac_tpu.ops.pallas.sweep_large``.  For pools of up to 1024
correspondences every hypothesis draws a 4-slot sample of the pool with a
windowed counter sampler, solves the projective-frame homography and scores
every point; its records carry the flat hypothesis id, and the winner's
sample is replayed from it (``sample_indices_for``).

The sampler (``range_reduce``, ``fy_draws``, ``window_bases``,
``shuffle_order``, ``sample_slots``) is the JAX one bit for bit and is shared
with the P3P (``ops.sweep_pnp_large``) and 8-point
(``ops.sweep_essential_large``) large-pool sweeps:

- a draw is ``floor(u24 * (n * 2^-24))`` with u24 the top 24 bits of the
  murmur3 hash of ``flat ^ seed_j``, rounded once in float32 and clamped
  to n - 1 (not ``hash % n``), shifted past the earlier picks;
- the pool is the valid rows first, shuffled by a stable sort of counter
  keys, then the masked rows;
- block ``flat // block_h`` samples inside a circular window of 64 pool
  slots whose base is hashed from the block index (0 when n_valid <= 64).

Seeds (``ops.sweep.draw_seeds(seed, 6)``): 4 draws, [4] windows, [5] shuffle.

The wrapper's normalization (masked centroid and mean distance of src and
of dst, threshold scaled by dst's scale, MSAC scaled back) sums with a
fixed pairwise tree (``tree_sum``) on both sides.  On the card
``csrc/sweep_large.cu`` normalizes, sorts and permutes in one one-block
kernel, then sweeps; both launch from one C call.  For a CPU tensor the
wrapper computes the plain version; for a CUDA tensor it launches the
kernel or raises.  The plain version rounds every operation on its own;
the kernel's table, pool order, samples and validity are the plain
version's bit for bit, and its score rounds each product-sum once (FMA)
and takes MUFU's reciprocal of w^2 where the TPU kernel took an
approximate one, so the two agree in their decisions: the criteria of
``ops.sweep.hold_full`` / ``hold_reduced`` with this module's
``cut_margins``, on the full records that ``_sweep_kernel(...,
full=True)`` and ``_sweep_plain(..., full=True)`` write (the JAX kernel
has no such mode).
"""

from __future__ import annotations

import math

import torch

from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops.sweep import (INVALID, SUB,
                                        det_cut_margin, draw_seeds, fmix,
                                        frame_dets, points_at_cut,
                                        record_flat_ids, reduce_records,
                                        rescale, solve_frames, sqrt_rn)

BLOCK_H = 2048
LAN = BLOCK_H // SUB
MAX_POINTS = 1024
N_ACC = 4
WINDOW = 64
MIN_WINDOWED_BLOCKS = 4
UNROLL = 16          # the table is padded to a multiple of this many rows
N_SEEDS = 6
PREP_FLOATS = 5 * MAX_POINTS + 2   # csrc/sweep_large.cu's prep buffer
_INV24 = 2.0 ** -24
# Records per chunk of the plain version (bounds its memory, not its result).
PLAIN_CHUNK = 1 << 15


# ------------------------------------------------------------ the sampler
def range_reduce(bits: torch.Tensor, n_range: torch.Tensor) -> torch.Tensor:
    """floor(top 24 bits / 2^24 * n_range) with one float32 rounding,
    clamped to n_range - 1 (sweep_large.py:128-142).  int64 tensors."""
    u24 = ((bits >> 8) & 0xFFFFFF).to(torch.float32)
    scale = n_range.to(torch.float32) * _INV24
    return torch.minimum((u24 * scale).to(torch.int64), n_range - 1)


def fy_draws(flat: torch.Tensor, seeds, n_valid: torch.Tensor, k: int):
    """k-subset Fisher-Yates of [0, n_valid) (sweep_large.py:145-165):
    draw j range-reduced over n_valid - j, shifted past the earlier picks
    in ascending order.  flat: int64 tensor; returns k int64 tensors."""
    idx: list[torch.Tensor] = []
    for j in range(k):
        r = range_reduce(fmix(flat ^ seeds[j]), n_valid - j)
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


def _as_long(n_valid, device) -> torch.Tensor:
    return torch.as_tensor(n_valid, device=device).to(torch.int64)


def window_bases(window_seed: int, blocks: torch.Tensor, n_valid) -> torch.Tensor:
    """Window base slot of each block index (sweep_large.py:88-92)."""
    n_valid = _as_long(n_valid, blocks.device)
    base_range = torch.where(n_valid > WINDOW, n_valid, torch.ones_like(n_valid))
    return range_reduce(fmix(blocks ^ window_seed), base_range)


def shuffle_order(shuffle_seed: int, point_mask: torch.Tensor) -> torch.Tensor:
    """Pool slot -> input row: the valid rows first in the order of their
    counter keys (a stable sort), then the masked rows
    (sweep_large.py:95-101).  Keys are int64, so the masked rows' keys
    0x80000000 + i do not overflow."""
    iota = torch.arange(point_mask.shape[0], device=point_mask.device)
    keys = fmix(iota ^ shuffle_seed) & 0x7FFFFFFF
    key = torch.where(point_mask > 0, keys, 0x80000000 + iota)
    return torch.argsort(key, stable=True)


def sample_slots(flat: torch.Tensor, draw_seeds_, window_seed: int, n_valid,
                 block_h: int, k: int) -> torch.Tensor:
    """[..., k] pool slots of the flat hypothesis ids: k draws inside the
    circular window of block ``flat // block_h``.  ``block_h`` must be the
    sweep's, so the window bases replay.  With fewer than k valid points
    the draws are meaningless; slots are clamped to >= 0 there (the
    kernels' table reads stay in bounds) and the sweeps mark every
    hypothesis invalid."""
    flat = torch.as_tensor(flat).to(torch.int64)
    n_valid = _as_long(n_valid, flat.device)
    wbase = window_bases(window_seed, flat // block_h, n_valid)
    w_eff = torch.minimum(n_valid, torch.full_like(n_valid, WINDOW))
    out = []
    for d in fy_draws(flat, draw_seeds_, w_eff, k):
        s = wbase + d
        out.append(torch.clamp(torch.where(s >= n_valid, s - n_valid, s), min=0))
    return torch.stack(out, -1)


def sample_indices_for(flat, seeds, n_valid):
    """[..., 4] pool slots of the row 6 sweep's flat ids (the replay of
    ``sweep_large.sample_indices_for``)."""
    return sample_slots(flat, seeds[:4], seeds[4], n_valid, BLOCK_H, 4)


# ------------------------------------------------------------ pool prep
def tree_width(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 by the fixed pairwise tree of the kernels' prep
    (``large::tree_sums``): zero-padded to a power of two, then
    x[:h] + x[h:2h] for h = p/2, ..., 1."""
    p = tree_width(x.shape[0])
    if p > x.shape[0]:
        x = torch.cat([x, x.new_zeros((p - x.shape[0],) + x.shape[1:])])
    while p > 1:
        p //= 2
        x = x[:p] + x[p:2 * p]
    return x[0]


def masked_centroid_scale(a: torch.Tensor, maskf: torch.Tensor, cnt):
    """(mx, my, sum of masked distances to the centroid) of a [n, 2] with
    weights maskf and divisor cnt, as the kernels' prep computes them."""
    mx = tree_sum(a[:, 0] * maskf) / cnt
    my = tree_sum(a[:, 1] * maskf) / cnt
    qx, qy = a[:, 0] - mx, a[:, 1] - my
    return mx, my, tree_sum(sqrt_rn(qx * qx + qy * qy) * maskf)


def sqrt2_over(den: torch.Tensor) -> torch.Tensor:
    """sqrt(2) / max(den, 1e-12) as an IEEE division on any device."""
    den = torch.clamp(den, min=1e-12)
    return torch.full_like(den, math.sqrt(2.0)) / den


def pool_table(cols, maskf, order):
    """[n_rows, C + 1] table: the columns and the weights in pool order,
    padded with zero rows to a multiple of UNROLL."""
    n = maskf.shape[0]
    t = torch.stack([*cols, maskf], 1)[order]
    n_rows = -(-n // UNROLL) * UNROLL
    return torch.cat([t, t.new_zeros((n_rows - n, t.shape[1]))])


def _prepare(src, dst, point_mask, threshold, seeds):
    """The plain version of the prep kernel: (table [n_rows, 5], thr_sq,
    inv_s2, n_valid, order)."""
    src = src.to(torch.float32)
    dst = dst.to(torch.float32)
    maskf = point_mask.to(torch.float32)
    n_valid = (maskf > 0).sum()
    order = shuffle_order(seeds[5], maskf)
    cnt = torch.clamp(tree_sum(maskf), min=1.0)
    sm_x, sm_y, ds = masked_centroid_scale(src, maskf, cnt)
    s_src = sqrt2_over(ds / cnt)
    dm_x, dm_y, dd = masked_centroid_scale(dst, maskf, cnt)
    s_dst = sqrt2_over(dd / cnt)
    table = pool_table([(src[:, 0] - sm_x) * s_src, (src[:, 1] - sm_y) * s_src,
                        (dst[:, 0] - dm_x) * s_dst, (dst[:, 1] - dm_y) * s_dst],
                       maskf, order)
    t = torch.tensor(float(threshold), dtype=torch.float32,
                     device=src.device) * s_dst
    return table, t * t, 1.0 / (s_dst * s_dst), n_valid, order


# ------------------------------------------------------------ the sweep
def _score_plain(table, thr_sq, seeds, n_valid, n_hyp, full=False):
    """The kernel's per-hypothesis arithmetic on [SUB, R] tensors of
    hypotheses, chunked over records, in normalized units, B = n_hyp / 8:
    reduced records (f [4, B], i [2, B]), or with ``full`` every
    hypothesis' (f [2, n_hyp] = msac, count; i [n_hyp] flat ids) in s * B +
    r order."""
    B = n_hyp // SUB
    n_rows = table.shape[0]
    cols = table.unbind(1)
    fs, ps = [], []
    for r0 in range(0, B, PLAIN_CHUNK):
        flat = record_flat_ids(r0, min(B, r0 + PLAIN_CHUNK), LAN, table.device)
        slot = sample_slots(flat, seeds[:4], seeds[4], n_valid, BLOCK_H, 4)
        g = table[slot]  # [SUB, R, 4, 5]
        H, valid = solve_frames(*([g[..., j, c] for j in range(4)]
                                  for c in range(4)))
        valid = valid & (n_valid >= 4)
        cnt = [torch.zeros_like(H[0]) for _ in range(N_ACC)]
        ms = [torch.zeros_like(H[0]) for _ in range(N_ACC)]
        for n in range(n_rows):
            x, y, px, py, wp = (c[n] for c in cols)
            u = H[0] * x + H[1] * y + H[2]
            v = H[3] * x + H[4] * y + H[5]
            w = H[6] * x + H[7] * y + H[8]
            a = u - px * w
            b = v - py * w
            r2 = a * a + b * b
            w2 = torch.clamp(w * w, min=1e-30)
            t = thr_sq * w2
            iw2 = 1.0 / w2
            k = n % N_ACC
            cnt[k] = cnt[k] + torch.where(r2 <= t, wp, 0.0)
            ms[k] = ms[k] + torch.minimum(r2, t) * iw2 * wp
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


def _sweep_plain(src, dst, point_mask, threshold, seeds, n_hyp, full=False):
    """The plain version of one kernel call: (f, i, n_valid, order) with
    MSAC rescaled; f [4, B], i [2, B], or with ``full`` f [2, n_hyp], i
    [n_hyp] (``_score_plain``)."""
    table, thr_sq, inv_s2, n_valid, order = _prepare(
        src, dst, point_mask, threshold, seeds)
    f, i = _score_plain(table, thr_sq, seeds, n_valid, n_hyp, full)
    if full:
        return torch.stack([rescale(f[0], inv_s2), f[1]]), i, n_valid, order
    f = torch.stack([rescale(f[0], inv_s2), f[1], rescale(f[2], inv_s2), f[3]])
    return f, i, n_valid, order


def cut_margins(src, dst, point_mask, threshold, seeds, n_hyp, hyp):
    """``ops.sweep.cut_margins`` of the large-pool sweep: for hypotheses
    ``hyp`` (indices into the full records, s * B + r order) of a
    ``_sweep_plain`` call with these arguments, in its arithmetic over the
    pool table, (the weight of the points of weight > 0 that are inliers
    within COUNT_CUT of the inlier cut; the weight of such outliers; min
    over the 8 frame determinants of ||det| - 1e-7|), each [len(hyp)]."""
    table, thr_sq, _, n_valid, _ = _prepare(src, dst, point_mask, threshold,
                                            seeds)
    hyp = torch.as_tensor(hyp, dtype=torch.int64, device=table.device)
    B = n_hyp // SUB
    s, r = hyp // B, hyp % B
    flat = (r // LAN) * BLOCK_H + s * LAN + r % LAN
    g = table[sample_slots(flat, seeds[:4], seeds[4], n_valid, BLOCK_H, 4)]
    sx, sy, dx, dy = ([g[:, j, c] for j in range(4)] for c in range(4))
    H, _ = solve_frames(sx, sy, dx, dy)
    det_margin = det_cut_margin(frame_dets(sx, sy) + frame_dets(dx, dy))
    return (*points_at_cut(H, *table.unbind(1), thr_sq), det_margin)


def _sweep_kernel(src, dst, point_mask, threshold, seeds, n_hyp, full=False):
    """Launch ``csrc/sweep_large.cu`` (its prep kernel, then the sweep) on
    PyTorch's current stream (``full``: every hypothesis' record, as
    ``_sweep_plain``)."""
    dev = src.device
    src = src.to(torch.float32).contiguous()
    dst = dst.to(torch.float32).contiguous()
    mask = point_mask.to(torch.float32).contiguous()
    _build.check_inputs("sweep_large", dev, src=(src, torch.float32),
                        dst=(dst, torch.float32), mask=(mask, torch.float32))
    n = src.shape[0]
    if n_hyp <= 0 or n_hyp % BLOCK_H or not 1 <= n <= MAX_POINTS:
        raise ValueError(f"n_hyp must be a positive multiple of {BLOCK_H} and "
                         f"1 <= n <= {MAX_POINTS}; got n_hyp={n_hyp}, n={n}")
    B = n_hyp // SUB
    prep = torch.empty((PREP_FLOATS,), dtype=torch.float32, device=dev)
    aux = torch.empty((n + 1,), dtype=torch.int32, device=dev)
    f = torch.empty((2, n_hyp) if full else (4, B), dtype=torch.float32, device=dev)
    i = torch.empty((n_hyp,) if full else (2, B), dtype=torch.int32, device=dev)
    _build.launch("homography_ransac_sweep_large", dev, src, dst, mask, float(threshold),
                  *seeds, n, n_hyp, int(full), prep, aux, f, i)
    return f, i, aux[n].long(), aux[:n].long()


def n_hyp_for(n_hyp: int, n: int, block_h: int) -> int:
    """Hypotheses a large-pool sweep runs: whole blocks, and at least
    MIN_WINDOWED_BLOCKS of them when the pool exceeds one window."""
    min_blocks = MIN_WINDOWED_BLOCKS if n > WINDOW else 1
    return max(int(n_hyp) // block_h, min_blocks) * block_h


def _sweep(seed, src, dst, point_mask, threshold, n_hyp, core):
    n = src.shape[0]
    if n > MAX_POINTS:
        raise ValueError(f"at most {MAX_POINTS} points, got {n}")
    seeds = draw_seeds(seed, N_SEEDS)
    f, i, n_valid, order = core(src, dst, point_mask, threshold, seeds,
                                n_hyp_for(n_hyp, n, BLOCK_H))
    return f[0::2], f[1::2], i, (seeds, n_valid, order)


def homography_ransac_sweep_large(seed, src: torch.Tensor, dst: torch.Tensor,
                                  point_mask: torch.Tensor, threshold,
                                  n_hyp: int):
    """Run the large-pool sweep over ``n_hyp`` hypotheses (whole blocks of
    2048, at least 4 blocks when n > 64).

    Returns ``(msac [2, B], counts [2, B], flat_id [2, B], aux)``, B =
    n_hyp / 8; row 0 selects by min MSAC, row 1 by (max count, min MSAC).
    ``aux = (seeds, n_valid, order)``: ``sample_indices_for(flat, seeds,
    n_valid)`` replays a hypothesis' pool slots, ``order`` maps slots to
    input rows.  Samples draw only from points with ``point_mask > 0``;
    scoring weighs every point by it.  src/dst [N <= 1024, 2] in pixels.

    CUDA tensors go through the hand-written kernel (or raise); CPU tensors
    through the plain version."""
    core = _sweep_plain if src.device.type == "cpu" else _sweep_kernel
    return _sweep(seed, src, dst, point_mask, threshold, n_hyp, core)


def homography_ransac_sweep_large_ref(seed, src, dst, point_mask, threshold,
                                      n_hyp):
    """The plain PyTorch version on any device (what the CPU path runs; the
    card's reference for the kernel)."""
    return _sweep(seed, src, dst, point_mask, threshold, n_hyp, _sweep_plain)
