"""Large-pool P3P-RANSAC sweep: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``ransac_tpu.ops.pallas.sweep_pnp_large.pnp_ransac_sweep_large``,
for pools of up to 512 correspondences (SfM map registration).  Every
sample draws 3 pool slots with the windowed counter sampler of
``ops.sweep_large``, then solves and scores exactly as the 16-point sweep
(``ops.sweep_pnp.solve_and_score``: Grunert's P3P, depth polish, triad
pose, the division-deferred score of each of the four roots in
fx-normalized, pixel-true units).  Records keep the TPU kernel's layout
(record ``r = b * LAN + l`` covers the flat ids ``b * block_h + s * LAN +
l``) and carry ``flat * 4 + root``; ``sample_indices3_for`` replays a flat
id's sample.

Seeds (``ops.sweep.draw_seeds(seed, 5)``): 3 draws, [3] windows,
[4] shuffle.

For a CPU tensor the wrapper computes the plain version; for a CUDA
tensor it launches ``csrc/sweep_pnp_large.cu`` (a one-block prep kernel
that builds the shuffled table, then the sweep, from one C call) or
raises.  Every reciprocal of the plain version is an exact division;
``rsqrt`` is ``torch.rsqrt``, the card's ``rsqrtf``.  The kernel's table,
pool order, samples, poses and validity are the plain version's bit for
bit on the card; it scores only the valid pairs, with the `Fused` score
of ``ops.sweep_pnp``, and is held by the same criteria
(``sweep_pnp.hold_full`` / ``hold_reduced``, this module's ``cut_margins``
and ``full_keys``; ``_sweep_kernel(..., full=True)`` writes the full
records the JAX kernel has no mode for).  ``valid_root_share`` reads the
share of valid pairs of a call from its inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops import sweep_pnp
from ransac_tpu_torch.ops.score import _thr_sq
from ransac_tpu_torch.ops.sweep import (SUB, draw_seeds,
                                        record_flat_ids, reduce_records, sqrt_rn)
from ransac_tpu_torch.ops.sweep_large import (n_hyp_for, pool_table,
                                              sample_slots, shuffle_order)

BLOCK_H = 4096
MAX_POINTS = 512
N_ROOTS = 4
N_SEEDS = 5
PREP_FLOATS = 9 * MAX_POINTS   # csrc/sweep_pnp_large.cu's prep buffer
BIG = sweep_pnp.BIG
# Records per chunk of the plain version (bounds its memory, not its result).
PLAIN_CHUNK = 1 << 13


def sample_indices3_for(flat, seeds, n_valid, block_h: int = BLOCK_H):
    """[..., 3] pool slots of flat sample ids (the replay of
    ``sweep_pnp_large.sample_indices3_for``); ``block_h`` is the sweep's."""
    return sample_slots(flat, seeds[:3], seeds[3], n_valid, block_h, 3)


def _prepare(Xw, pix_n, point_mask, ay, seeds):
    """The plain version of the prep kernel: (table [n_rows, 9] = X Y Z,
    unit bearing, x, ay * y, weight in pool order; n_valid; order)."""
    maskf = point_mask.to(torch.float32)
    Xw = Xw.to(torch.float32)
    px, py = pix_n[:, 0].to(torch.float32), pix_n[:, 1].to(torch.float32)
    nrm = sqrt_rn(px * px + py * py + 1.0)
    ay = torch.tensor(float(np.float32(ay)), dtype=torch.float32, device=Xw.device)
    order = shuffle_order(seeds[4], maskf)
    table = pool_table([Xw[:, 0], Xw[:, 1], Xw[:, 2], px / nrm, py / nrm,
                        torch.ones_like(nrm) / nrm, px, py * ay], maskf, order)
    return table, (maskf > 0).sum(), order


def _score_plain(table, thr_sq, ay, seeds, n_valid, n_hyp, block_h, full=False):
    """The kernel's arithmetic on [SUB, R] tensors of samples, chunked over
    records: reduced records (f [4, B], i [2, B]), or with ``full`` every
    (sample, root)'s (f [8, n_hyp] = 4 roots' msac, then counts; i [n_hyp]
    flat ids) in s * B + r order, as ``ops.sweep_pnp``'s full records."""
    B = n_hyp // SUB
    lan = block_h // SUB
    dev = table.device
    thr_sq = torch.tensor(thr_sq, dtype=torch.float32, device=dev)
    ay = torch.tensor(ay, dtype=torch.float32, device=dev)
    X_p, f_p, pix_p, mask_p = table[:, 0:3], table[:, 3:6], table[:, 6:8], table[:, 8]
    fs, ps = [], []
    for r0 in range(0, B, PLAIN_CHUNK):
        flat = record_flat_ids(r0, min(B, r0 + PLAIN_CHUNK), lan, dev)
        slot = sample_slots(flat, seeds[:3], seeds[3], n_valid, block_h, 3)
        P = [[X_p[slot[..., j], c] for c in range(3)] for j in range(3)]
        F = [[f_p[slot[..., j], c] for c in range(3)] for j in range(3)]
        msacs, counts = sweep_pnp.solve_and_score(
            P, F, n_valid >= 3, table.shape[0], thr_sq, ay, X_p, pix_p, mask_p)
        if full:
            fs.append(torch.stack(msacs + counts))
            ps.append(flat.to(torch.int32))
            continue
        a_msac, a_count, a_root, b_msac, b_count, b_root = sweep_pnp._best_roots(
            msacs, counts)
        fa, pa = reduce_records(a_msac, a_count, flat * 4 + a_root, BIG)
        fb, pb = reduce_records(b_msac, b_count, flat * 4 + b_root, BIG)
        fs.append(torch.stack([fa[0], fa[1], fb[2], fb[3]]))
        ps.append(torch.stack([pa[0], pb[1]]))
    if full:  # [8, SUB, B] -> s * B + r order
        return torch.cat(fs, -1).reshape(8, -1), torch.cat(ps, -1).reshape(-1)
    return torch.cat(fs, -1), torch.cat(ps, -1)


def _sweep_plain(Xw, pix_n, point_mask, thr_sq, ay, seeds, n_hyp, block_h,
                 full=False):
    table, n_valid, order = _prepare(Xw, pix_n, point_mask, ay, seeds)
    f, i = _score_plain(table, thr_sq, ay, seeds, n_valid, n_hyp, block_h, full)
    return f, i, n_valid, order


def _sweep_kernel(Xw, pix_n, point_mask, thr_sq, ay, seeds, n_hyp, block_h,
                  full=False):
    """Launch ``csrc/sweep_pnp_large.cu`` on PyTorch's current stream
    (``full``: every (sample, root)'s record, as ``_score_plain``)."""
    dev = Xw.device
    X = Xw.to(torch.float32).contiguous()
    pix = pix_n.to(torch.float32).contiguous()
    mask = point_mask.to(torch.float32).contiguous()
    _build.check_inputs("sweep_pnp_large", dev, X=(X, torch.float32),
                        pix=(pix, torch.float32), mask=(mask, torch.float32))
    n = X.shape[0]
    if (block_h % 256 or n_hyp % block_h or n_hyp > 1 << 28
            or not 1 <= n <= MAX_POINTS):
        raise ValueError(f"block_h must be a multiple of 256 dividing n_hyp "
                         f"(<= 2^28) and 1 <= n <= {MAX_POINTS}; got "
                         f"n_hyp={n_hyp}, block_h={block_h}, n={n}")
    B = n_hyp // SUB
    prep = torch.empty((PREP_FLOATS,), dtype=torch.float32, device=dev)
    aux = torch.empty((n + 1,), dtype=torch.int32, device=dev)
    f = torch.empty((8, n_hyp) if full else (4, B), dtype=torch.float32, device=dev)
    i = torch.empty((n_hyp,) if full else (2, B), dtype=torch.int32, device=dev)
    _build.launch("pnp_ransac_sweep_large", dev, X, pix, mask, thr_sq, ay, *seeds,
                  n, n_hyp, block_h, int(full), prep, aux, f, i)
    return f, i, aux[n].long(), aux[:n].long()


def cut_margins(Xw, pix_n, point_mask, thr_sq, ay, seeds, n_hyp, block_h, hyp):
    """``sweep_pnp.near_cut`` of (sample, root) pairs ``hyp`` (indices into
    the full records, root * n_hyp + s * B + r) of a ``_sweep_plain`` call
    with these arguments, each [len(hyp)]."""
    table, n_valid, _ = _prepare(Xw, pix_n, point_mask, ay, seeds)
    dev = table.device
    hyp = torch.as_tensor(hyp, dtype=torch.int64, device=dev)
    B, lan = n_hyp // SUB, block_h // SUB
    k, o = hyp // n_hyp, hyp % n_hyp
    s, r = o // B, o % B
    flat = (r // lan) * block_h + s * lan + r % lan
    poses = _poses(table, flat, seeds, n_valid, block_h, ay)[0]
    thr = torch.tensor(thr_sq, dtype=torch.float32, device=dev)
    return sweep_pnp.near_cut(sweep_pnp.root_of(poses, k), table.shape[0], thr,
                              table[:, 0:3], table[:, 6:8], table[:, 8])


def _poses(table, flat, seeds, n_valid, block_h, ay):
    """``sweep_pnp.solve_poses`` of the samples of flat ids ``flat``."""
    slot = sample_slots(flat, seeds[:3], seeds[3], n_valid, block_h, 3)
    P = [[table[slot[..., j], c] for c in range(3)] for j in range(3)]
    F = [[table[slot[..., j], 3 + c] for c in range(3)] for j in range(3)]
    ay = torch.tensor(ay, dtype=torch.float32, device=table.device)
    return sweep_pnp.solve_poses(P, F, n_valid >= 3, ay)


def full_keys(flat, n_hyp):
    """The reduced records' keys (flat * 4 + root) of full records' flat ids
    [n_hyp], root-major [4 n_hyp]."""
    root = torch.arange(N_ROOTS, device=flat.device).repeat_interleave(n_hyp)
    return flat.long().repeat(N_ROOTS) * 4 + root


def valid_root_share(seed, Xw, pix_n, point_mask, n_hyp, block_h=None, ay=1.0,
                     n_samples=1 << 14) -> float:
    """The share of (sample, root) pairs of a sweep call that are valid,
    read from its inputs by the plain ``solve_poses`` on ``n_samples`` of
    its samples, evenly spaced over its flat ids (every window).  Whatever
    computes the sweep scores that share of the pairs, so it scales the
    score term of the call's bound (``utils.profiling.issued_ops``)."""
    block_h = BLOCK_H if block_h is None else int(block_h)
    seeds = draw_seeds(seed, N_SEEDS)
    ay = float(np.float32(float(ay)))
    n_hyp = n_hyp_for(n_hyp, Xw.shape[0], block_h)
    table, n_valid, _ = _prepare(Xw, pix_n, point_mask, ay, seeds)
    step = max(n_hyp // n_samples, 1)
    flat = torch.arange(0, n_hyp, step, device=table.device)
    valid = _poses(table, flat, seeds, n_valid, block_h, ay)[1]
    return float(torch.stack(valid).double().mean())


def _sweep(seed, Xw, pix_n, point_mask, threshold_n, n_hyp, block_h, ay, core):
    n = Xw.shape[0]
    if n > MAX_POINTS:
        raise ValueError(f"at most {MAX_POINTS} points, got {n}")
    block_h = BLOCK_H if block_h is None else int(block_h)
    seeds = draw_seeds(seed, N_SEEDS)
    f, i, n_valid, order = core(Xw, pix_n, point_mask, _thr_sq(threshold_n),
                                float(np.float32(float(ay))), seeds,
                                n_hyp_for(n_hyp, n, block_h), block_h)
    return f[0::2], f[1::2], i, (seeds, n_valid, order)


def pnp_ransac_sweep_large(seed, Xw: torch.Tensor, pix_n: torch.Tensor,
                           point_mask: torch.Tensor, threshold_n, n_hyp: int,
                           block_h: int | None = None, ay=1.0):
    """Large-pool fused P3P sweep on normalized coordinates.

    Returns ``(msac [2, B], counts [2, B], packed [2, B], aux)``, B = n_hyp
    / 8 (whole blocks, at least 4 when n > 64); row 0 by min MSAC, row 1 by
    (max count, min MSAC), each the best of its sample's four roots,
    ``packed = flat * 4 + root``.  ``aux = (seeds, n_valid, order)``:
    ``sample_indices3_for(packed >> 2, seeds, n_valid, block_h)`` replays
    the pool slots, ``order`` maps them to input rows.  ``threshold_n`` is
    in fx-normalized units, ``ay = fy / fx``.  Needs >= 3 valid points and
    N <= 512.  CUDA tensors go through the kernel (or raise); CPU tensors
    through the plain version."""
    core = _sweep_plain if Xw.device.type == "cpu" else _sweep_kernel
    return _sweep(seed, Xw, pix_n, point_mask, threshold_n, n_hyp, block_h,
                  ay, core)


def pnp_ransac_sweep_large_ref(seed, Xw, pix_n, point_mask, threshold_n, n_hyp,
                               block_h=None, ay=1.0):
    """The plain PyTorch version on any device (what the CPU path runs; the
    card's reference for the kernel)."""
    return _sweep(seed, Xw, pix_n, point_mask, threshold_n, n_hyp, block_h,
                  ay, _sweep_plain)
