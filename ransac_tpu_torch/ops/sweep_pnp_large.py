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
raises.  Every reciprocal is an exact division; ``rsqrt`` is
``torch.rsqrt``, the card's ``rsqrtf``, so kernel and plain version agree
bit for bit on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops import sweep_pnp
from ransac_tpu_torch.ops.score import _thr_sq
from ransac_tpu_torch.ops.sweep import (SUB, check_inputs, draw_seeds,
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

#: Kernel launches in this process.  Only the CUDA path adds to it, one per
#: launch; the plain version never does.
LAUNCHES = 0


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


def _score_plain(table, thr_sq, ay, seeds, n_valid, n_hyp, block_h):
    """The kernel's arithmetic on [SUB, R] tensors of samples, chunked over
    records: reduced records (f [4, B], i [2, B])."""
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
        a_msac, a_count, a_root, b_msac, b_count, b_root = sweep_pnp._best_roots(
            msacs, counts)
        fa, pa = reduce_records(a_msac, a_count, flat * 4 + a_root, BIG)
        fb, pb = reduce_records(b_msac, b_count, flat * 4 + b_root, BIG)
        fs.append(torch.stack([fa[0], fa[1], fb[2], fb[3]]))
        ps.append(torch.stack([pa[0], pb[1]]))
    return torch.cat(fs, -1), torch.cat(ps, -1)


def _sweep_plain(Xw, pix_n, point_mask, thr_sq, ay, seeds, n_hyp, block_h):
    table, n_valid, order = _prepare(Xw, pix_n, point_mask, ay, seeds)
    f, i = _score_plain(table, thr_sq, ay, seeds, n_valid, n_hyp, block_h)
    return f, i, n_valid, order


def _sweep_kernel(Xw, pix_n, point_mask, thr_sq, ay, seeds, n_hyp, block_h):
    """Launch ``csrc/sweep_pnp_large.cu`` on PyTorch's current stream."""
    global LAUNCHES
    dev = Xw.device
    X = Xw.to(torch.float32).contiguous()
    pix = pix_n.to(torch.float32).contiguous()
    mask = point_mask.to(torch.float32).contiguous()
    check_inputs("sweep_pnp_large", dev, X=(X, torch.float32),
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
    f = torch.empty((4, B), dtype=torch.float32, device=dev)
    i = torch.empty((2, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.load().sweep_pnp_large_launch(
            X.data_ptr(), pix.data_ptr(), mask.data_ptr(), thr_sq, ay, *seeds,
            n, n_hyp, block_h, prep.data_ptr(), aux.data_ptr(), f.data_ptr(),
            i.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sweep_pnp_large_launch failed: CUDA error {err}")
    LAUNCHES += 1
    return f, i, aux[n].long(), aux[:n].long()


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
