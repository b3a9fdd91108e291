"""Fused 8-point essential-matrix sweep for pools of up to 16 points: the
CUDA kernel's wrapper and its plain PyTorch version.

Port of ``ransac_tpu.ops.pallas.sweep_essential.essential_ransac_sweep``,
which ``cli profile`` times as ``fused_essential_sweep``.  Every hypothesis
draws its 8-point sample with the counter PRNG of the homography and P3P
sweeps (``ops.sweep.draw_sample``: 8 draws, seeds ``fmix(seed + j *
0x9E3779B9)`` for j = 1..8, an unsigned modulus, draws from the first
``n_points`` rows), solves F by the division- and pivot-free
canonical-frame method of the large-pool sweep
(``ops.sweep_essential_large.canonical_f``; the JAX solves of the two
kernels are the same code) and scores every point with the
division-deferred Sampson test, N_ACC = 4 accumulator pairs.  Both images
share one normalization (per-image centroid, one scale from the mean
distance over both), so the Sampson test keeps its meaning and the
threshold scales by s^2.

The packed sample holds index j in bits 4j..4j+3, so a sample whose last
index is 8 or more is a negative int32.  The record reduction breaks ties on
the UNSIGNED order of the packed samples, as the TPU kernel does: the plain
version builds the packed samples in int64 (values below 2^32), reduces
with the sentinel 2^32 - 1 and wraps the result to int32 (``to_int32``).
The records keep the TPU kernel's layout (``ops.sweep``'s, with LAN =
block_h / 8); the sampling is the JAX kernel's bit for bit.

For a CPU tensor the wrapper computes the plain version; for a CUDA tensor
it launches ``csrc/sweep_essential.cu`` (a one-warp prep kernel that
normalizes, then the sweep, from one C call) or raises.  The plain version
rounds every operation on its own (``rsqrt`` is ``torch.rsqrt``, the
card's ``rsqrtf``).  The kernel's canonical solve does too, so its F is
this version's bit for bit; its Sampson score rounds each product-sum once
(FMA) and takes MUFU's approximate reciprocal where the TPU kernel took
``pl.reciprocal(approx=True)``, so the two agree in their decisions
(``hold_full``, ``hold_reduced``), not bit for bit.  The kernel's header
under its exact policy is this version's arithmetic bit for bit (the
host-build tests).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops.sweep import (INVALID, SUB, centroid_dist,
                                        draw_sample, draw_seeds, record_flat_ids,
                                        reduce_records, rescale, sample_bitmask,
                                        to_int32)
from ransac_tpu_torch.ops.sweep_essential_large import canonical_f, sampson

BLOCK_H = 2048
MAX_POINTS = 16      # 4-bit fields of the packed sample
N_ACC = 4            # accumulator pairs of the score loop
PREP_FLOATS = 5 * MAX_POINTS + 3   # csrc/sweep_essential.cu's prep buffer
UNSIGNED_SENTINEL = 2 ** 32 - 1    # the TPU's sentinel 2^31 - 1 with the sign bit flipped
# Records per chunk of the plain version (bounds its memory, not its result).
PLAIN_CHUNK = 1 << 16


def _normalize(x1, x2, point_mask, threshold_sq, n_points):
    """(x1_p [16,2], x2_p [16,2], mask_p [16], thr_sq [1], inv_s2): the
    plain version of the prep kernel (``sweep_essential::norm_params``)."""
    n = x1.shape[0]
    x1 = x1.to(torch.float32)
    x2 = x2.to(torch.float32)
    m1, d1 = centroid_dist(x1, n_points)
    m2, d2 = centroid_dist(x2, n_points)
    den = torch.clamp((d1 + d2) / d1.new_tensor(2.0 * n_points), min=1e-12)
    s = torch.full_like(den, math.sqrt(2.0)) / den
    x1_p = x1.new_zeros((MAX_POINTS, 2))
    x1_p[:n] = (x1 - m1) * s
    x2_p = x1.new_zeros((MAX_POINTS, 2))
    x2_p[:n] = (x2 - m2) * s
    mask_p = x1.new_zeros((MAX_POINTS,))
    mask_p[:n] = point_mask.to(torch.float32)
    thr = torch.as_tensor(threshold_sq, dtype=torch.float32,
                          device=x1.device).reshape(1) * s * s
    return x1_p, x2_p, mask_p, thr, torch.ones_like(s) / (s * s)


def _score_plain(x1_p, x2_p, mask_p, thr, seeds, n_points, n_score, n_hyp,
                 block_h, full):
    """The kernel's per-hypothesis arithmetic on [SUB, R] tensors of
    hypotheses, in the kernel's order of operations, chunked over records.
    Returns the records in normalized units: full (f [2, n_hyp], i [n_hyp])
    in s * B + r order, or reduced (f [4, B], i [2, B])."""
    B = n_hyp // SUB
    lan = block_h // SUB
    vmask = sample_bitmask(mask_p)
    thr_sq = thr[0]
    fs, ps = [], []
    for r0 in range(0, B, PLAIN_CHUNK):
        flat = record_flat_ids(r0, min(B, r0 + PLAIN_CHUNK), lan, x1_p.device)
        idx = draw_sample(flat, seeds, n_points)
        ok_bits = vmask >> idx[0]
        for i in idx[1:]:
            ok_bits = ok_bits & (vmask >> i)
        F, ok_f = canonical_f([x1_p[i, 0] for i in idx], [x1_p[i, 1] for i in idx],
                              [x2_p[i, 0] for i in idx], [x2_p[i, 1] for i in idx])
        valid = ((ok_bits & 1) == 1) & ok_f
        cnt = [torch.zeros_like(F[0]) for _ in range(N_ACC)]
        ms = [torch.zeros_like(F[0]) for _ in range(N_ACC)]
        for n in range(n_score):
            k = n % N_ACC
            cnt[k], ms[k] = sampson(F, x1_p[n, 0], x1_p[n, 1], x2_p[n, 0],
                                    x2_p[n, 1], mask_p[n], thr_sq, cnt[k], ms[k])
        count, msac = cnt[0], ms[0]
        for k in range(1, N_ACC):
            count = count + cnt[k]
            msac = msac + ms[k]
        msac = torch.where(valid, msac, INVALID)
        count = torch.where(valid, count, -1.0)
        packed = idx[0]
        for j in range(1, 8):
            packed = packed | (idx[j] << (4 * j))  # int64, below 2^32
        if full:
            fs.append(torch.stack([msac, count]))
            ps.append(to_int32(packed))
        else:
            f, p = reduce_records(msac, count, packed, sentinel=UNSIGNED_SENTINEL)
            fs.append(f)
            ps.append(p)
    if full:  # [2, SUB, B] -> s * B + r order
        return torch.cat(fs, -1).reshape(2, -1), torch.cat(ps, -1).reshape(-1)
    return torch.cat(fs, -1), torch.cat(ps, -1)


def _sweep_plain(x1, x2, point_mask, threshold_sq, seeds, n_points, n_hyp,
                 block_h, full):
    """The plain version of one kernel launch: normalize, score, rescale.
    Returns (f, i) as the kernel writes them: full f [2, n_hyp] (msac,
    counts), i [n_hyp]; reduced f [4, B], i [2, B]."""
    x1_p, x2_p, mask_p, thr, inv_s2 = _normalize(x1, x2, point_mask,
                                                 threshold_sq, n_points)
    f, i = _score_plain(x1_p, x2_p, mask_p, thr, seeds, n_points, x1.shape[0],
                        n_hyp, block_h, full)
    if full:
        return torch.stack([rescale(f[0], inv_s2), f[1]]), i
    return torch.stack([rescale(f[0], inv_s2), f[1], rescale(f[2], inv_s2),
                        f[3]]), i


# The decision-level hold of the kernel (FMAs and MUFU's reciprocal in the
# Sampson score; F bit for bit) to the plain version, by the criteria the
# port holds the plain version to the jitted JAX function with, whose XLA
# backend contracts FMAs as well: counts equal on COUNTS_MOST of the
# hypotheses, the minimum MSAC within MIN_MSAC_RTOL.
COUNTS_MOST, MIN_MSAC_RTOL = 0.95, 0.1


def hold_full(out_k, out_p) -> dict:
    """Full records (msac, counts, packed) [n_hyp] of the kernel against the
    plain version's: samples and validity equal; counts equal on
    COUNTS_MOST; the best count, and the count of the plain version's
    min-MSAC hypothesis, equal; the min MSAC within MIN_MSAC_RTOL.  Returns
    the readings and ``failures`` (empty when every criterion held)."""
    m_k, c_k, p_k = out_k
    m_p, c_p, p_p = out_p
    fails = []
    if not torch.equal(p_k, p_p):
        fails.append("samples differ")
    flips = int(((m_k >= 3e38) != (m_p >= 3e38)).sum())
    if flips:
        fails.append(f"validity differs on {flips}")
    eq = float((c_k == c_p).double().mean())
    if eq < COUNTS_MOST:
        fails.append(f"counts equal on {eq}")
    if float(c_k.max()) != float(c_p.max()):
        fails.append("best count differs")
    b = int(m_p.argmin())
    if float(c_k[b]) != float(c_p[b]):
        fails.append("count of the plain min-MSAC hypothesis differs")
    min_rel = abs(float(m_k.min()) / float(m_p.min()) - 1.0)
    if min_rel > MIN_MSAC_RTOL:
        fails.append(f"min MSAC rel {min_rel}")
    both = (m_k < 3e38) & (m_p < 3e38)
    rel = (m_k[both].double() / m_p[both].double() - 1.0).abs()
    return {"validity_flips": flips, "counts_equal_fraction": eq,
            "plain_winner_count": [float(c_k[b]), float(c_p[b])],
            "msac_within_1e-4_fraction": float((rel <= 1e-4).double().mean()) if len(rel) else 1.0,
            "max_rel_err": float(rel.max()) if len(rel) else 0.0,
            "min_msac_rel_err": min_rel, "failures": fails}


def hold_reduced(red_k, red_p) -> dict:
    """Reduced records (msac, counts, packed) [2, B]: the same best count
    under the count rule, and on records whose eight hypotheses are all
    invalid on both sides (ties broken by the unsigned packed order alone)
    the same samples under both rules; elsewhere a record may keep another
    sample of a near-tie (counted in ``near_ties_used``)."""
    m_k, c_k, p_k = red_k
    m_p, c_p, p_p = red_p
    fails = []
    if float(c_k[1].max()) != float(c_p[1].max()):
        fails.append("best count differs")
    tie = (m_k[0] >= 3e38) & (m_p[0] >= 3e38)
    if not torch.equal(p_k[:, tie], p_p[:, tie]):
        fails.append("all-invalid records keep other samples")
    return {"count_row_equal_fraction": float((c_k[1] == c_p[1]).double().mean()),
            "near_ties_used": int((p_k != p_p).sum()), "all_invalid_records": int(tie.sum()),
            "failures": fails}


def _sweep_kernel(x1, x2, point_mask, threshold_sq, seeds, n_points, n_hyp,
                  block_h, full):
    """Launch ``csrc/sweep_essential.cu`` (its prep kernel, then the
    sweep) on PyTorch's current stream."""
    dev = x1.device
    x1 = x1.to(torch.float32).contiguous()
    x2 = x2.to(torch.float32).contiguous()
    mask = point_mask.to(torch.float32).contiguous()
    _build.check_inputs("sweep_essential", dev, x1=(x1, torch.float32),
                        x2=(x2, torch.float32), mask=(mask, torch.float32))
    n_score = x1.shape[0]
    if (not 8 <= n_points <= n_score <= MAX_POINTS or block_h <= 0
            or block_h % SUB or n_hyp <= 0 or n_hyp % block_h):
        raise ValueError(f"need 8 <= n_points <= n <= {MAX_POINTS} and a "
                         f"block_h, multiple of {SUB}, dividing n_hyp; got "
                         f"n_points={n_points}, n={n_score}, n_hyp={n_hyp}, "
                         f"block_h={block_h}")
    B = n_hyp // SUB
    prep = torch.empty((PREP_FLOATS,), dtype=torch.float32, device=dev)
    f = torch.empty((2, n_hyp) if full else (4, B), dtype=torch.float32, device=dev)
    i = torch.empty((n_hyp,) if full else (2, B), dtype=torch.int32, device=dev)
    _build.launch("essential_ransac_sweep", dev, x1, x2, mask, float(threshold_sq),
                  *seeds, n_points, n_score, n_hyp, block_h, int(full), prep, f, i)
    return f, i


def _sweep(seed, x1, x2, point_mask, threshold_sq, n_hyp, n_points,
           full_records, block_h, core):
    n = x1.shape[0]
    if n > MAX_POINTS:
        raise ValueError(f"at most {MAX_POINTS} points, got {n}")
    n_points = n if n_points is None else int(n_points)
    n_hyp = int(n_hyp)
    if block_h is None:
        block_h = min(BLOCK_H, max(SUB, (n_hyp // SUB) * SUB))
    n_hyp = max(n_hyp // block_h, 1) * block_h
    f, i = core(x1, x2, point_mask, threshold_sq, draw_seeds(seed, 8), n_points,
                n_hyp, int(block_h), full_records)
    if full_records:
        return f[0], f[1], i
    return f[0::2], f[1::2], i


def essential_ransac_sweep(seed, x1: torch.Tensor, x2: torch.Tensor,
                           point_mask: torch.Tensor, threshold_sq, n_hyp: int,
                           n_points: int | None = None,
                           full_records: bool = False,
                           block_h: int | None = None):
    """Fused 8-point sweep on normalized camera coordinates, x1/x2 [N<=16,
    2], over ``n_hyp`` hypotheses (whole blocks of ``block_h``, default
    min(2048, n_hyp rounded down to 8), at least one).

    ``threshold_sq`` is the Sampson bound in squared normalized units
    ((px_threshold / focal)^2); ``n_points`` the sample pool (the first
    n_points rows); scoring uses all rows weighted by ``point_mask``, and a
    sample touching a masked point is invalid (msac 3.4e38, count -1).

    Default: block-reduced records ``(msac [2, B], counts [2, B], packed
    [2, B])``, B = n_hyp / 8; row 0 selects by min MSAC, row 1 by (max
    count, min MSAC), ties to the smallest packed sample as an unsigned
    number.  ``full_records=True``: per-hypothesis ``(msac [n_hyp], counts
    [n_hyp], packed [n_hyp])`` in the TPU kernel's order (index s * B + r).
    ``unpack_sample8`` decodes a packed sample.

    CUDA tensors go through the hand-written kernel (or raise); CPU tensors
    through the plain version."""
    core = _sweep_plain if x1.device.type == "cpu" else _sweep_kernel
    return _sweep(seed, x1, x2, point_mask, threshold_sq, n_hyp, n_points,
                  full_records, block_h, core)


def essential_ransac_sweep_ref(seed, x1, x2, point_mask, threshold_sq, n_hyp,
                               n_points=None, full_records=False, block_h=None):
    """The plain PyTorch version on any device (what the CPU path runs; the
    card's reference for the kernel)."""
    return _sweep(seed, x1, x2, point_mask, threshold_sq, n_hyp, n_points,
                  full_records, block_h, _sweep_plain)


def unpack_sample8(packed: int) -> np.ndarray:
    """The 8 point indices of a packed sample (negative values included)."""
    p = int(packed) & 0xFFFFFFFF
    return np.array([(p >> (4 * j)) & 15 for j in range(8)], dtype=np.int32)
