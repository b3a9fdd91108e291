"""Fixed-shape batched RANSAC engine (port of ``ransac_tpu.models.ransac``).

A static tensor of minimal samples — every C(N,k) sample, enumerated in
``itertools.combinations`` order — is solved by a batched minimal solver
and scored in one pass; multi-solution solvers (P3P's 4 roots) flatten
into the hypothesis axis with a validity mask.  Selection is MSAC or
inlier count, then a weighted least-squares refit plus LM on the winning
inlier set (OpenCV's final refinement).

Where JAX vmapped the engine over candidates, the port writes the batch
out: ``ransac_fit`` and ``ransac_homography`` take a leading batch
dimension [B, N, ...].  Past ``max_exhaustive_samples`` (or with
``exhaustive=False``) the samples are drawn at random through
``utils.prng`` from an explicit generator (``key_or_seed``).

The fused sweeps ``ransac_homography_sweep`` and ``ransac_pnp_sweep`` run
the hypothesize-and-verify loop in one kernel launch (``ops.sweep``,
``ops.sweep_pnp``; pools over 16 points go to the large-pool sweeps
``ops.sweep_large`` and ``ops.sweep_pnp_large``, whose winners are replayed
from their flat ids), then re-solve the winning minimal sample exactly and
refit it on its inliers, with the engine's semantics.  Essential-matrix
RANSAC has the engine (``ransac_essential``) and the fused large-pool path
(``ransac_essential_sweep``, ``ops.sweep_essential_large``).
"""

from __future__ import annotations

import math
from functools import lru_cache
from itertools import combinations
from typing import Any, Callable, NamedTuple

import torch

from ransac_tpu_torch.ops import (epipolar, homography, pnp, projection, sweep,
                                  sweep_essential_large, sweep_large, sweep_pnp,
                                  sweep_pnp_large)
from ransac_tpu_torch.ops.lm import (fused_refit_homography, fused_refit_pose,
                                     refine_homography, refine_pose)
from ransac_tpu_torch.ops.rotation import exp_so3, log_so3
from ransac_tpu_torch.ops.score import pnp_scores
from ransac_tpu_torch.utils.config import RansacConfig
from ransac_tpu_torch.utils.logging import host_sync, timed
from ransac_tpu_torch.utils.prng import generator_for, sample_without_replacement


class RansacResult(NamedTuple):
    model: Any                 # best (refit) model parameters
    raw_model: Any             # best minimal-solver model (pre-refit)
    inlier_mask: torch.Tensor  # [..., N] bool, from the best hypothesis
    num_inliers: torch.Tensor  # [...] int
    score: torch.Tensor        # [...] MSAC score of the best hypothesis
    best_index: torch.Tensor   # [...] index into the hypothesis axis
    counts: torch.Tensor       # [..., H] per-hypothesis inlier counts
    num_hypotheses: int


@lru_cache(maxsize=None)
def _combinations_on(n: int, k: int, device: str) -> torch.Tensor:
    with host_sync("combinations_table"):  # a blocking copy, once per (n, k)
        return torch.tensor(list(combinations(range(n), k)), dtype=torch.int64,
                            device=device)


def combinations_table(n: int, k: int, device) -> torch.Tensor:
    """[C(n,k), k] int64 sample table in ``itertools.combinations`` order
    (the JAX package's order, so argmin tie-breaks match), cached on the
    device per (n, k)."""
    return _combinations_on(n, k, str(torch.device(device)))


def _sample_indices(n_points: int, sample_size: int, cfg: RansacConfig,
                    point_mask: torch.Tensor, key_or_seed) -> torch.Tensor:
    """Exhaustive [S, k] table when small enough, else [B, S, k] random
    samples of each problem's valid points (top-k of uniforms, masked
    points never drawn), as the JAX engine draws them."""
    if cfg.exhaustive and math.comb(n_points, sample_size) <= cfg.max_exhaustive_samples:
        return combinations_table(n_points, sample_size, point_mask.device)
    gen = _as_generator(key_or_seed, cfg, point_mask.device)
    return sample_without_replacement(gen, cfg.num_hypotheses, sample_size,
                                      n_points, point_mask)


def _as_generator(key_or_seed, cfg: RansacConfig, device) -> torch.Generator:
    """A torch.Generator as given, else one seeded from the integer (or
    from ``cfg.seed`` when None) on ``device``."""
    if isinstance(key_or_seed, torch.Generator):
        return key_or_seed
    seed = cfg.seed if key_or_seed is None else int(key_or_seed)
    return generator_for(seed, device=device)


def _as_seed(key_or_seed) -> int:
    """An integer seed as given, or one drawn from a torch.Generator (the
    counterpart of drawing one from a typed jax.random key)."""
    if isinstance(key_or_seed, torch.Generator):
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=key_or_seed,
                                 device=key_or_seed.device))
    return int(key_or_seed)


def ransac_fit(
    solve_fn: Callable,        # (xs [B,S,k,dx], ys) -> (models [B,S,M,...], valid [B,S,M])
    residual_fn: Callable,     # (models [B,H,...], x [B,1,N,dx], y) -> [B,H,N]
    x: torch.Tensor,           # [B, N, dx]
    y: torch.Tensor,           # [B, N, dy]
    point_mask: torch.Tensor,  # [B, N] bool/0-1
    sample_size: int,
    cfg: RansacConfig,
    degenerate_fn: Callable | None = None,
    threshold=None,
    key_or_seed=None,
    residual_is_squared: bool = False,
):
    """Engine core over a batch of problems.  Returns (models_flat
    [B,H,...], valid [B,H], counts [B,H], msac [B,H], best [B],
    inlier_mask_best [B,N]).  ``key_or_seed`` (an int or a
    torch.Generator) drives the random branch only;
    ``residual_is_squared`` marks residuals already in squared units
    (Sampson).  The ``ransac.fit`` span."""
    with timed("ransac.fit"):
        return _fit(solve_fn, residual_fn, x, y, point_mask, sample_size, cfg,
                    degenerate_fn, threshold, key_or_seed, residual_is_squared)


def _fit(solve_fn, residual_fn, x, y, point_mask, sample_size, cfg,
         degenerate_fn, threshold, key_or_seed, residual_is_squared):
    B, n_points = x.shape[:2]
    pm = point_mask.bool()
    idx = _sample_indices(n_points, sample_size, cfg, pm, key_or_seed)
    if idx.dim() == 2:  # one exhaustive table [S,k] for every problem
        xs, ys, sample_ok = x[:, idx], y[:, idx], pm[:, idx].all(-1)
    else:               # per-problem random samples [B,S,k]
        rows = torch.arange(B, device=x.device)[:, None, None]
        xs, ys, sample_ok = x[rows, idx], y[rows, idx], pm[rows, idx].all(-1)
    if degenerate_fn is not None:
        sample_ok = sample_ok & ~degenerate_fn(xs, ys)

    models, valid = solve_fn(xs, ys)  # [B, S, M, ...], [B, S, M]
    valid = (valid & sample_ok[..., None]).reshape(B, -1)
    flat = models.reshape(B, -1, *models.shape[3:])

    r = residual_fn(flat, x[:, None], y[:, None])  # [B, H, N]
    thr = cfg.threshold if threshold is None else threshold
    thr_sq = thr * thr
    r_sq = r if residual_is_squared else r * r
    r_sq = torch.where(torch.isfinite(r_sq), r_sq, math.inf)
    inlier = (r_sq <= thr_sq) & pm[:, None, :]
    counts = torch.where(valid, inlier.sum(-1), -1)
    trunc = torch.where(pm[:, None, :], torch.clamp(r_sq, max=thr_sq), 0.0)
    msac = torch.where(valid, trunc.sum(-1), math.inf)

    best = _select_best(counts, msac, cfg.selection)
    best_mask = inlier[torch.arange(B, device=x.device), best]
    return flat, valid, counts, msac, best, best_mask


def _select_best(counts, msac, selection: str):
    """'msac' = min truncated score; 'count' = max inlier count with a
    lexicographic MSAC tie-break.  Argmin takes the first index on ties,
    as ``jnp.argmin`` does."""
    if selection == "count":
        max_count = counts.amax(-1, keepdim=True)
        return torch.where(counts == max_count, msac, math.inf).argmin(-1)
    return msac.argmin(-1)


def _take(a: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    return a[torch.arange(a.shape[0], device=a.device), best]


# --------------------------------------------------------------------------
# Homography
# --------------------------------------------------------------------------
def _h_solve(xs, ys):
    H, ok = homography.dlt_homography_minimal(xs, ys)
    return H[:, :, None], ok[:, :, None]


def _h_degenerate(xs, ys):
    return (homography.sample_is_degenerate(xs)
            | homography.sample_is_degenerate(ys))


def refit_homography(H_best, src, dst, inlier_mask, cfg: RansacConfig):
    """Weighted DLT on the inlier set, then LM; a non-finite refit keeps
    the minimal model.  Batched: H_best [B,3,3], src/dst [B,N,2],
    inlier_mask [B,N] bool.  On the card one launch (``ops.lm.
    fused_refit_homography``); CPU tensors take its plain version.  The
    ``ransac.refit`` span."""
    if not cfg.refit:
        return H_best
    with timed("ransac.refit"):
        if src.device.type != "cpu":
            return fused_refit_homography(H_best, src, dst, inlier_mask, cfg.refine_iters)
        return refit_homography_plain(H_best, src, dst, inlier_mask, cfg)


def refit_homography_plain(H_best, src, dst, inlier_mask, cfg: RansacConfig):
    """``refit_homography``'s plain version, op by op on any device, its
    LM included."""
    w = inlier_mask.to(src.dtype)
    H_ref = homography.dlt_homography(src, dst, w)
    if cfg.refine_iters > 0:
        H_ref, _ = refine_homography(H_ref, src, dst, w, max_iters=cfg.refine_iters)
    bad = ~torch.isfinite(H_ref).all(-1).all(-1)
    return torch.where(bad[:, None, None], H_best, H_ref)


def ransac_homography(src: torch.Tensor, dst: torch.Tensor,
                      point_mask: torch.Tensor, cfg: RansacConfig,
                      key_or_seed=None) -> RansacResult:
    """OpenCV ``findHomography(..., RANSAC, thr)`` equivalent: forward
    transfer error threshold, exhaustive (or seeded random) minimal
    samples, inlier refit (+LM).  src/dst [B,N,2] and point_mask [B,N], or
    one problem without the batch dimension."""
    single = src.dim() == 2
    if single:
        src, dst, point_mask = src[None], dst[None], point_mask[None]
    flat, valid, counts, msac, best, best_mask = ransac_fit(
        _h_solve, homography.transfer_errors, src, dst, point_mask, 4, cfg,
        degenerate_fn=_h_degenerate, key_or_seed=key_or_seed)
    H_best = _take(flat, best)
    H_ref = refit_homography(H_best, src, dst, best_mask, cfg)
    res = RansacResult(
        model=H_ref, raw_model=H_best, inlier_mask=best_mask,
        num_inliers=best_mask.sum(-1), score=_take(msac, best),
        best_index=best, counts=counts, num_hypotheses=int(valid.shape[-1]))
    if single:
        res = RansacResult(*(f[0] if isinstance(f, torch.Tensor) else f
                             for f in res))
    return res


def ransac_homography_sweep(src: torch.Tensor, dst: torch.Tensor,
                            point_mask: torch.Tensor, cfg: RansacConfig,
                            key_or_seed) -> RansacResult:
    """Homography RANSAC through the fused sweep kernel (``ops.sweep``),
    the high-throughput path for pools of at most 16 points; larger pools
    go to ``ransac_homography_sweep_large``.

    The kernel returns block-reduced records (row 0 min MSAC, row 1
    lexicographic count, masked and degenerate samples invalidated in the
    kernel, so selecting across blocks with the matching rule is exact);
    the winning minimal sample is re-solved exactly here and refit on its
    inliers, with the semantics of ``ransac_homography``.  One problem:
    src/dst [N,2], point_mask [N]; ``key_or_seed`` an int or a
    torch.Generator.
    """
    if src.shape[0] > sweep.MAX_POINTS:
        return ransac_homography_sweep_large(src, dst, point_mask, cfg,
                                             key_or_seed)
    n_hyp = max(cfg.num_hypotheses, sweep.BLOCK_H)
    n_hyp = -(-n_hyp // sweep.BLOCK_H) * sweep.BLOCK_H
    msac_all, counts_all, packed_all = sweep.homography_ransac_sweep(
        _as_seed(key_or_seed), src, dst, point_mask, cfg.threshold,
        n_hyp=n_hyp)
    row = 1 if cfg.selection == "count" else 0
    msac_all, counts_all, packed_all = (
        msac_all[row], counts_all[row], packed_all[row])
    best = _select_best(counts_all, msac_all, cfg.selection)
    p = packed_all[best].long()
    sample = torch.stack([p & 15, (p >> 4) & 15, (p >> 8) & 15, (p >> 12) & 15])
    return _homography_from_sample(src, dst, point_mask, cfg, sample, msac_all,
                                   counts_all, best, int(n_hyp))


def _homography_from_sample(src, dst, point_mask, cfg, sample, msac_all,
                            counts_all, best, n_hyp):
    """Re-solve a sweep's winning 4-point sample exactly, take its inliers
    and refit on them: the sweeps' result."""
    H_best, _ = homography.dlt_homography_minimal(src[sample], dst[sample])
    errs = homography.transfer_errors(H_best, src, dst)
    thr_sq = cfg.threshold * cfg.threshold
    best_mask = (errs * errs <= thr_sq) & point_mask.bool()
    H_ref = refit_homography(H_best[None], src[None], dst[None],
                             best_mask[None], cfg)[0]
    return RansacResult(
        model=H_ref, raw_model=H_best, inlier_mask=best_mask,
        num_inliers=best_mask.sum(), score=msac_all.index_select(0, best.reshape(1))[0],
        best_index=best, counts=counts_all, num_hypotheses=n_hyp)


def ransac_homography_sweep_large(src: torch.Tensor, dst: torch.Tensor,
                                  point_mask: torch.Tensor, cfg: RansacConfig,
                                  key_or_seed) -> RansacResult:
    """Homography RANSAC through the large-pool sweep (``ops.sweep_large``)
    for pools of up to 1024 points (two-view matching scale).

    The records carry flat hypothesis ids: the winner's sample is replayed
    from its id (``sample_indices_for``), mapped to input rows by the
    sweep's pool order, re-solved exactly and refit on its inliers, with
    the semantics of ``ransac_homography``.  ``num_hypotheses`` is what the
    kernel ran (whole blocks, at least 4 for pools over 64 points)."""
    n_hyp = max(cfg.num_hypotheses, sweep_large.BLOCK_H)
    n_hyp = -(-n_hyp // sweep_large.BLOCK_H) * sweep_large.BLOCK_H
    msac_all, counts_all, flat_all, (seeds, n_valid, order) = (
        sweep_large.homography_ransac_sweep_large(
            _as_seed(key_or_seed), src, dst, point_mask, cfg.threshold, n_hyp))
    row = 1 if cfg.selection == "count" else 0
    msac_all, counts_all, flat_all = msac_all[row], counts_all[row], flat_all[row]
    best = _select_best(counts_all, msac_all, cfg.selection)
    sample = order[sweep_large.sample_indices_for(flat_all[best], seeds, n_valid)]
    return _homography_from_sample(src, dst, point_mask, cfg, sample, msac_all,
                                   counts_all, best, int(counts_all.shape[-1]) * 8)


# --------------------------------------------------------------------------
# PnP
# --------------------------------------------------------------------------
def _pnp_residual(model, X, pix_n, ay=1.0):
    """model [...,12] = flattened R (9) + t (3); X [...,N,3] broadcast
    against the model's batch.  Residual in fx-normalized units with the
    y-component scaled by ``ay = fy/fx``, so ``err * fx`` is the exact
    pixel reprojection error.  Points behind the camera get +inf."""
    R = model[..., :9].reshape(*model.shape[:-1], 3, 3)
    t = model[..., 9:12]
    Xc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = Xc[..., 2]
    good_z = z > 1e-6
    uv = Xc[..., :2] / torch.where(good_z, z, 1.0)[..., None]
    d = uv - pix_n
    err = torch.sqrt(d[..., 0] ** 2 + (ay * d[..., 1]) ** 2)
    return torch.where(good_z, err, math.inf)


def _as_model(R, t):
    return torch.cat([R.reshape(*R.shape[:-2], 9), t], dim=-1)


def _pnp_solve(Xs, xs):
    R, t, valid = pnp.p3p_grunert(Xs, xs)  # [...,4,3,3], [...,4,3], [...,4]
    model = _as_model(R, t)                # [...,4,12]
    return model, valid & torch.isfinite(model).all(-1)


def _epnp_solve(Xs, xs):
    """EPnP as a 6-point minimal solver: 2 beta-case candidates per
    sample flatten into the hypothesis axis."""
    R, t, valid = pnp.epnp(Xs, xs)  # [...,2,3,3], [...,2,3], [...,2]
    model = _as_model(R, t)
    return model, valid & torch.isfinite(model).all(-1)


def _pnp_msac(model, Xw, pix_n, point_mask, thr_n, ay):
    r = _pnp_residual(model, Xw, pix_n, ay=ay)
    r_sq = torch.where(torch.isfinite(r), r * r, math.inf)
    w = point_mask.to(r_sq.dtype)
    score = (torch.clamp(r_sq, max=thr_n * thr_n) * w).sum(-1)
    return torch.where(torch.isfinite(model).all(-1), score, math.inf)


def _p3p_all_orders(X3, pix3):
    """Grunert P3P over the 3 cyclic orderings of one sample -> stacked
    (R [12,3,3], t [12,3], valid [12]).  Grunert is order-sensitive (point
    0 anchors the b^2 normalization) and the sweeps' tie-breaks can
    surface any ordering of a winning triple, so the host re-solve scores
    all three and lets MSAC pick."""
    k = torch.arange(3, device=X3.device)
    perms = (k[:, None] + k) % 3  # [[0, 1, 2], [1, 2, 0], [2, 0, 1]], no host copy
    R, t, v = pnp.p3p_grunert(X3[perms], pix3[perms])
    return R.reshape(-1, 3, 3), t.reshape(-1, 3), v.reshape(-1)


def _pnp_threshold_scales(K, dtype):
    """(thr_scale, ay): divide the pixel threshold by ``thr_scale`` (= fx)
    and scale y-residuals by ``ay`` (= fy/fx), so thresholds are true
    pixels under anisotropic K."""
    fx = K[0, 0].to(dtype)
    return fx, K[1, 1].to(dtype) / fx


def _pnp_refit_seed(R_best, t_best, Xw, pix_n, w, point_mask, thr_n, ay):
    """LM seed for the PnP refit: best of {raw winner, DLT-PnP, EPnP
    case-1/2 on the inlier set} by truncated MSAC."""
    R_dlt, t_dlt = pnp.dlt_pnp(Xw, pix_n, w)
    R_ep, t_ep, v_ep = pnp.epnp(Xw, pix_n, w)  # [2,...]
    cands = torch.stack([_as_model(R_best, t_best), _as_model(R_dlt, t_dlt),
                         *_as_model(R_ep, t_ep)])  # [4,12]
    # DLT needs >=6 points; EPnP >=4 — gate linear seeds below that.
    n_inl = (w > 0).sum()
    gate = torch.stack([torch.ones_like(v_ep[0]), n_inl >= 6,
                        v_ep[0] & (n_inl >= 4), v_ep[1] & (n_inl >= 4)])
    scores = _pnp_msac(cands, Xw, pix_n, point_mask, thr_n, ay)
    seed = cands.index_select(0, torch.where(gate, scores, math.inf).argmin().reshape(1))[0]
    return seed[:9].reshape(3, 3), seed[9:12]


def _pnp_refit(model_best, Xw, pixels, pix_n, K, best_mask, point_mask,
               thr_n, ay, cfg: RansacConfig):
    """Refit of the winning pose: the best seed of {raw winner, DLT-PnP,
    EPnP} on the inlier set, then LM (= solvePnPRefineLM); a non-finite LM
    result keeps the raw winner.  Returns the [12] model.  On the card one
    launch (``ops.lm.fused_refit_pose``); CPU tensors take its plain
    version.  The ``ransac.refit`` span."""
    if not cfg.refit:
        return model_best
    with timed("ransac.refit"):
        if Xw.device.type != "cpu":
            return fused_refit_pose(model_best, Xw, pixels, pix_n, K, best_mask, point_mask,
                                    thr_n, ay, max(cfg.refine_iters, 1))
        return pnp_refit_plain(model_best, Xw, pixels, pix_n, K, best_mask, point_mask,
                               thr_n, ay, cfg)


def pnp_refit_plain(model_best, Xw, pixels, pix_n, K, best_mask, point_mask,
                    thr_n, ay, cfg: RansacConfig):
    """``_pnp_refit``'s plain version, op by op (on the card its LM is the
    LM kernel)."""
    R_best = model_best[:9].reshape(3, 3)
    t_best = model_best[9:12]
    w = best_mask.to(Xw.dtype)
    R_seed, t_seed = _pnp_refit_seed(
        R_best, t_best, Xw, pix_n, w, point_mask, thr_n, ay)
    rvec, tvec, _ = refine_pose(
        log_so3(R_seed)[None], t_seed[None], Xw[None], pixels[None],
        K[None], w[None], max_iters=max(cfg.refine_iters, 1))
    rvec, tvec = rvec[0], tvec[0]
    ok = torch.isfinite(rvec).all() & torch.isfinite(tvec).all()
    return _as_model(torch.where(ok, exp_so3(rvec), R_best),
                     torch.where(ok, tvec, t_best))


def ransac_pnp(Xw: torch.Tensor, pixels: torch.Tensor, K: torch.Tensor,
               point_mask: torch.Tensor, cfg: RansacConfig, key_or_seed=None,
               solver: str = "p3p") -> RansacResult:
    """``cv2.solvePnPRansac`` equivalent over the exhaustive (or seeded
    random) minimal-sample tensor.  ``solver``: "p3p" (Grunert, 3-point,
    up to 4 roots) or "epnp" (6-point samples, 2 candidates).
    ``cfg.threshold`` is in pixels and stays pixel-true under anisotropic
    K.  Refit: best of {DLT-PnP, EPnP, raw winner} on the inlier set as
    the LM seed."""
    pix_n = projection.normalize_pixels(pixels, K)
    fx, ay = _pnp_threshold_scales(K, pix_n.dtype)
    thr_n = cfg.threshold / fx
    solve_fn, k = {"p3p": (_pnp_solve, 3), "epnp": (_epnp_solve, 6)}[solver]
    flat, valid, counts, msac, best, best_mask = ransac_fit(
        solve_fn, lambda m, x, y: _pnp_residual(m, x, y, ay=ay),
        Xw[None], pix_n[None], point_mask[None], k, cfg, threshold=thr_n,
        key_or_seed=key_or_seed)
    flat, valid, counts, msac, best, best_mask = (
        flat[0], valid[0], counts[0], msac[0], best[0], best_mask[0])
    model_best = flat.index_select(0, best.reshape(1))[0]
    model = _pnp_refit(model_best, Xw, pixels, pix_n, K, best_mask,
                       point_mask, thr_n, ay, cfg)
    return RansacResult(
        model=model, raw_model=model_best, inlier_mask=best_mask,
        num_inliers=best_mask.sum(), score=msac.index_select(0, best.reshape(1))[0],
        best_index=best,
        counts=counts, num_hypotheses=int(valid.shape[0]))


def ransac_pnp_sweep(Xw: torch.Tensor, pixels: torch.Tensor, K: torch.Tensor,
                     point_mask: torch.Tensor, cfg: RansacConfig,
                     key_or_seed) -> RansacResult:
    """PnP RANSAC through the fused P3P sweep kernel (``ops.sweep_pnp``),
    the high-throughput path for pools of at most 16 points; larger pools
    go to ``ransac_pnp_sweep_large``.

    The winning 3-point sample is re-solved exactly over its three cyclic
    orderings (12 candidate poses, scored by the pose-scoring kernel and
    picked by MSAC) and LM-refined on its inliers, with the semantics of
    ``ransac_pnp`` (incl. the pixel-true anisotropic threshold).
    ``key_or_seed``: an int or a torch.Generator.  The kernels read their
    threshold and y-scale as 0-d tensors formed from K on its device, so
    the call reads nothing back from the device until its refit.
    """
    if Xw.shape[0] > sweep_pnp.MAX_POINTS:
        return ransac_pnp_sweep_large(Xw, pixels, K, point_mask, cfg,
                                      key_or_seed)
    pix_n = projection.normalize_pixels(pixels, K)
    fx, ay = _pnp_threshold_scales(K, pix_n.dtype)
    thr_n = cfg.threshold / fx
    # Round up to a whole number of kernel blocks; small requests use a
    # single smaller block rather than padding to the full BLOCK_H.
    n_hyp = max(cfg.num_hypotheses, 1024)
    block = min(sweep_pnp.BLOCK_H, -(-n_hyp // 1024) * 1024)
    n_hyp = -(-n_hyp // block) * block
    msac_all, counts_all, packed_all = sweep_pnp.pnp_ransac_sweep(
        _as_seed(key_or_seed), Xw, pix_n, point_mask, thr_n, n_hyp=n_hyp,
        block_h=block, ay=ay)
    row = 1 if cfg.selection == "count" else 0
    msac_all, counts_all, packed_all = (
        msac_all[row], counts_all[row], packed_all[row])
    best = _select_best(counts_all, msac_all, cfg.selection)
    # index_select with the 0-d index as a tensor: indexing by it would read
    # it back to the host.
    p = packed_all.index_select(0, best.reshape(1))[0].long()
    sample = torch.stack([p & 15, (p >> 4) & 15, (p >> 8) & 15])
    R4, t4, v4 = _p3p_all_orders(Xw[sample], pix_n[sample])
    models4 = _as_model(R4, t4)
    # Score the 12 poses with the pose-scoring kernel (ops.score): scaling
    # each pose's y-row and the pixels' y by ay makes its residual the
    # pixel-true one of _pnp_residual, as the sweep kernel does.
    sy = torch.ones(12, dtype=models4.dtype, device=models4.device)
    sy[3:6] = ay
    sy[10] = ay
    _, msac4 = pnp_scores(models4 * sy, Xw, pix_n * torch.stack(
        [torch.ones_like(ay), ay]), point_mask, thr_n)
    msac4 = torch.where(v4 & torch.isfinite(msac4), msac4, math.inf)
    model_best = models4.index_select(0, msac4.argmin().reshape(1))[0]
    r = _pnp_residual(model_best, Xw, pix_n, ay=ay)
    best_mask = (torch.where(torch.isfinite(r), r * r, math.inf)
                 <= thr_n * thr_n) & point_mask.bool()
    return _pnp_sweep_result(model_best, Xw, pixels, pix_n, K, best_mask,
                             point_mask, thr_n, ay, cfg, msac_all, counts_all,
                             best, int(n_hyp) * 4)


def _pnp_sweep_result(model_best, Xw, pixels, pix_n, K, best_mask, point_mask,
                      thr_n, ay, cfg, msac_all, counts_all, best, n_hyp):
    model = _pnp_refit(model_best, Xw, pixels, pix_n, K, best_mask,
                       point_mask, thr_n, ay, cfg)
    return RansacResult(
        model=model, raw_model=model_best, inlier_mask=best_mask,
        num_inliers=best_mask.sum(), score=msac_all.index_select(0, best.reshape(1))[0],
        best_index=best, counts=counts_all, num_hypotheses=n_hyp)


def ransac_pnp_sweep_large(Xw: torch.Tensor, pixels: torch.Tensor,
                           K: torch.Tensor, point_mask: torch.Tensor,
                           cfg: RansacConfig, key_or_seed) -> RansacResult:
    """PnP RANSAC through the large-pool P3P sweep
    (``ops.sweep_pnp_large``) for pools of up to 512 points (SfM
    map-registration scale).

    The records carry ``flat * 4 + root``: the winner's 3-point sample is
    replayed from its flat id, re-solved over its three cyclic orderings
    (12 poses scored by truncated MSAC on every point) and LM-refined on
    its inliers, with the semantics of ``ransac_pnp``.  ``num_hypotheses``
    counts the kernel's samples times 4 roots."""
    pix_n = projection.normalize_pixels(pixels, K)
    fx, ay = _pnp_threshold_scales(K, pix_n.dtype)
    thr_n = cfg.threshold / fx
    block = sweep_pnp_large.BLOCK_H
    n_hyp = -(-max(cfg.num_hypotheses, block) // block) * block
    msac_all, counts_all, packed_all, (seeds, n_valid, order) = (
        sweep_pnp_large.pnp_ransac_sweep_large(
            _as_seed(key_or_seed), Xw, pix_n, point_mask, thr_n, n_hyp, ay=ay))
    row = 1 if cfg.selection == "count" else 0
    msac_all, counts_all, packed_all = (
        msac_all[row], counts_all[row], packed_all[row])
    best = _select_best(counts_all, msac_all, cfg.selection)
    sample = order[sweep_pnp_large.sample_indices3_for(
        packed_all[best].long() >> 2, seeds, n_valid)]
    R4, t4, v4 = _p3p_all_orders(Xw[sample], pix_n[sample])
    models4 = _as_model(R4, t4)
    r4 = _pnp_residual(models4, Xw, pix_n, ay=ay)  # [12, N]
    r4_sq = torch.where(torch.isfinite(r4), r4 * r4, math.inf)
    inl4 = (r4_sq <= thr_n * thr_n) & point_mask.bool()[None]
    msac4 = torch.where(point_mask[None] > 0,
                        torch.minimum(r4_sq, thr_n * thr_n), 0.0).sum(-1)
    kbest = torch.where(v4, msac4, math.inf).argmin()
    return _pnp_sweep_result(models4[kbest], Xw, pixels, pix_n, K, inl4[kbest],
                             point_mask, thr_n, ay, cfg, msac_all, counts_all,
                             best, int(counts_all.shape[-1]) * 8 * 4)


def pnp_pose_from_result(res: RansacResult):
    return res.model[:9].reshape(3, 3), res.model[9:12]


# --------------------------------------------------------------------------
# Essential matrix
# --------------------------------------------------------------------------
def _e_solve(xs, ys):
    E = epipolar.eight_point(xs, ys, essential=True)
    return E[:, :, None], torch.isfinite(E).all(-1).all(-1)[:, :, None]


def _e_refit(E_best, x1, x2, best_mask, cfg: RansacConfig):
    """8-point essential refit on the inlier set; a non-finite refit keeps
    the raw model."""
    if not cfg.refit:
        return E_best
    E_ref = epipolar.eight_point(x1, x2, best_mask.to(x1.dtype), essential=True)
    return torch.where(torch.isfinite(E_ref).all(), E_ref, E_best)


def ransac_essential(x1: torch.Tensor, x2: torch.Tensor, point_mask: torch.Tensor,
                     cfg: RansacConfig, key_or_seed=None) -> RansacResult:
    """8-point essential-matrix RANSAC on normalized coordinates over
    ``cfg.num_hypotheses`` random samples (the engine); ``cfg.threshold``
    is the Sampson bound in squared normalized units.  One problem: x1/x2
    [N,2], point_mask [N]."""
    cfg_sq = RansacConfig(
        threshold=math.sqrt(cfg.threshold), num_hypotheses=cfg.num_hypotheses,
        exhaustive=False, max_exhaustive_samples=cfg.max_exhaustive_samples,
        selection=cfg.selection, refit=cfg.refit,
        refine_iters=cfg.refine_iters, seed=cfg.seed)
    flat, valid, counts, msac, best, best_mask = ransac_fit(
        _e_solve, epipolar.sampson_distance, x1[None], x2[None],
        point_mask[None], 8, cfg_sq, key_or_seed=key_or_seed,
        residual_is_squared=True)
    flat, valid, counts, msac, best, best_mask = (
        flat[0], valid[0], counts[0], msac[0], best[0], best_mask[0])
    E_best = flat[best]
    return RansacResult(
        model=_e_refit(E_best, x1, x2, best_mask, cfg), raw_model=E_best,
        inlier_mask=best_mask, num_inliers=best_mask.sum(), score=msac[best],
        best_index=best, counts=counts, num_hypotheses=int(valid.shape[0]))


def ransac_essential_sweep(x1: torch.Tensor, x2: torch.Tensor,
                           point_mask: torch.Tensor, cfg: RansacConfig,
                           key_or_seed) -> RansacResult:
    """Essential-matrix RANSAC through the large-pool fused 8-point sweep
    (``ops.sweep_essential_large``), for pools of up to 1024
    correspondences; the contract of ``ransac_essential``.

    The winner's sample is replayed from its flat id and re-solved with the
    kernel's own canonical-frame arithmetic in the sweep's normalized frame
    (``minimal_f_canonical``): a fresh 8-point of the same sample scores
    another consensus (342 -> 56 inliers on a planted 512-point scene, per
    the JAX package).  The essential constraint comes with the refit on the
    consensus set."""
    n_hyp = max(cfg.num_hypotheses, sweep_essential_large.BLOCK_H)
    n_hyp = (-(-n_hyp // sweep_essential_large.BLOCK_H)
             * sweep_essential_large.BLOCK_H)
    msac_all, counts_all, flat_all, (seeds, n_valid, order, norm) = (
        sweep_essential_large.essential_ransac_sweep_large(
            _as_seed(key_or_seed), x1, x2, point_mask, cfg.threshold, n_hyp))
    row = 1 if cfg.selection == "count" else 0
    msac_all, counts_all, flat_all = msac_all[row], counts_all[row], flat_all[row]
    best = _select_best(counts_all, msac_all, cfg.selection)
    sample = order[sweep_essential_large.sample_indices_for8(
        flat_all[best], seeds, n_valid)]
    m1, m2, s = norm
    x1_n = (x1.to(torch.float32) - m1) * s
    x2_n = (x2.to(torch.float32) - m2) * s
    F_n, _ = sweep_essential_large.minimal_f_canonical(x1_n[sample], x2_n[sample])
    r_n = epipolar.sampson_distance(F_n, x1_n, x2_n)  # squared, normalized
    best_mask = (r_n <= cfg.threshold * s * s) & point_mask.bool()
    # The raw model back in input coordinates: F = T2^T F_n T1 with
    # Ti = [[s, 0, -s mi_x], [0, s, -s mi_y], [0, 0, 1]].
    zero, one = torch.zeros_like(s), torch.ones_like(s)

    def T(m):
        return torch.stack([torch.stack([s, zero, -s * m[0]]),
                            torch.stack([zero, s, -s * m[1]]),
                            torch.stack([zero, zero, one])])

    E_best = T(m2).T @ F_n @ T(m1)
    return RansacResult(
        model=_e_refit(E_best, x1, x2, best_mask, cfg), raw_model=E_best,
        inlier_mask=best_mask, num_inliers=best_mask.sum(),
        score=msac_all[best], best_index=best, counts=counts_all,
        num_hypotheses=int(counts_all.shape[-1]) * 8)
