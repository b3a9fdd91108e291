"""Fixed-shape batched RANSAC engine (port of ``ransac_tpu.models.ransac``).

A static tensor of minimal samples — every C(N,k) sample, enumerated in
``itertools.combinations`` order — is solved by a batched minimal solver
and scored in one pass; multi-solution solvers (P3P's 4 roots) flatten
into the hypothesis axis with a validity mask.  Selection is MSAC or
inlier count, then a weighted least-squares refit plus LM on the winning
inlier set (OpenCV's final refinement).

Where JAX vmapped the engine over candidates, the port writes the batch
out: ``ransac_fit`` and ``ransac_homography`` take a leading batch
dimension [B, N, ...].  The random-sampling branch (``utils/prng``) is not
ported: the localize slice is exhaustive (C(13,4) = 715 and C(13,3) = 286
samples, both under the 8192 cap).
"""

from __future__ import annotations

import math
from functools import lru_cache
from itertools import combinations
from typing import Any, Callable, NamedTuple

import torch

from ransac_tpu_torch.ops import homography, pnp, projection
from ransac_tpu_torch.ops.lm import refine_homography, refine_pose
from ransac_tpu_torch.ops.rotation import exp_so3, log_so3
from ransac_tpu_torch.utils.config import RansacConfig


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
    return torch.tensor(list(combinations(range(n), k)), dtype=torch.int64,
                        device=device)


def combinations_table(n: int, k: int, device) -> torch.Tensor:
    """[C(n,k), k] int64 sample table in ``itertools.combinations`` order
    (the JAX package's order, so argmin tie-breaks match), cached on the
    device per (n, k)."""
    return _combinations_on(n, k, str(torch.device(device)))


def _sample_indices(n_points: int, sample_size: int, cfg: RansacConfig,
                    device) -> torch.Tensor:
    if cfg.exhaustive and math.comb(n_points, sample_size) <= cfg.max_exhaustive_samples:
        return combinations_table(n_points, sample_size, device)
    raise NotImplementedError(
        "random-sampling RANSAC (ransac_tpu/utils/prng.py) is not ported yet; "
        "see ROADMAP.md queue 1, 'random-sampling branch and utils/prng'")


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
):
    """Engine core over a batch of problems.  Returns (models_flat
    [B,H,...], valid [B,H], counts [B,H], msac [B,H], best [B],
    inlier_mask_best [B,N])."""
    B, n_points = x.shape[:2]
    pm = point_mask.bool()
    idx = _sample_indices(n_points, sample_size, cfg, x.device)  # [S,k]

    xs = x[:, idx]  # [B, S, k, dx]
    ys = y[:, idx]
    sample_ok = pm[:, idx].all(-1)
    if degenerate_fn is not None:
        sample_ok = sample_ok & ~degenerate_fn(xs, ys)

    models, valid = solve_fn(xs, ys)  # [B, S, M, ...], [B, S, M]
    valid = (valid & sample_ok[..., None]).reshape(B, -1)
    flat = models.reshape(B, -1, *models.shape[3:])

    r = residual_fn(flat, x[:, None], y[:, None])  # [B, H, N]
    thr = cfg.threshold if threshold is None else threshold
    thr_sq = thr * thr
    r_sq = r * r
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
    the minimal model.  Batched: H_best [B,3,3], src/dst [B,N,2]."""
    if not cfg.refit:
        return H_best
    w = inlier_mask.to(src.dtype)
    H_ref = homography.dlt_homography(src, dst, w)
    if cfg.refine_iters > 0:
        H_ref, _ = refine_homography(H_ref, src, dst, w,
                                     max_iters=cfg.refine_iters)
    bad = ~torch.isfinite(H_ref).all(-1).all(-1)
    return torch.where(bad[:, None, None], H_best, H_ref)


def ransac_homography(src: torch.Tensor, dst: torch.Tensor,
                      point_mask: torch.Tensor,
                      cfg: RansacConfig) -> RansacResult:
    """OpenCV ``findHomography(..., RANSAC, thr)`` equivalent: forward
    transfer error threshold, exhaustive minimal samples, inlier refit
    (+LM).  src/dst [B,N,2] and point_mask [B,N], or one problem without
    the batch dimension."""
    single = src.dim() == 2
    if single:
        src, dst, point_mask = src[None], dst[None], point_mask[None]
    flat, valid, counts, msac, best, best_mask = ransac_fit(
        _h_solve, homography.transfer_errors, src, dst, point_mask, 4, cfg,
        degenerate_fn=_h_degenerate)
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
    seed = cands[torch.where(gate, scores, math.inf).argmin()]
    return seed[:9].reshape(3, 3), seed[9:12]


def ransac_pnp(Xw: torch.Tensor, pixels: torch.Tensor, K: torch.Tensor,
               point_mask: torch.Tensor, cfg: RansacConfig,
               solver: str = "p3p") -> RansacResult:
    """``cv2.solvePnPRansac`` equivalent over the exhaustive minimal-sample
    tensor.  ``solver``: "p3p" (Grunert, 3-point, up to 4 roots) or
    "epnp" (6-point samples, 2 candidates).  ``cfg.threshold`` is in
    pixels and stays pixel-true under anisotropic K.  Refit: best of
    {DLT-PnP, EPnP, raw winner} on the inlier set as the LM seed."""
    pix_n = projection.normalize_pixels(pixels, K)
    fx = K[0, 0].to(pix_n.dtype)
    ay = K[1, 1].to(pix_n.dtype) / fx
    thr_n = cfg.threshold / fx
    solve_fn, k = {"p3p": (_pnp_solve, 3), "epnp": (_epnp_solve, 6)}[solver]
    flat, valid, counts, msac, best, best_mask = ransac_fit(
        solve_fn, lambda m, x, y: _pnp_residual(m, x, y, ay=ay),
        Xw[None], pix_n[None], point_mask[None], k, cfg, threshold=thr_n)
    flat, valid, counts, msac, best, best_mask = (
        flat[0], valid[0], counts[0], msac[0], best[0], best_mask[0])
    model_best = flat[best]
    R_best = model_best[:9].reshape(3, 3)
    t_best = model_best[9:12]
    R_ref, t_ref = R_best, t_best
    if cfg.refit:
        w = best_mask.to(Xw.dtype)
        R_seed, t_seed = _pnp_refit_seed(
            R_best, t_best, Xw, pix_n, w, point_mask, thr_n, ay)
        rvec, tvec, _ = refine_pose(
            log_so3(R_seed)[None], t_seed[None], Xw[None], pixels[None],
            K[None], w[None], max_iters=max(cfg.refine_iters, 1))
        rvec, tvec = rvec[0], tvec[0]
        ok = torch.isfinite(rvec).all() & torch.isfinite(tvec).all()
        R_ref = torch.where(ok, exp_so3(rvec), R_best)
        t_ref = torch.where(ok, tvec, t_best)
    return RansacResult(
        model=_as_model(R_ref, t_ref), raw_model=model_best,
        inlier_mask=best_mask, num_inliers=best_mask.sum(), score=msac[best],
        best_index=best, counts=counts, num_hypotheses=int(valid.shape[0]))


def pnp_pose_from_result(res: RansacResult):
    return res.model[:9].reshape(3, 3), res.model[9:12]
