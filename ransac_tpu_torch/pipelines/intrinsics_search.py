"""Intrinsics grid search: the focal length and film format by PnP (port
of ``ransac_tpu.pipelines.intrinsics_search``).

``testpro-K.py:39-162`` (``estimate_camera_orientation``): for every
(focal length, sensor size) combination, K from film physics, PnP-RANSAC
(the engine's exhaustive sample tensor, so no seed picks the samples), the
mean reprojection error and the distance to a known camera origin; the
combinations are ranked and the winner's pose LM-refined on every point
(testpro-K.py:122-125).  Runs on ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ransac_tpu_torch.models import ransac as ransac_mod
from ransac_tpu_torch.ops import projection as proj
from ransac_tpu_torch.ops.lm import refine_pose
from ransac_tpu_torch.ops.rotation import exp_so3, log_so3
from ransac_tpu_torch.utils.config import RansacConfig
from ransac_tpu_torch.utils.logging import get_logger

log = get_logger("intrinsics")

# The reference's grids (testpro-K.py:227-233): focal lengths in mm and
# large-format film sizes (w, h) in mm.
DEFAULT_FOCAL_LENGTHS_MM = (90, 100, 120, 150, 180, 210, 240, 300, 360)
DEFAULT_SENSOR_SIZES_MM = ((102, 127), (127, 178), (203, 254))


@dataclass
class IntrinsicsCandidate:
    focal_mm: float
    sensor_mm: tuple
    K: np.ndarray
    rvec: np.ndarray
    tvec: np.ndarray
    n_inliers: int
    mean_err_px: float
    max_err_px: float
    origin: np.ndarray
    dist_to_known: float


@dataclass
class IntrinsicsSearchResult:
    candidates: list          # ranked IntrinsicsCandidate
    best: IntrinsicsCandidate
    refined_rvec: np.ndarray
    refined_tvec: np.ndarray
    refined_mean_err_px: float


def search_intrinsics(
    pos3d: np.ndarray,            # [N, 3] (scene-centred recommended)
    pixels: np.ndarray,           # [N, 2]
    image_size: tuple,            # (W, H)
    known_origin: np.ndarray | None = None,
    focal_lengths_mm=DEFAULT_FOCAL_LENGTHS_MM,
    sensor_sizes_mm=DEFAULT_SENSOR_SIZES_MM,
    ransac_cfg: RansacConfig = RansacConfig(
        threshold=30.0, num_hypotheses=5000, exhaustive=True),
    rank_by: str = "dist",        # 'dist' (testpro-K.py:99) or 'err'
    seed: int = 0,
    device="cuda",
) -> IntrinsicsSearchResult:
    """Rank every (focal, sensor) combination by ``rank_by`` (the distance
    of the PnP camera to ``known_origin``, then the mean error; or the mean
    error, then the distance) and refine the winner's pose."""
    W, H = image_size
    Xt = torch.as_tensor(np.asarray(pos3d, np.float32), device=device)
    pt = torch.as_tensor(np.asarray(pixels, np.float32), device=device)
    mask = torch.ones(len(pos3d), dtype=torch.float32, device=device)
    cands: list[IntrinsicsCandidate] = []
    for f_mm in focal_lengths_mm:
        for sw, sh in sensor_sizes_mm:
            Kt = proj.intrinsics_from_physical(float(f_mm), float(sw), float(sh),
                                               W, H, W / 2.0, H / 2.0, device=device)
            res = ransac_mod.ransac_pnp(Xt, pt, Kt, mask, ransac_cfg, seed)
            R, t = ransac_mod.pnp_pose_from_result(res)
            pix_pred, _ = proj.project_points(Xt, R, t, Kt)
            err = np.linalg.norm(pix_pred.cpu().numpy() - pixels, axis=1)
            Rn = R.cpu().numpy().astype(np.float64)
            tn = t.cpu().numpy().astype(np.float64)
            origin = -Rn.T @ tn
            dist = (float(np.linalg.norm(origin - known_origin))
                    if known_origin is not None else np.nan)
            cands.append(IntrinsicsCandidate(
                focal_mm=float(f_mm), sensor_mm=(sw, sh),
                K=Kt.cpu().numpy().astype(np.float64),
                rvec=log_so3(R).cpu().numpy().astype(np.float64), tvec=tn,
                n_inliers=int(res.num_inliers), mean_err_px=float(err.mean()),
                max_err_px=float(err.max()), origin=origin, dist_to_known=dist))

    if rank_by == "dist" and known_origin is not None:
        cands.sort(key=lambda c: (c.dist_to_known, c.mean_err_px))
    else:
        cands.sort(key=lambda c: (c.mean_err_px, c.dist_to_known))
    best = cands[0]
    log.info("best combo: f=%.0fmm sensor=%s err=%.2fpx dist=%.1fm",
             best.focal_mm, best.sensor_mm, best.mean_err_px, best.dist_to_known)

    # LM refine of the winner on all points (testpro-K.py:122-125).
    Kb = torch.as_tensor(best.K.astype(np.float32), device=device)
    rvec_r, tvec_r, _ = refine_pose(
        torch.as_tensor(best.rvec.astype(np.float32), device=device)[None],
        torch.as_tensor(best.tvec.astype(np.float32), device=device)[None],
        Xt[None], pt[None], Kb[None])
    pix_pred, _ = proj.project_points(Xt, exp_so3(rvec_r[0]), tvec_r[0], Kb)
    err_r = np.linalg.norm(pix_pred.cpu().numpy() - pixels, axis=1)
    return IntrinsicsSearchResult(
        candidates=cands, best=best,
        refined_rvec=rvec_r[0].cpu().numpy().astype(np.float64),
        refined_tvec=tvec_r[0].cpu().numpy().astype(np.float64),
        refined_mean_err_px=float(err_r.mean()))
