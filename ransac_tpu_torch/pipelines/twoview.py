"""Two-view reconstruction pipeline (port of
``ransac_tpu.pipelines.twoview``).

Harris detection (top K) -> normalized patch descriptors -> mutual-NN
matching -> essential-matrix RANSAC -> pose recovery (cheirality over the
four decompositions) -> LM polish of the relative pose on inlier Sampson
residuals -> DLT triangulation.  Fixed shapes throughout: the K match slots
carry a validity mask into the RANSAC.  With ``engine="auto"`` CUDA images
take the fused large-pool sweep (``ransac_essential_sweep``, kernel
``csrc/sweep_essential_large.cu``) and CPU images the stage-wise engine.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ransac_tpu_torch.features.detect import detect_harris
from ransac_tpu_torch.features.match import mutual_nn_match, patch_descriptors
from ransac_tpu_torch.models import ransac as ransac_mod
from ransac_tpu_torch.ops import epipolar
from ransac_tpu_torch.ops.projection import normalize_pixels
from ransac_tpu_torch.utils.config import RansacConfig, TwoViewConfig


@dataclass
class TwoViewResult:
    kp1: np.ndarray          # [K, 2]
    kp2: np.ndarray
    matches: np.ndarray      # [M, 2] keypoint index pairs (valid only)
    E: np.ndarray            # [3, 3]
    inliers: np.ndarray      # [M] bool (per returned match)
    R: np.ndarray            # [3, 3] relative pose view 1 -> view 2
    t: np.ndarray            # [3] unit translation
    points3d: np.ndarray     # [M, 3] triangulated (view 1 frame)
    n_cheiral: int


def two_view_pipeline(img1, img2, K, cfg: TwoViewConfig = TwoViewConfig(),
                      seed: int = 0, device="cuda") -> TwoViewResult:
    """The two-view flow on a pair of grayscale float images ([H, W]
    arrays or tensors, values in [0, 1]) and intrinsics K [3, 3]."""
    img1 = torch.as_tensor(np.asarray(img1, np.float32), device=device)
    img2 = torch.as_tensor(np.asarray(img2, np.float32), device=device)
    K_np = np.asarray(K, np.float64)
    Kt = torch.as_tensor(K_np, dtype=torch.float32, device=device)

    kp1 = detect_harris(img1, cfg.max_keypoints, cfg.nms_radius, cfg.harris_k)
    kp2 = detect_harris(img2, cfg.max_keypoints, cfg.nms_radius, cfg.harris_k)
    d1 = patch_descriptors(img1, kp1.xy, kp1.valid, cfg.patch_size)
    d2 = patch_descriptors(img2, kp2.xy, kp2.valid, cfg.patch_size)
    m = mutual_nn_match(d1, d2, kp1.valid, kp2.valid, cfg.match_ratio)

    x1 = normalize_pixels(kp1.xy[m.idx1], Kt)
    x2 = normalize_pixels(kp2.xy[m.idx2], Kt)
    mask = m.valid.to(torch.float32)
    # The threshold is in pixels; the Sampson distance is in squared
    # normalized units: bound (px / focal)^2.
    focal = float(K_np[0, 0] + K_np[1, 1]) / 2.0
    r = cfg.ransac
    e_cfg = RansacConfig(
        threshold=(r.threshold / focal) ** 2, num_hypotheses=r.num_hypotheses,
        exhaustive=False, selection=r.selection, refit=r.refit,
        refine_iters=r.refine_iters, seed=r.seed)
    engine = cfg.engine
    if engine == "auto":
        engine = "sweep" if img1.device.type == "cuda" else "stagewise"
    if engine == "sweep":
        res = ransac_mod.ransac_essential_sweep(x1, x2, mask, e_cfg, seed)
    else:
        res = ransac_mod.ransac_essential(x1, x2, mask, e_cfg, seed)
    inl_w = res.inlier_mask.to(torch.float32)
    R0, t0, _, _ = epipolar.recover_pose(res.model, x1, x2, inl_w)
    R, t, E_ref = epipolar.refine_relative_pose(R0, t0, x1, x2, inl_w)
    _, _, X, n = epipolar.recover_pose(E_ref, x1, x2, inl_w)

    valid_rows = m.valid.cpu().numpy()
    return TwoViewResult(
        kp1=kp1.xy.cpu().numpy(), kp2=kp2.xy.cpu().numpy(),
        matches=torch.stack([m.idx1, m.idx2], 1).cpu().numpy()[valid_rows],
        E=res.model.cpu().numpy(),
        inliers=res.inlier_mask.cpu().numpy()[valid_rows],
        R=R.cpu().numpy(), t=t.cpu().numpy(),
        points3d=X.cpu().numpy()[valid_rows], n_cheiral=int(n))
