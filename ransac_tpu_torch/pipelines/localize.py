"""Single-image candidate-camera localization (port of
``ransac_tpu.pipelines.localize``).

The reference's flow (main_v1.py:836-930): one homography RANSAC per
candidate camera -> argmin err2 -> PnP-RANSAC -> LM refine -> camera
origin.  The candidate search takes one of two routes:

- ``score_candidates``: the batched engine (``models.ransac``) over all
  C candidates x C(N,4) exhaustive samples, as plain tensor code;
- ``score_candidates_sweep``: one launch of the candidate-sweep kernel
  (``ops.sweep_multi``), then the winning sample of each candidate is
  re-solved, refit (DLT + LM) and scored.

``export_best_candidate_report`` writes the ``--report`` CSVs (and plots)
of the winning candidate.

Geometry runs scene-centred float32 on the scene's device; absolute UTM in
and out stays float64 on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ransac_tpu_torch.io.tables import Scene
from ransac_tpu_torch.models import ransac as ransac_mod
from ransac_tpu_torch.ops import homography as hops
from ransac_tpu_torch.ops import projection as proj
from ransac_tpu_torch.ops.linalg import inv3x3
from ransac_tpu_torch.ops.sweep_multi import BLOCK_H, multi_candidate_sweep
from ransac_tpu_torch.utils.config import LocalizeConfig
from ransac_tpu_torch.utils.logging import get_logger, host_sync, timed

log = get_logger("localize")


def reference_scores(H, pos2, pixels, inlier_mask, point_mask, ransacbound):
    """The reference's per-candidate (err1, err2) scoring
    (main_v1.py:332-419), batched: H [C,3,3], pos2 [C,N,2], pixels [N,2],
    inlier_mask [C,N].  err1 = pixel error over inliers; err2 = plane
    error over inliers + #outliers x ransacbound.  Non-finite errors
    become 1e9 so masked sums cannot turn into NaN."""
    inl_f = (inlier_mask & point_mask.bool()).to(pixels.dtype)
    e1 = torch.linalg.vector_norm(hops.apply_h(H, pos2) - pixels, dim=-1)
    e1 = torch.where(torch.isfinite(e1), e1, 1e9)
    err1 = (e1 * inl_f).sum(-1)
    e2 = torch.linalg.vector_norm(hops.apply_h(inv3x3(H), pixels) - pos2, dim=-1)
    e2 = torch.where(torch.isfinite(e2), e2, 1e9)
    err2 = (e2 * inl_f).sum(-1)
    n_out = point_mask.sum() - inl_f.sum(-1)
    return err1, err2 + n_out * ransacbound


def _gate_and_select(err1, err2, grid_codes, cfg: LocalizeConfig):
    """Grid gate (grid_code < grid_code_min scores 0, main_v1.py:274-282),
    then the argmin guard: err2 == 0 or non-finite -> 1e6 before argmin
    (main_v1.py:863-866), so a singular refit cannot hijack it."""
    gate = grid_codes >= cfg.grid_code_min
    err1 = torch.where(gate, err1, 0.0)
    err2 = torch.where(gate, err2, 0.0)
    err2_sel = torch.where((err2 == 0.0) | ~torch.isfinite(err2), 1e6, err2)
    best = err2_sel.argmin()
    with host_sync("localize.best_err2"):  # indexing by a 0-d tensor reads it
        best_err2 = err2_sel[best]
    return err1, err2, best, best_err2


def score_candidates(pixels, pos3d, point_mask, cam_locs, grid_codes,
                     cfg: LocalizeConfig):
    """Score every candidate camera through the batched RANSAC engine.

    pixels [N,2], pos3d [N,3] centred, point_mask [N], cam_locs [C,3]
    centred, grid_codes [C].  Returns a dict of err1 [C], err2 [C], H
    [C,3,3] (plane -> pixel), inliers [C,N], counts [C], best, best_err2.
    """
    C = cam_locs.shape[0]
    pos2, _ = proj.east_axis_plane_projection(pos3d[None], cam_locs)  # [C,N,2]
    res = ransac_mod.ransac_homography(
        pos2, pixels.expand(C, -1, -1), point_mask.expand(C, -1), cfg.ransac)
    err1, err2 = reference_scores(res.model, pos2, pixels, res.inlier_mask,
                                  point_mask, cfg.ransac.threshold)
    err1, err2, best, best_err2 = _gate_and_select(err1, err2, grid_codes, cfg)
    inliers = res.inlier_mask & point_mask.bool()
    return {"err1": err1, "err2": err2, "H": res.model, "inliers": inliers,
            "counts": res.num_inliers, "best": best, "best_err2": best_err2}


def sweep_sample_table(n: int, device) -> torch.Tensor:
    """[4, H] int32 table of every C(n,4) sample in combinations order,
    padded to a multiple of BLOCK_H with copies of the first sample
    (as ``localize.py:130-135`` of the JAX package pads it)."""
    combos = ransac_mod.combinations_table(n, 4, device).T.to(torch.int32)
    S = combos.shape[1]
    H = -(-S // BLOCK_H) * BLOCK_H
    return torch.cat([combos, combos[:, :1].expand(4, H - S)], 1).contiguous()


def score_candidates_sweep(pixels, pos3d, point_mask, cam_locs, grid_codes,
                           cfg: LocalizeConfig):
    """``score_candidates`` through the candidate-sweep kernel: the whole
    (C candidates x C(N,4) hypotheses) hypothesize-and-verify is one
    launch; each candidate's winning sample is re-solved, refit (+LM) and
    reference-scored.  Same samples, selection, refit and scoring as the
    engine route."""
    rcfg = cfg.ransac
    C, n = cam_locs.shape[0], pixels.shape[0]
    pos2, _ = proj.east_axis_plane_projection(pos3d[None], cam_locs)  # [C,N,2]
    _, _, packed = multi_candidate_sweep(
        pos2, pixels, point_mask, sweep_sample_table(n, pixels.device),
        rcfg.threshold)
    sample = torch.stack([(packed >> s) & 15 for s in (0, 4, 8, 12)],
                         1).long()  # [C,4]
    src4 = pos2.gather(1, sample[..., None].expand(C, 4, 2))
    H_best, _ = hops.dlt_homography_minimal(src4, pixels[sample])
    errs = hops.transfer_errors(H_best, pos2, pixels)
    inl = (errs * errs <= rcfg.threshold * rcfg.threshold) & point_mask.bool()
    Hm = ransac_mod.refit_homography(H_best, pos2, pixels.expand(C, -1, -1),
                                     inl, rcfg)
    err1, err2 = reference_scores(Hm, pos2, pixels, inl, point_mask,
                                  rcfg.threshold)
    err1, err2, best, best_err2 = _gate_and_select(err1, err2, grid_codes, cfg)
    return {"err1": err1, "err2": err2, "H": Hm, "inliers": inl,
            "counts": inl.sum(-1), "best": best, "best_err2": best_err2}


@dataclass
class LocalizationResult:
    best_index: int
    best_location_utm: np.ndarray     # [3] f64
    err1: np.ndarray                  # [C]
    err2: np.ndarray                  # [C]
    homographies: np.ndarray          # [C,3,3]
    inlier_masks: np.ndarray          # [C,N]
    K: np.ndarray                     # [3,3]
    R: np.ndarray | None              # [3,3] world(centred UTM)->camera
    t: np.ndarray | None              # [3] (centred frame)
    camera_origin_utm: np.ndarray | None  # [3] f64
    pnp_inliers: np.ndarray | None    # [N] bool
    scores_rows: list                 # per-candidate CSV rows (ref layout)


def localize(
    scene: Scene,
    image_size: tuple[int, int],
    cfg: LocalizeConfig = LocalizeConfig(),
    seed: int = 0,
    use_sweep: bool = False,
    device="cuda",
) -> LocalizationResult:
    """Full localization on ``device``: candidate search + PnP pose
    (main_v1.py:836-930 minus the DEM stage).  ``use_sweep=True`` routes
    the search through the candidate-sweep kernel.

    Every sample set is exhaustive, so no random numbers are drawn;
    ``seed`` is kept for the JAX entry point's signature."""
    del seed
    with timed("localize"):
        return _localize(scene, image_size, cfg, use_sweep, device)


def _localize(scene, image_size, cfg, use_sweep, device) -> LocalizationResult:
    width, height = image_size
    scene = scene.to(device)

    with timed("localize.search"):
        search = score_candidates_sweep if use_sweep else score_candidates
        out = search(scene.pixels, scene.pos3d, scene.point_mask,
                     scene.cam_locs, scene.grid_codes, cfg)
        with host_sync("localize.search", n=len(out)):
            out = {k: v.cpu() for k, v in out.items()}
        out = {k: v.numpy() for k, v in out.items()}
    best = int(out["best"])
    with host_sync("localize.best_location"):
        best_cam = scene.cam_locs[best].cpu()
    best_loc = scene.frame.uncenter(best_cam.numpy())
    grid_codes = scene.cameras.grid_codes
    log.info("best candidate %d grid=%d err2=%.3f utm=%s", best,
             int(grid_codes[best]), float(out["err2"][best]), best_loc)

    # Reference CSV rows (main_v1.py:283): [i+1, err1, err2, grid, E, N, z].
    cam_utm = scene.cameras.pos3d_utm
    scores_rows = [
        [i + 1, float(out["err1"][i]), float(out["err2"][i]),
         int(grid_codes[i]), cam_utm[i, 0], cam_utm[i, 1], cam_utm[i, 2]]
        for i in range(len(grid_codes))]

    ic = cfg.intrinsics
    K = proj.intrinsics_from_physical(
        ic.focal_length_mm, ic.sensor_width_mm, ic.sensor_height_mm, width,
        height, ic.cx, ic.cy, device=scene.device)

    # PnP on annotated correspondences (centred frame).
    R = t = origin_utm = pnp_inl = None
    with timed("localize.pnp"):
        res = ransac_mod.ransac_pnp(scene.pos3d, scene.pixels, K,
                                    scene.point_mask, cfg.pnp_ransac)
        with host_sync("localize.pnp_inliers"):
            n_inl = int(res.num_inliers)
        if n_inl >= cfg.min_pnp_inliers:
            Rt, tt = ransac_mod.pnp_pose_from_result(res)
            with host_sync("localize.pose", n=3):
                Rt, tt, inl = Rt.cpu(), tt.cpu(), res.inlier_mask.cpu()
            R = Rt.numpy().astype(np.float64)
            t = tt.numpy().astype(np.float64)
            origin_utm = scene.frame.uncenter(-R.T @ t)
            pnp_inl = inl.numpy()
            log.info("PnP pose: %d inliers, origin %s", n_inl, origin_utm)
        else:
            # main_v1.py:504-506 guard.
            log.warning("PnP RANSAC failed or insufficient inliers (%d)", n_inl)

    with host_sync("localize.K"):
        K_host = K.cpu().numpy()
    return LocalizationResult(
        best_index=best, best_location_utm=best_loc,
        err1=out["err1"], err2=out["err2"], homographies=out["H"],
        inlier_masks=out["inliers"], K=K_host, R=R, t=t,
        camera_origin_utm=origin_utm, pnp_inliers=pnp_inl,
        scores_rows=scores_rows)


def export_best_candidate_report(
    scene: Scene, result: LocalizationResult, outputfile: str,
    image=None, depth_val: float = 1.0, make_plots: bool = True,
    all_features=None,
):
    """The reference's show-mode artifacts for the winning candidate
    (main_v1.py:384-417 + find_homographies(show=True) second pass):
    ``*_accuracies.csv``, ``*_correlations.csv`` and, with ``make_plots``,
    the eight diagnostic plots (annotated overlay, error histogram, bearing
    rose, NN distances, homography heatmap, RANSAC scatter, score map,
    candidate poses) saved next to ``outputfile``.

    The winning candidate's plane points go through its homography on the
    scene's device.  ``all_features``: optional FeatureTable read with
    ``keep_unannotated=True``; its (0,0)-pixel rows are forward-projected
    through the winning H into both CSVs and the overlay (black squares),
    as the reference's unnoted-feature block (main_v1.py:367-383), with
    the actual pixel written as (0, 0).  Returns (accuracy rows,
    correlation rows)."""
    from ransac_tpu_torch import analytics
    from ransac_tpu_torch.io.export import write_rows_csv

    best = result.best_index
    dev = scene.device
    feats = scene.features if all_features is None else all_features
    pos3d_local = (scene.pos3d if all_features is None else torch.as_tensor(
        scene.frame.center(feats.pos3d_utm), device=dev))
    H = torch.as_tensor(np.asarray(result.homographies[best], np.float32),
                        device=dev)
    pos2, _ = proj.east_axis_plane_projection(pos3d_local, scene.cam_locs[best])
    calc_pixels = hops.apply_h(H, pos2).cpu().numpy()
    annotated = (np.abs(np.asarray(feats.pixels)) > 0).any(axis=1)
    pos_xy = feats.pos3d_utm[:, :2]

    acc_rows = analytics.accuracy_rows(
        feats.symbols, feats.names, pos_xy, feats.pixels, calc_pixels)
    write_rows_csv(outputfile.replace(".jpg", "_accuracies.csv"), acc_rows,
                   encoding="utf-8-sig")
    corr_rows = analytics.correlate_features(
        feats.symbols, pos_xy, feats.pixels, calc_pixels, depth_val)
    write_rows_csv(outputfile.replace(".jpg", "_correlations.csv"), corr_rows)

    if make_plots:
        from ransac_tpu_torch import viz

        base = outputfile.replace(".jpg", "")
        inl_best = np.asarray(result.inlier_masks[best])
        if all_features is None:
            inl = inl_best
        else:
            # The search's annotated-row inlier mask on the full table (row
            # order is kept by ingest); unannotated rows are display-only.
            inl = np.zeros(len(feats), bool)
            inl[annotated] = inl_best
        viz.plot_annotated_image(
            image, feats.pixels, feats.symbols, calc_pixels, inl,
            unannotated_mask=~annotated, save_to=base + "_output.png")
        err = np.linalg.norm(calc_pixels - feats.pixels, axis=1)
        viz.plot_error_histogram(err[inl], "inlier pixel error",
                                 save_to=base + "_err_hist.png")
        viz.plot_angle_rose(
            analytics.calc_bearing(
                feats.pixels[:, 0], feats.pixels[:, 1],
                calc_pixels[:, 0], calc_pixels[:, 1]),
            save_to=base + "_rose.png")
        viz.plot_nearest_neighbor_distances(
            analytics.nearest_neighbor_distances(feats.pixels),
            save_to=base + "_nn.png")
        viz.plot_homography_heatmap(result.homographies[best],
                                    save_to=base + "_H.png")
        viz.plot_ransac_scatter(feats.pixels[inl], feats.pixels[~inl],
                                save_to=base + "_ransac.png")
        viz.plot_camera_location_scores(
            result.scores_rows, zone=scene.frame.zone,
            save_to=base + "_scores.png")
        viz.plot_camera_pose(scene.cameras.pos3d_utm, best,
                             zone=scene.frame.zone,
                             save_to=base + "_pose.png")
    return acc_rows, corr_rows
