"""The multi-frame SfM demo end to end (port of
``ransac_tpu.pipelines.sfm_demo``): ``python -m ransac_tpu_torch.cli sfm
--demo F [--loop]``.

Renders F frames of a 3-D point field from a moving camera, runs the
keyframe front end (``parallel.sharded_frontend.distributed_frontend``:
batched Harris, patch descriptors and consecutive matching), chains the
matches into tracks (``matches_to_tracks``), reconstructs incrementally
(``pipelines.sfm.incremental_sfm``: essential bootstrap, P3P
registration, triangulation, BA every ``ba_every`` frames), re-registers
broken frames and polishes with two rounds of pruning and matrix-free CG
Schur BA; with ``loop=True`` the camera rides a closed circuit and loop
closures feed a Sim(3) pose graph between the polish and a second polish,
committed only if the map keeps at least as many consistent observations.
Reports the front end's frames/s and the similarity-aligned ATE against
the true trajectory.

``device_counts`` defaults, as the JAX function's, to the mesh sizes 1,
2, 4, ... that the ``torch.distributed`` world holds and that divide F
(``[1]`` in one process).  Under torchrun every rank runs the front end at
each mesh size (``parallel.mesh``: a size-n mesh is the first n ranks);
the host SfM, the polish and the report run on the primary rank alone,
and the other ranks return after the front end.  Where fewer than 3
windowed-pass frames exist, the rescue line prints ``nan`` as the JAX
package does.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from ransac_tpu_torch.utils.config import BundleAdjustConfig, RansacConfig, TwoViewConfig
from ransac_tpu_torch.utils.logging import get_logger

log = get_logger("sfm_demo")


def synth_trajectory_frames(F: int = 64, H: int = 160, W: int = 200, n_pts: int = 600,
                            seed: int = 0, loop: bool = False):
    """Render F frames of a random 3-D point field (numpy; the JAX
    package's frames bit for bit).  Each point carries a fixed random 5x5
    patch, so Harris and patch descriptors track it across views; depth
    spread gives the bootstrap real parallax.

    Line (default): R = I, the camera translates along +x with a mild
    sway, f = 0.9 W.  ``loop=True``: the camera rides a circle in the x-z
    plane looking radially out at an annulus of 3.5 n_pts points (f = 0.72
    W) and returns to the start, so the last frames re-observe the first
    frames' features while drift accumulates freely until the revisit.

    Returns ``(images [F,H,W] f32, K [3,3], t_gt [F,3] camera centers,
    X_gt [n_pts,3])``."""
    rng = np.random.default_rng(seed)
    f_pix = 0.9 * W
    K = np.array([[f_pix, 0.0, W / 2.0], [0.0, f_pix, H / 2.0], [0.0, 0.0, 1.0]])
    if loop:
        th = 2.0 * np.pi * np.arange(F) / F
        r_c = 0.045 * F / (2.0 * np.pi)      # per-frame arc ~ 0.045
        f_pix = 0.72 * W
        K = np.array([[f_pix, 0.0, W / 2.0], [0.0, f_pix, H / 2.0], [0.0, 0.0, 1.0]])
        n_pts = int(n_pts * 3.5)
        centers = np.stack([r_c * np.sin(th), 0.01 * np.cos(np.arange(F) * 0.3),
                            r_c * np.cos(th)], axis=1)
        rho = rng.uniform(r_c + 4.0, r_c + 9.0, n_pts)
        phi = rng.uniform(0.0, 2.0 * np.pi, n_pts)
        yy = rng.uniform(-0.55, 0.55, n_pts) * 6.5 * H / (W * 0.72)
        X = np.stack([rho * np.sin(phi), yy, rho * np.cos(phi)], axis=1)
        pats = rng.uniform(0.5, 2.0, (n_pts, 5, 5))
        pats *= rng.choice([-1.0, 1.0], (n_pts, 1, 1))
        imgs = rng.normal(0.0, 0.03, (F, H, W)).astype(np.float32)
        Rs = np.zeros((F, 3, 3))
        for f in range(F):
            c, s = np.cos(th[f]), np.sin(th[f])
            # camera axes in world: x = tangent, y = up, z = outward.
            Rs[f] = np.stack([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])
            p = (X - centers[f]) @ Rs[f].T
            front = p[:, 2] > 0.5
            uv = p[front] @ K.T
            uv = uv[:, :2] / uv[:, 2:]
            ui = np.round(uv[:, 0]).astype(int)
            vi = np.round(uv[:, 1]).astype(int)
            ok = (ui >= 3) & (ui < W - 3) & (vi >= 3) & (vi < H - 3)
            for j, pi in zip(np.nonzero(ok)[0], np.nonzero(front)[0][ok]):
                imgs[f, vi[j] - 2:vi[j] + 3, ui[j] - 2:ui[j] + 3] += pats[pi]
        return imgs, K, centers, X
    step = 0.045
    centers = np.stack([step * np.arange(F), 0.02 * np.sin(np.arange(F) * 0.4),
                        0.01 * np.cos(np.arange(F) * 0.3)], axis=1)
    span_x = 4.0 + step * F
    X = np.stack([rng.uniform(-2.0, -2.0 + span_x + 4.0, n_pts),
                  rng.uniform(-1.6, 1.6, n_pts), rng.uniform(4.0, 9.0, n_pts)], axis=1)
    pats = rng.uniform(0.5, 2.0, (n_pts, 5, 5))
    pats *= rng.choice([-1.0, 1.0], (n_pts, 1, 1))
    imgs = rng.normal(0.0, 0.03, (F, H, W)).astype(np.float32)
    for f in range(F):
        p = X - centers[f]
        uv = (K @ p.T).T
        uv = uv[:, :2] / uv[:, 2:]
        ui = np.round(uv[:, 0]).astype(int)
        vi = np.round(uv[:, 1]).astype(int)
        ok = (ui >= 3) & (ui < W - 3) & (vi >= 3) & (vi < H - 3)
        for j in np.nonzero(ok)[0]:
            imgs[f, vi[j] - 2:vi[j] + 3, ui[j] - 2:ui[j] + 3] += pats[j]
    return imgs, K, centers, X


def _umeyama_ate(est: np.ndarray, gt: np.ndarray) -> float:
    """RMS trajectory error after similarity (Sim(3)) alignment: the
    monocular ATE (gauge and scale are unobservable)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    e, g = est - mu_e, gt - mu_g
    U, S, Vt = np.linalg.svd(g.T @ e / len(est))
    D = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    var_e = (e ** 2).sum() / len(est)
    s = np.trace(np.diag(S) @ D) / max(var_e, 1e-30)
    res = g - s * e @ R.T
    return float(np.sqrt((res ** 2).sum(1).mean()))


def _cam_centers(poses: dict) -> np.ndarray:
    from ransac_tpu_torch.pipelines.sfm import _np_rodrigues

    return np.stack([-_np_rodrigues(poses[f][:3]).T @ poses[f][3:] for f in sorted(poses)])


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_frontend(images, mesh, cfg, iters: int = 3):
    """(frames/s, output) of the front end on the mesh (warm, by the host
    clock between device synchronizes, its first output read back; the
    slowest member's time).  Ranks outside the mesh wait and get no
    output."""
    from ransac_tpu_torch.parallel.mesh import world_max
    from ransac_tpu_torch.parallel.sharded_frontend import distributed_frontend

    out, dt = None, 0.0
    if mesh.member:
        out = distributed_frontend(images, mesh, cfg)
        _sync(mesh.device)
        out[0].cpu()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = distributed_frontend(images, mesh, cfg)
        _sync(mesh.device)
        out[0].cpu()
        dt = (time.perf_counter() - t0) / iters
    return images.shape[0] / world_max(dt, mesh.device), out


def run_demo(frames: int = 64, seed: int = 0, device_counts=None, ba_every: int = 8,
             loop: bool = False, device="cuda") -> dict:
    """Run the demo on ``device``; returns the JAX package's metrics dict
    (plus ``slots``: the final CG problem's live slots, all slots, D and
    P) and prints its report.

    ``loop=True``: closed-circuit trajectory, loop-closure detection and a
    Sim(3) pose graph between the incremental SfM and the final BA,
    reporting ATE with and without the pose graph."""
    from ransac_tpu_torch.ba.schur_cg import bundle_adjust_cg, from_ba_problem
    from ransac_tpu_torch.parallel.mesh import make_mesh, world_rank, world_size
    from ransac_tpu_torch.parallel.sharded_frontend import matches_to_tracks
    from ransac_tpu_torch.pipelines.loop_closure import require_device
    from ransac_tpu_torch.pipelines.sfm import (incremental_sfm, prune_observations,
                                                reregister_outlier_frames)

    device = require_device(device)
    t_all = time.perf_counter()
    # The circuit's rotating view kills tracks faster than lateral travel:
    # loop mode renders 320 x 400 frames with a 768-keypoint budget.
    if loop:
        imgs_np, K, t_gt, _ = synth_trajectory_frames(F=frames, H=320, W=400, n_pts=900,
                                                      seed=seed, loop=True)
    else:
        imgs_np, K, t_gt, _ = synth_trajectory_frames(F=frames, seed=seed)
    images = torch.from_numpy(imgs_np).to(device)
    cfg = TwoViewConfig(max_keypoints=768 if loop else 256, nms_radius=3, patch_size=8)
    platform = device.type
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32)
                         if d <= world_size() and frames % d == 0]

    # --- 1. the keyframe front end, frames/s at N devices.
    rows = []
    out = None
    base_fps = None
    for nd in device_counts:
        mesh = make_mesh(nd, data=nd, model=1, device=device)
        fps, out = _time_frontend(images, mesh, cfg)
        if base_fps is None:
            base_fps = fps
        rows.append((nd, fps, fps * device_counts[0] / (base_fps * nd)))
    if world_rank() != 0:
        return {"frames": frames, "frontend": rows, "platform": platform}
    xy_t, valid_t, desc_t, idx2, mvalid = out
    xy, valid = xy_t.cpu().numpy(), valid_t.cpu().numpy()

    # --- 2. track chaining (host).
    t0 = time.perf_counter()
    tracks = matches_to_tracks(xy, idx2, mvalid, min_len=3)
    t_tracks = time.perf_counter() - t0
    n_obs = len(tracks)
    n_tracks = len({t for _, t in tracks})

    # --- 3. incremental SfM over the whole trajectory.
    t0 = time.perf_counter()
    m = incremental_sfm(
        tracks, K, list(range(frames)),
        ransac_cfg=RansacConfig(threshold=4.0, num_hypotheses=2048, exhaustive=False),
        ba_cfg=BundleAdjustConfig(max_iters=8), ba_every=ba_every, seed=seed,
        # Wide-pair bootstrap: consecutive-frame parallax at this motion is
        # below pixel noise.
        bootstrap_stride=min(8, frames - 1),
        keypoints=(xy, valid), device=device)
    t_sfm = time.perf_counter() - t0

    # --- 4. re-register broken frames, then two rounds of pruning and
    # matrix-free CG Schur BA.
    n_rereg = reregister_outlier_frames(m, tracks, device=device)
    if n_rereg:
        log.info("re-registered %d broken frames before polish", n_rereg)

    def _polish(mm):
        p, frames_l, track_ids = mm.as_ba_problem(tracks)
        p, n_drop = prune_observations(p, max_px=8.0)
        res = bundle_adjust_cg(from_ba_problem(p), BundleAdjustConfig(max_iters=24),
                               cg_iters=32, device=device)
        p = p._replace(cameras=res.cameras, points=res.points)
        p, n_drop2 = prune_observations(p, max_px=4.0)
        sp = from_ba_problem(p)
        res = bundle_adjust_cg(sp, BundleAdjustConfig(max_iters=24), cg_iters=32,
                               device=device)
        _sync(device)
        mm.apply_ba(res, frames_l, track_ids)
        return res, sp, n_drop + n_drop2, frames_l, track_ids

    t0 = time.perf_counter()
    res, sp, n_drop, frames_l, track_ids = _polish(m)
    t_ba = time.perf_counter() - t0

    # --- 4b. (loop) the pose graph on the polished trajectory, a Huber
    # smoothing BA and a second polish; committed only if the map keeps at
    # least as many self-consistent observations.
    n_loop_edges = 0
    ate_no_pg = None
    pg_accepted = False
    t_pg = 0.0
    if loop:
        from ransac_tpu_torch.pipelines.loop_closure import apply_pose_graph

        ate_no_pg = _umeyama_ate(_cam_centers(m.camera_poses), t_gt[sorted(m.camera_poses)])
        m_no_pg = copy.deepcopy(m)
        res0, sp0 = res, sp
        slots0 = int((sp.slot_w > 0).sum())
        t0 = time.perf_counter()
        n_loop_edges = apply_pose_graph(
            m, tracks, K, ransac_cfg=RansacConfig(threshold=4.0, num_hypotheses=4096),
            min_gap=max(frames // 4, 12), min_shared=20, seed=seed + 17,
            frontend=(xy, valid_t, desc_t), device=device)
        if n_loop_edges:
            ate_pg_raw = _umeyama_ate(_cam_centers(m.camera_poses),
                                      t_gt[sorted(m.camera_poses)])
            log.info("raw PGO trajectory ATE: %.4f (was %.4f)", ate_pg_raw, ate_no_pg)
            p0, frames_l0, track_ids0 = m.as_ba_problem(tracks)
            res_s = bundle_adjust_cg(from_ba_problem(p0),
                                     BundleAdjustConfig(max_iters=24, huber_scale=4.0),
                                     cg_iters=32, device=device)
            m.apply_ba(res_s, frames_l0, track_ids0)
            res, sp, n_drop2, frames_l, track_ids = _polish(m)
            slots1 = int((sp.slot_w > 0).sum())
            pg_accepted = slots1 >= slots0
            if not pg_accepted:
                log.info("pose graph NOT committed: map consistency dropped (%d -> %d "
                         "retained obs)", slots0, slots1)
                m = m_no_pg
                res, sp = res0, sp0
        t_pg = time.perf_counter() - t0

    n_reg = len(m.camera_poses)
    ate = _umeyama_ate(_cam_centers(m.camera_poses), t_gt[sorted(m.camera_poses)])
    baseline = float(np.linalg.norm(t_gt[-1] - t_gt[0]))
    if loop:
        # A closed circuit ends where it starts: normalize by path length.
        baseline = float(np.sum(np.linalg.norm(np.diff(t_gt, axis=0), axis=1)))
    t_total = time.perf_counter() - t_all

    lines = [f"multi-frame SLAM demo: {frames} frames, {n_tracks} tracks / {n_obs} "
             f"observations", f"{'devices':>8} {'mesh':>12} {'frames/s':>10} {'eff':>6}"]
    for nd, fps, eff in rows:
        lines.append(f"{nd:>8} {f'data={nd}':>12} {fps:>10.1f} {eff * 100:>5.0f}%")
    lines.append(f"track chaining: {n_obs} obs in {t_tracks * 1e3:.1f} ms "
                 f"({n_obs / max(t_tracks, 1e-9) / 1e6:.2f} M obs/s, vectorized)")
    lines.append(f"incremental SfM: {n_reg}/{frames} frames registered in {t_sfm:.2f} s "
                 f"({n_reg / max(t_sfm, 1e-9):.1f} frames/s, BA every {ba_every})")
    ate_core = None
    if m.rescued_frames:
        core = sorted(set(m.camera_poses) - m.rescued_frames)
        if len(core) >= 3:
            ate_core = _umeyama_ate(_cam_centers({f: m.camera_poses[f] for f in core}),
                                    t_gt[core])
        lines.append(
            f"  rescue stage registered {len(m.rescued_frames)} stalled frames (two-view "
            f"continuation); windowed-pass subset ATE "
            f"{ate_core if ate_core is not None else float('nan'):.4f} over {len(core)} frames")
    slot_w = sp.slot_w.cpu().numpy()
    n_slots = int((slot_w > 0).sum())
    # slot_cost is 0.5 sum(du^2 + dv^2): the RMS pixel error of an
    # observation is sqrt(2 cost / n_obs).
    cost = float(res.cost)
    rms_px = float(np.sqrt(2.0 * cost / max(n_slots, 1)))
    lines.append(f"final CG-Schur BA: {len(frames_l)} cams / {len(track_ids)} pts / "
                 f"{n_slots} slots ({n_drop} outlier obs pruned) in {t_ba:.2f} s  cost "
                 f"{cost:.4g} (~{rms_px:.2f} px RMS)")
    if loop and ate_no_pg is not None:
        verdict = ("committed" if pg_accepted else
                   ("no closure edge accepted — uncorrected result kept"
                    if n_loop_edges == 0 else
                    "rejected by closure verification — uncorrected result kept"))
        lines.append(
            f"pose graph ({n_loop_edges} loop edges, {t_pg:.2f} s, {verdict}): ATE "
            f"{ate_no_pg:.4f} -> {ate:.4f} ({100 * ate_no_pg / max(baseline, 1e-9):.2f}% -> "
            f"{100 * ate / max(baseline, 1e-9):.2f}% of the {baseline:.2f}-unit circuit)")
    else:
        lines.append(f"ATE (sim3-aligned): {ate:.4f} ({100 * ate / max(baseline, 1e-9):.2f}% "
                     f"of the {baseline:.2f}-unit trajectory)")
    lines.append(f"total wall time: {t_total:.1f} s")
    report = "\n".join(lines)
    print(report, flush=True)
    return {
        "frames": frames, "registered": n_reg, "tracks": n_tracks, "observations": n_obs,
        "frontend": rows, "t_tracks_s": t_tracks, "t_sfm_s": t_sfm, "t_ba_s": t_ba,
        "ba_cost": cost, "ate": ate, "ate_frac": ate / max(baseline, 1e-9),
        "rescued": len(m.rescued_frames), "ate_core": ate_core,
        "ate_no_posegraph": ate_no_pg, "loop_edges": n_loop_edges,
        "posegraph_committed": pg_accepted if loop else None,
        "platform": platform, "report": report,
        "slots": {"live": n_slots, "total": int(slot_w.size), "D": int(slot_w.shape[0]),
                  "P": int(slot_w.shape[1])},
    }
