"""Loop-closure detection and pose-graph construction for incremental SfM
(port of ``ransac_tpu.pipelines.loop_closure``).

- **Covisibility loop detection** (``loop_closure_pairs``): frame pairs
  far apart in time (``j - i >= min_gap``) that share many tracks, from
  the [F, T] incidence matrix's Gram matrix.
- **Appearance loop detection** (``detect_closures_appearance``): every
  candidate pair's descriptors matched in ONE batched mutual-NN call.
- **The relative similarity of a loop pair** (``closure_edge``): rotation
  from essential RANSAC on the pair's pixel matches (the fused large-pool
  8-point sweep, kernel row 8, on a CUDA device; the stage-wise engine on
  the CPU), relative scale from the median of pairwise-distance ratios
  between matched region-local 3-D points, translation direction from the
  essential decomposition and its magnitude as a robust 1-D median.
- **The pose graph** (``build_pose_graph``): odometry edges between
  consecutive registered frames plus the closure edges, optimized over
  Sim(3) (``ba.posegraph.optimize_pose_graph_sim3``) with JAX's gate on
  the optimized scale field (``apply_pose_graph``), map points carried by
  their anchor frame's correction, and the tracks proved equal by the
  closures fused (``fuse_tracks``).

Host orchestration is numpy; the device steps run on ``device`` (default
``cuda``; asking for CUDA where there is none raises).  Closure anchors
join on exact float-uv tuple keys, as the JAX package does (a known defect
of the reference: a keypoint-index join would be exact).
"""

from __future__ import annotations

import numpy as np
import torch

from ransac_tpu_torch.ba.bundle import host
from ransac_tpu_torch.ba.posegraph import PoseGraphSim3, relative
from ransac_tpu_torch.utils.config import RansacConfig
from ransac_tpu_torch.utils.logging import get_logger

log = get_logger("loop_closure")


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; CUDA where there is none raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: CUDA is not available")
    return device


def loop_closure_pairs(tracks: dict, frames: list[int], min_gap: int = 16,
                       min_shared: int = 24, max_pairs: int = 4) -> list[tuple[int, int]]:
    """Candidate loop pairs from track covisibility.

    The [F, T] binary incidence matrix's Gram matrix counts the tracks
    every frame pair shares; returns up to ``max_pairs`` pairs with ``j - i
    >= min_gap`` and at least ``min_shared`` shared tracks, by count,
    greedily skipping pairs within ``min_gap / 2`` of a chosen one (one
    closure per revisit region)."""
    fidx = {f: k for k, f in enumerate(frames)}
    tids = sorted({t for _, t in tracks})
    tidx = {t: k for k, t in enumerate(tids)}
    inc = np.zeros((len(frames), len(tids)), np.float32)
    for (f, t) in tracks:
        if f in fidx:
            inc[fidx[f], tidx[t]] = 1.0
    shared = inc @ inc.T                                 # [F, F]
    cand = []
    F = len(frames)
    for a in range(F):
        for b in range(a + min_gap, F):
            if shared[a, b] >= min_shared:
                cand.append((int(shared[a, b]), a, b))
    cand.sort(reverse=True)
    chosen: list[tuple[int, int]] = []
    for cnt, a, b in cand:
        if len(chosen) >= max_pairs:
            break
        if any(abs(a - ca) < min_gap // 2 and abs(b - cb) < min_gap // 2
               for ca, cb in chosen):
            continue
        chosen.append((a, b))
        log.info("loop candidate: frames %d-%d share %d tracks", frames[a], frames[b], cnt)
    return [(frames[a], frames[b]) for a, b in chosen]


def detect_closures_appearance(xy, valid, desc, min_gap: int = 16, min_matches: int = 24,
                               stride: int = 2, max_pairs: int = 4, ratio: float = 0.9):
    """Place recognition by descriptor matching of far frame pairs (no track
    id survives a full revisit, so closures are found by appearance).  All
    candidate pairs (``j - i >= min_gap``, both subsampled by ``stride``)
    run as ONE batched ``mutual_nn_match`` on the descriptors' device.
    Returns up to ``max_pairs`` tuples ``(fi, fj, uv_i [M,2], uv_j [M,2])``
    by match count, one per revisit region."""
    from ransac_tpu_torch.features.match import mutual_nn_match

    desc = torch.as_tensor(desc)
    valid = torch.as_tensor(valid)
    F = int(desc.shape[0])
    cands = [(a, b) for a in range(0, F, stride) for b in range(a + min_gap, F, stride)]
    if not cands:
        return []
    ia = torch.tensor([a for a, _ in cands], device=desc.device)
    ib = torch.tensor([b for _, b in cands], device=desc.device)
    mt = mutual_nn_match(desc[ia], desc[ib], valid[ia], valid[ib], ratio)
    packed = host(torch.cat([mt.idx2, mt.valid.to(mt.idx2.dtype)], 1))
    K = desc.shape[1]
    idx2, mv = packed[:, :K], packed[:, K:].astype(bool)
    counts = mv.sum(-1)
    xy = host(xy)
    order = np.argsort(-counts)
    out = []
    for k in order:
        if counts[k] < min_matches or len(out) >= max_pairs:
            break
        a, b = cands[k]
        if any(abs(a - fa) < min_gap // 2 and abs(b - fb) < min_gap // 2
               for fa, fb, _, _ in out):
            continue
        sel = mv[k]
        log.info("appearance closure: frames %d-%d, %d matches", a, b, int(counts[k]))
        out.append((a, b, xy[a][sel], xy[b][idx2[k][sel]]))
    return out


def _region_points(m, tracks, tids, f0: int, window: int, max_px: float = 3.0,
                   device="cuda") -> dict:
    """Triangulate each track in ``tids`` from its registered observations
    within ``window`` frames of ``f0`` (the widest such pair, gated), so the
    points live in the f0 region's own map scale; ``m.points`` is not read
    (a track spanning the loop must give a different point on each side).
    Each track tries its 3 widest pairs in turn (a broken pose in the
    window fakes the widest baseline and fails every gate); an attempt's
    pairs are triangulated in one device call."""
    from ransac_tpu_torch.pipelines.sfm import _cam_center, _triangulate_tracks_batched

    need_set = {t for t in tids if t is not None}
    if not need_set:
        return {}
    obs_by_track: dict = {}
    for (g, t) in tracks:
        if t in need_set and g in m.camera_poses and abs(g - f0) <= window:
            obs_by_track.setdefault(t, []).append(g)
    centers = {g: _cam_center(m.camera_poses[g]) for gs in obs_by_track.values() for g in gs}
    cand: dict = {}
    for t, gs in obs_by_track.items():
        gs_s = sorted(set(gs))
        if len(gs_s) < 2:
            continue
        C = np.stack([centers[g] for g in gs_s])
        d2 = np.sum((C[:, None] - C[None, :]) ** 2, -1)
        iu = np.triu_indices(len(gs_s), 1)
        order = np.argsort(-d2[iu])
        prs = [tuple(sorted((gs_s[iu[0][k]], gs_s[iu[1][k]])))
               for k in order[:3] if d2[iu][k] > 0]
        if prs:
            cand[t] = prs
    Kt = torch.tensor(np.asarray(m.K), dtype=torch.float32, device=device)
    gate_n = max_px / float(np.asarray(m.K)[0, 0])
    out: dict = {}
    pending = dict(cand)
    for attempt in range(3):
        assign = {t: prs[attempt] for t, prs in pending.items() if attempt < len(prs)}
        if not assign:
            break
        got = _triangulate_tracks_batched(m, tracks, assign, Kt, gate_n, min_angle_deg=0.5)
        out.update(got)
        pending = {t: pending[t] for t in assign if t not in got}
    return out


def _pairwise_scale(A: np.ndarray, B: np.ndarray, max_pairs: int = 4000, seed: int = 0):
    """Robust relative scale between two matched 3-D point sets: the median
    of the pairwise-distance ratios |B_i - B_j| / |A_i - A_j| over random
    index pairs (independent of rotation and translation; along-ray depth
    noise scatters positions but cancels in the median).  Returns (s,
    mad_log) or (None, None) with < 4 usable pairs."""
    n = len(A)
    if n < 3:
        return None, None
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, 1)
    if len(iu[0]) > max_pairs:
        sel = rng.choice(len(iu[0]), max_pairs, replace=False)
        iu = (iu[0][sel], iu[1][sel])
    da = np.linalg.norm(A[iu[0]] - A[iu[1]], axis=1)
    db = np.linalg.norm(B[iu[0]] - B[iu[1]], axis=1)
    ok = (da > 1e-9) & (db > 1e-9)
    if ok.sum() < 4:
        return None, None
    logr = np.log(db[ok] / da[ok])
    med = float(np.median(logr))
    mad = float(np.median(np.abs(logr - med)))
    return float(np.exp(med)), mad


def _essential_pose(x1p, x2p, K, cfg: RansacConfig, seed: int, device):
    """Essential RANSAC on pixel matches and the pose recovered from it:
    (R [3,3], t [3], n_cheiral) on the host.  The fused sweep (row 8) on a
    CUDA device for pools up to 1024, the stage-wise engine elsewhere."""
    from ransac_tpu_torch.models import ransac as ransac_mod
    from ransac_tpu_torch.ops import epipolar
    from ransac_tpu_torch.ops.projection import normalize_pixels
    from ransac_tpu_torch.pipelines.sfm import default_engine

    Kt = torch.tensor(np.asarray(K), dtype=torch.float32, device=device)
    x1 = normalize_pixels(torch.tensor(np.asarray(x1p), dtype=torch.float32, device=device), Kt)
    x2 = normalize_pixels(torch.tensor(np.asarray(x2p), dtype=torch.float32, device=device), Kt)
    w = torch.ones(len(x1p), dtype=torch.float32, device=device)
    e_cfg = RansacConfig(threshold=(cfg.threshold / float(np.asarray(K)[0, 0])) ** 2,
                         num_hypotheses=cfg.num_hypotheses, exhaustive=False,
                         selection=cfg.selection)
    if default_engine(device) == "sweep" and len(x1p) <= 1024:
        eres = ransac_mod.ransac_essential_sweep(x1, x2, w, e_cfg, seed)
    else:
        eres = ransac_mod.ransac_essential(x1, x2, w, e_cfg, seed)
    R, t, _, n = epipolar.recover_pose(eres.model, x1, x2,
                                       eres.inlier_mask.to(torch.float32))
    packed = host(torch.cat([R.reshape(-1), t, n[None].to(R.dtype)])).astype(np.float64)
    return packed[:9].reshape(3, 3), packed[9:12], int(packed[12])


def closure_edge(tracks: dict, m, K, fi: int, fj: int, ransac_cfg: RansacConfig | None = None,
                 seed: int = 17, uv_pair=None, window: int | None = None, device="cuda"):
    """The relative similarity Z (j <- i) of a loop pair, each component
    from its best-conditioned domain:

    - rotation from essential RANSAC on the pair's own pixel matches;
    - relative scale s = s_j / s_i from the median of pairwise-distance
      ratios between matched region-local 3-D points (``_pairwise_scale``);
    - translation direction from the essential decomposition, magnitude as
      the median of the 3-D residuals along it.

    Correspondences come from shared tracks or from appearance matches
    (``uv_pair``, joined to track ids on exact uv keys); each side's 3-D
    points are region-local (map points that reproject within 4 px at the
    side's frame, else windowed triangulation).  Returns ``(z7 [7],
    n_inliers, fuse_pairs)`` or ``None``."""
    from ransac_tpu_torch.pipelines.sfm import _np_log_so3, _np_rodrigues

    device = require_device(device)
    if uv_pair is None:
        common = sorted(t for t in {t for f, t in tracks if f == fi} if (fj, t) in tracks)
        pairs = [(t, t) for t in common]
        if len(pairs) < 8:
            log.info("closure %d-%d REJECTED: %d matched tracks", fi, fj, len(pairs))
            return None
        x1p = np.stack([tracks[(fi, t)] for t in common])
        x2p = np.stack([tracks[(fj, t)] for t in common])
    else:
        x1p, x2p = uv_pair
        uv2tid_i = {tuple(np.asarray(uv)): t for (f, t), uv in tracks.items() if f == fi}
        uv2tid_j = {tuple(np.asarray(uv)): t for (f, t), uv in tracks.items() if f == fj}
        pairs = [(uv2tid_i.get(tuple(a)), uv2tid_j.get(tuple(b))) for a, b in zip(x1p, x2p)]
        pairs = [(a, b) for a, b in pairs if a is not None and b is not None]
        if len(pairs) < 8 or len(x1p) < 16:
            log.info("closure %d-%d REJECTED: %d matched tracks", fi, fj, len(pairs))
            return None

    # --- rotation: essential RANSAC on the pixel matches.
    cfg = ransac_cfg or RansacConfig(threshold=4.0, num_hypotheses=4096)
    R, t_e, n_e = _essential_pose(x1p, x2p, K, cfg, seed, device)
    if n_e < 10:
        log.info("closure %d-%d REJECTED: %d cheiral essential inliers", fi, fj, n_e)
        return None

    # --- region-local 3-D points per side.
    if window is None:
        window = 8

    def region(tids, f0):
        return _region_points(m, tracks, tids, f0, window, device=device)

    def side_points(tids, f0):
        """Per-track 3-D points of one side in its own region-local scale:
        healthy map points, windowed triangulation for the rest."""
        pose = m.camera_poses[f0]
        Ra = _np_rodrigues(pose[:3])
        Kn = np.asarray(K, np.float64)
        out: dict = {}
        rest = []
        for t in {t for t in tids if t is not None}:
            X = m.points.get(t)
            uv_obs = tracks.get((f0, t))
            if X is not None and uv_obs is not None:
                xc = Ra @ X + pose[3:]
                if xc[2] > 1e-6:
                    pr = Kn[:2, :2] @ (xc[:2] / xc[2]) + Kn[:2, 2]
                    if np.linalg.norm(pr - np.asarray(uv_obs, np.float64)) < 4.0:
                        out[t] = X
                        continue
            rest.append(t)
        out.update(region(rest, f0))
        return out

    spanning = {a for a, b in pairs if a == b}
    Xi = side_points([a for a, _ in pairs if a not in spanning], fi)
    Xi.update(region(sorted(spanning), fi))
    Xj = side_points([b for _, b in pairs if b not in spanning], fj)
    Xj.update(region(sorted(spanning), fj))
    pose_i = m.camera_poses[fi]
    pose_j = m.camera_poses[fj]
    Ri = _np_rodrigues(pose_i[:3])
    Rj = _np_rodrigues(pose_j[:3])
    A, B, kept = [], [], []
    for a, b in pairs:
        if a not in Xi or b not in Xj:
            continue
        xa = Ri @ Xi[a] + pose_i[3:]
        xb = Rj @ Xj[b] + pose_j[3:]
        if xa[2] <= 1e-6 or xb[2] <= 1e-6:
            continue
        A.append(xa)
        B.append(xb)
        kept.append((a, b))
    if len(A) < 8:
        log.info("closure %d-%d REJECTED: %d/%d region-point pairs", fi, fj, len(A), len(pairs))
        return None
    A = np.stack(A)
    B = np.stack(B)

    # --- scale + translation, robust.
    s, mad_log = _pairwise_scale(A, B, seed=seed)
    if s is None or not (0.02 < s < 50.0) or mad_log > 0.6:
        log.info("closure %d-%d REJECTED: scale %s (mad_log %s, %d pairs)", fi, fj, s,
                 mad_log, len(A))
        return None
    t_dir = np.asarray(t_e, np.float64).reshape(3)
    t_dir /= max(np.linalg.norm(t_dir), 1e-12)
    resid = B - s * (A @ R.T)
    t_vec = float(np.median(resid @ t_dir)) * t_dir
    err = (np.linalg.norm(resid - t_vec, axis=1)
           / np.maximum(np.linalg.norm(B, axis=1), 1e-9))
    inl = err < 0.25
    n = int(inl.sum())
    if n < 6:
        log.info("closure %d-%d REJECTED: %d/%d Sim(3)-consistent pairs", fi, fj, n, len(A))
        return None
    t_vec = float(np.median(resid[inl] @ t_dir)) * t_dir
    z7 = np.concatenate([_np_log_so3(R), t_vec, [np.log(s)]])
    log.info("closure %d-%d: %d essential inliers, %d/%d 3-D pairs consistent, rel scale "
             "%.3f (mad_log %.2f)", fi, fj, n_e, n, len(A), s, mad_log)
    fuse = [(a, b) for k, (a, b) in enumerate(kept) if inl[k] and a != b]
    return z7, n, fuse


def build_pose_graph(m, tracks: dict, K, closure_pairs: list, ransac_cfg=None,
                     loop_weight: float = 2.0, seed: int = 17, device="cuda"):
    """Sim(3) pose graph over the registered frames: odometry edges between
    consecutive registered frames (their relative transform from the
    incremental estimates, scale 1 and scale weight 0: monocular odometry
    does not observe scale) and the measured closure edges (weight
    ``loop_weight``, scale weight 1).  Returns ``(graph, frame_list,
    n_loop_edges, fuse_pairs)``: the track merges the accepted closures'
    inlier matches prove."""
    frames = sorted(m.camera_poses)
    fidx = {f: k for k, f in enumerate(frames)}
    poses6 = np.stack([m.camera_poses[f] for f in frames])
    poses7 = np.concatenate([poses6, np.zeros((len(frames), 1))], axis=1).astype(np.float32)
    p32 = torch.tensor(poses6, dtype=torch.float32)
    odo = relative(p32[:-1], p32[1:]).double().numpy()
    ei = list(range(len(frames) - 1))
    ej = list(range(1, len(frames)))
    ez = [np.concatenate([z, [0.0]]) for z in odo]
    ew = [1.0] * len(ei)
    esw = [0.0] * len(ei)
    n_loop = 0
    fuse_pairs: list = []
    for pair in closure_pairs:
        fi, fj = pair[0], pair[1]
        uv_pair = (pair[2], pair[3]) if len(pair) > 2 else None
        if fi not in fidx or fj not in fidx:
            continue
        out = closure_edge(tracks, m, K, fi, fj, ransac_cfg, seed=seed + n_loop,
                           uv_pair=uv_pair, device=device)
        if out is None:
            continue
        z7, _n, fuse = out
        fuse_pairs.extend(fuse)
        ei.append(fidx[fi])
        ej.append(fidx[fj])
        ez.append(z7)
        ew.append(loop_weight)
        esw.append(1.0)
        n_loop += 1
    g = PoseGraphSim3(
        poses=poses7, edge_i=np.array(ei, np.int32), edge_j=np.array(ej, np.int32),
        edge_z=np.stack(ez).astype(np.float32), edge_w=np.array(ew, np.float32),
        edge_sw=np.array(esw, np.float32))
    return g, frames, n_loop, fuse_pairs


def fuse_tracks(m, tracks: dict, fuse_pairs) -> int:
    """Merge track identities proved equal by loop-closure inlier matches
    (union-find over the pairs).  Every observation of a merged track is
    rewritten to the root id in place (the first observation wins a frame
    both tracks see), and merged map points are dropped.  Returns the
    number of merges."""
    parent: dict = {}

    def find(x):
        while parent.get(x, x) != x:
            parent[x] = parent.get(parent[x], parent[x])
            x = parent[x]
        return x

    n_groups = 0
    for a, b in fuse_pairs:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra
            n_groups += 1
    if not n_groups:
        return 0
    moved = [(f, t) for (f, t) in tracks if find(t) != t]
    for (f, t) in moved:
        uv = tracks.pop((f, t))
        key = (f, find(t))
        if key not in tracks:
            tracks[key] = uv
    for t in {t for _, t in moved}:
        m.points.pop(t, None)
    log.info("loop fusion: %d track merges (%d observations rewritten)", n_groups, len(moved))
    return n_groups


def apply_pose_graph(m, tracks: dict, K, ransac_cfg: RansacConfig | None = None,
                     min_gap: int = 16, min_shared: int = 24, seed: int = 17,
                     frontend=None, device="cuda") -> int:
    """Detect closures, optimize the Sim(3) pose graph on ``device`` and
    write the corrected poses back into the map, carrying each map point
    by its anchor frame's (first observing frame's) similarity correction
    and fusing the closures' tracks.  Returns the number of loop edges used
    (0: the map is untouched).

    ``frontend = (xy, valid, desc)`` adds appearance closures
    (``detect_closures_appearance``) to the covisibility ones."""
    from ransac_tpu_torch.ba.posegraph import optimize_pose_graph_sim3, sim3_to_se3
    from ransac_tpu_torch.pipelines.sfm import _np_rodrigues

    device = require_device(device)
    frames = sorted(m.camera_poses)
    pairs: list = loop_closure_pairs(tracks, frames, min_gap=min_gap, min_shared=min_shared)
    if frontend is not None:
        xy, valid, desc = frontend
        app = detect_closures_appearance(xy, valid, desc, min_gap=min_gap,
                                         min_matches=max(min_shared, 16))
        covis = {(a, b) for a, b in pairs}
        for fi, fj, uv_i, uv_j in app:
            if (fi, fj) not in covis:
                pairs.append((fi, fj, uv_i, uv_j))
    if not pairs:
        return 0
    g, frame_list, n_loop, fuse_pairs = build_pose_graph(m, tracks, K, pairs, ransac_cfg,
                                                         seed=seed, device=device)
    if n_loop == 0:
        return 0
    # 200 passes: a single-closure 64-node graph takes ~150 to converge.
    poses_new, cost, iters = optimize_pose_graph_sim3(g, max_iters=200, device=device)
    out = host(torch.cat([poses_new.reshape(-1), sim3_to_se3(poses_new).reshape(-1),
                          torch.stack([cost, iters.to(cost.dtype)])])).astype(np.float64)
    V = len(frame_list)
    new7 = out[:7 * V].reshape(V, 7)
    poses_np = out[7 * V:13 * V].reshape(V, 6)
    scales = np.exp(new7[:, 6])
    log.info("pose graph (sim3): %d nodes, %d edges (%d loop), cost %.4g (%d iters); node "
             "scales %.3f..%.3f", V, len(g.edge_i), n_loop, out[-2], int(out[-1]),
             float(scales.min()), float(scales.max()))
    # The optimized scale field interpolates the measured closure drifts:
    # an extreme beyond the largest measured |log rel-scale| + ln 2 means
    # the optimizer absorbed odometry noise into scale.
    z_logs = np.abs(np.asarray(g.edge_z[:, 6], np.float64))
    sw = np.asarray(g.edge_sw)
    max_meas = float(z_logs[sw >= 1.0].max()) if (sw >= 1.0).any() else 0.0
    if float(np.abs(np.log(scales)).max()) > max_meas + np.log(2.0):
        log.info("pose graph REJECTED: node scale field %.3f..%.3f exceeds the measured "
                 "closure drift bound (max |log z| %.3f + ln 2)", float(scales.min()),
                 float(scales.max()), max_meas)
        return 0
    poses_old = {f: np.asarray(m.camera_poses[f], np.float64) for f in frame_list}
    for k, f in enumerate(frame_list):
        m.camera_poses[f] = poses_np[k]
    # Map-point transport (ORB-SLAM CorrectLoop): c_new = c_old / s_anchor
    # under the corrected pose keeps each point's camera-frame coordinates.
    fidx_new = {f: k for k, f in enumerate(frame_list)}
    anchor: dict = {}
    for (f, t) in tracks:
        if t in m.points and f in fidx_new:
            a = anchor.get(t)
            if a is None or f < a:
                anchor[t] = f
    Rs_new = {f: _np_rodrigues(poses_np[fidx_new[f]][:3]) for f in set(anchor.values())}
    Rs_old = {f: _np_rodrigues(poses_old[f][:3]) for f in set(anchor.values())}
    for t, f in anchor.items():
        k = fidx_new[f]
        s_f = float(np.exp(new7[k, 6]))
        c_old = Rs_old[f] @ m.points[t] + poses_old[f][3:]
        m.points[t] = Rs_new[f].T @ (c_old - new7[k, 3:6]) / s_f
    log.info("transported %d map points by their anchor-frame Sim(3) corrections",
             len(anchor))
    fuse_tracks(m, tracks, fuse_pairs)
    return n_loop
