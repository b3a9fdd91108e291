"""Incremental SfM: two-view bootstrap -> PnP registration -> triangulation
-> bundle adjustment (port of ``ransac_tpu.pipelines.sfm``).

Pipeline (host orchestration over device steps; registration and
triangulation go through the same RANSAC and geometry core as everything
else):

1. initialize from the first two frames (essential RANSAC + cheirality +
   triangulation on known correspondences),
2. for each new frame: PnP-RANSAC against the current map + LM refine,
3. triangulate new correspondences from each track's widest pair of
   registered views,
4. global LM-BA with the dense Schur complement after every window.

The pipeline works on a correspondence table {(frame, track_id): uv} (the
output of a feature front end, or synthetic tracks).  On a CUDA device the
default ``engine`` is "sweep": bootstrap essential RANSAC through the
large-pool 8-point sweep (kernel row 8, pools up to 1024) and registration
through the P3P sweeps (row 5 up to 16 points, row 9 up to 512); larger
pools and the CPU take the stage-wise engine.  Every device step returns
one packed tensor, so it reads back once.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np
import torch

from ransac_tpu_torch.ba.bundle import BAProblem, BAResult, bundle_adjust, host
from ransac_tpu_torch.models import ransac as ransac_mod
from ransac_tpu_torch.ops import epipolar
from ransac_tpu_torch.ops.projection import normalize_pixels
from ransac_tpu_torch.utils.config import BundleAdjustConfig, RansacConfig
from ransac_tpu_torch.utils.logging import get_logger
from ransac_tpu_torch.utils.prng import fold_seed

log = get_logger("sfm")


def _bucket(n: int, minimum: int = 16) -> int:
    """Next power-of-two size >= n (the JAX package's shape buckets, kept so
    that a pool's size, and so its kernel route, is the JAX one).  Padded
    rows carry weight 0 (RANSAC) or are sliced off (triangulation)."""
    return max(minimum, 1 << (max(n, 1) - 1).bit_length())


def _pad_rows(a: np.ndarray, m: int) -> np.ndarray:
    pad = m - a.shape[0]
    if pad <= 0:
        return a
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


def default_engine(device) -> str:
    """"sweep" (the fused kernels) on a CUDA device, "stage" elsewhere."""
    return "sweep" if torch.device(device).type == "cuda" else "stage"


@dataclass
class SfmMap:
    K: np.ndarray
    camera_poses: dict = field(default_factory=dict)   # frame -> [6]
    points: dict = field(default_factory=dict)         # track -> [3]
    # Frames registered by the frame-by-frame rescue stage: callers report
    # trajectory error over the windowed-pass frames and the rescued tail
    # separately, since rescued sections may sit across a motion-prior
    # scale seam.
    rescued_frames: set = field(default_factory=set)

    def as_ba_problem(self, tracks) -> tuple[BAProblem, list, list]:
        """The map's BA problem as host float32 / int32 arrays (the BA
        moves them to its device)."""
        frames = sorted(self.camera_poses)
        track_ids = sorted(self.points)
        fidx = {f: i for i, f in enumerate(frames)}
        tidx = {t: i for i, t in enumerate(track_ids)}
        obs_cam, obs_pt, obs_uv = [], [], []
        for (f, t), uv in tracks.items():
            if f in fidx and t in tidx:
                obs_cam.append(fidx[f])
                obs_pt.append(tidx[t])
                obs_uv.append(uv)
        p = BAProblem(
            cameras=np.stack([self.camera_poses[f] for f in frames]).astype(np.float32),
            points=np.stack([self.points[t] for t in track_ids]).astype(np.float32),
            K=np.asarray(self.K, np.float32),
            obs_cam=np.array(obs_cam, np.int32),
            obs_pt=np.array(obs_pt, np.int32),
            obs_uv=np.array(obs_uv, np.float32).reshape(-1, 2),
            obs_w=np.ones(len(obs_cam), np.float32))
        return p, frames, track_ids

    def apply_ba(self, res, frames, track_ids):
        cams = np.asarray(host(res.cameras), np.float64)
        pts = np.asarray(host(res.points), np.float64)
        for i, f in enumerate(frames):
            self.camera_poses[f] = cams[i]
        for i, t in enumerate(track_ids):
            self.points[t] = pts[i]


# --------------------------------------------------------------------
# Device steps: each returns one packed tensor, read back once.
def _pnp_dispatch(Xw, uv, K, w, key, cfg, use_sweep):
    """ONE packed [13] vector (model 12 + inlier count): the registration
    loop needs both."""
    fn = ransac_mod.ransac_pnp_sweep if use_sweep else ransac_mod.ransac_pnp
    res = fn(Xw, uv, K, w, cfg, key)
    return torch.cat([res.model, res.num_inliers[None].to(res.model.dtype)])


def _essential_dispatch(x1, x2, w, cfg, key, use_sweep):
    """Essential RANSAC and pose recovery, packed as [inlier mask N, R 9,
    t 3, X 3N, n_cheiral 1]; ``_unpack_essential`` splits it on the host."""
    fn = ransac_mod.ransac_essential_sweep if use_sweep else ransac_mod.ransac_essential
    res = fn(x1, x2, w, cfg, key)
    R, t, X, n = epipolar.recover_pose(res.model, x1, x2,
                                       res.inlier_mask.to(torch.float32))
    return torch.cat([res.inlier_mask.to(R.dtype), R.reshape(-1), t, X.reshape(-1),
                      n[None].to(R.dtype)])


def _unpack_essential(packed: np.ndarray, n: int):
    inl = packed[:n] > 0.5
    R = packed[n:n + 9].reshape(3, 3)
    t = packed[n + 9:n + 12]
    X = packed[n + 12:n + 12 + 3 * n].reshape(n, 3)
    return inl, R, t, X, int(packed[-1])


def _essential_inputs(tracks, fa, fb, common, Kt, ransac_cfg, fx):
    """Normalized, bucket-padded correspondences of ``common`` tracks
    between frames ``fa`` and ``fb``, their weights, and the essential
    config (threshold in squared normalized units)."""
    nb = _bucket(len(common))
    dev = Kt.device
    w = torch.tensor(_pad_rows(np.ones(len(common), np.float32), nb), device=dev)
    x1 = normalize_pixels(torch.tensor(_pad_rows(
        np.stack([tracks[(fa, t)] for t in common]), nb), dtype=torch.float32,
        device=dev), Kt)
    x2 = normalize_pixels(torch.tensor(_pad_rows(
        np.stack([tracks[(fb, t)] for t in common]), nb), dtype=torch.float32,
        device=dev), Kt)
    e_cfg = RansacConfig(threshold=(ransac_cfg.threshold / fx) ** 2,
                         num_hypotheses=ransac_cfg.num_hypotheses, exhaustive=False,
                         selection=ransac_cfg.selection)
    return x1, x2, w, e_cfg, nb


def _pnp_inputs(m, tracks, f, vis, Kt):
    nb = _bucket(len(vis))
    dev = Kt.device
    Xw = torch.tensor(_pad_rows(np.stack([m.points[t] for t in vis]), nb),
                      dtype=torch.float32, device=dev)
    uv = torch.tensor(_pad_rows(np.stack([tracks[(f, t)] for t in vis]), nb),
                      dtype=torch.float32, device=dev)
    w = torch.tensor(_pad_rows(np.ones(len(vis), np.float32), nb), device=dev)
    return Xw, uv, w, nb


def _tri_tracks(x1n, x2n, R1, t1, R2, t2, valid, cos_min, gate_n):
    """Batched per-track 2-view DLT with the gates on the device: every row
    is its own track with its own pose pair ([T, ...]; padded rows carry
    valid=0).  Returns [T, 4]: X and ok."""
    X = epipolar.triangulate_dlt(x1n[:, None, :], x2n[:, None, :], R1, t1, R2, t2)[:, 0, :]

    def view_ok(R, t, xn):
        xc = (R @ X[..., None])[..., 0] + t
        z = xc[:, 2]
        zs = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
        pr = xc[:, :2] / zs[:, None]
        return (z > 0) & (torch.linalg.vector_norm(pr - xn, dim=1) <= gate_n)

    ok = valid & view_ok(R1, t1, x1n) & view_ok(R2, t2, x2n)
    C1 = -(R1.transpose(-1, -2) @ t1[..., None])[..., 0]
    C2 = -(R2.transpose(-1, -2) @ t2[..., None])[..., 0]
    r1 = X - C1
    r2 = X - C2
    den = torch.linalg.vector_norm(r1, dim=1) * torch.linalg.vector_norm(r2, dim=1)
    cosang = (r1 * r2).sum(1) / torch.clamp(den, min=1e-30)
    ok = ok & (den > 0) & (cosang <= cos_min)
    return torch.cat([X, ok[:, None].to(X.dtype)], 1)


def _triangulate_tracks_batched(m, tracks, assign: dict, Kt, gate_n,
                                min_angle_deg: float = 1.0) -> dict:
    """Triangulate ``assign = {tid: (g1, g2)}`` in one device call (see
    `_tri_tracks`); returns {tid: X} for the gate survivors."""
    if not assign:
        return {}
    tids = sorted(assign)
    T = _bucket(len(tids))
    Rs = {}
    for g1, g2 in assign.values():
        for g in (g1, g2):
            if g not in Rs:
                Rs[g] = _np_rodrigues(m.camera_poses[g][:3])
    x1 = np.zeros((T, 2), np.float32)
    x2 = np.zeros((T, 2), np.float32)
    R1 = np.tile(np.eye(3, dtype=np.float32), (T, 1, 1))
    R2 = np.tile(np.eye(3, dtype=np.float32), (T, 1, 1))
    t1 = np.zeros((T, 3), np.float32)
    t2 = np.zeros((T, 3), np.float32)
    vmask = np.zeros((T,), bool)
    for k, tid in enumerate(tids):
        g1, g2 = assign[tid]
        x1[k] = tracks[(g1, tid)]
        x2[k] = tracks[(g2, tid)]
        R1[k] = Rs[g1]
        R2[k] = Rs[g2]
        t1[k] = m.camera_poses[g1][3:]
        t2[k] = m.camera_poses[g2][3:]
        vmask[k] = True
    dev = Kt.device

    def d(a):
        return torch.from_numpy(a).to(dev)

    out = host(_tri_tracks(
        normalize_pixels(d(x1), Kt), normalize_pixels(d(x2), Kt), d(R1), d(t1), d(R2),
        d(t2), d(vmask), torch.tensor(np.cos(np.deg2rad(min_angle_deg)), dtype=torch.float32,
                                      device=dev),
        torch.tensor(gate_n, dtype=torch.float32, device=dev))).astype(np.float64)
    return {tid: out[k, :3] for k, tid in enumerate(tids) if out[k, 3] > 0.5}


def _np_rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Pure-numpy Rodrigues rotation (mirrors ops.rotation.exp_so3), for the
    host-side orchestration's small 3x3 work."""
    r = np.asarray(rvec, np.float64)
    th = float(np.linalg.norm(r))
    if th < 1e-12:
        return np.eye(3)
    k = r / th
    Kx = np.array([[0.0, -k[2], k[1]],
                   [k[2], 0.0, -k[0]],
                   [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(th) * Kx + (1.0 - np.cos(th)) * (Kx @ Kx)


def _np_log_so3(R: np.ndarray) -> np.ndarray:
    """Pure-numpy rotation log (mirrors ops.rotation.log_so3)."""
    R = np.asarray(R, np.float64)
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = float(np.arccos(cos))
    if th < 1e-8:
        return 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                               R[1, 0] - R[0, 1]])
    if th > np.pi - 1e-6:
        # Near pi: axis from the symmetric part.
        A = (R + np.eye(3)) / 2.0
        k = np.sqrt(np.maximum(np.diagonal(A), 0.0))
        i = int(np.argmax(k))
        axis = A[:, i] / max(k[i], 1e-12)
        axis = axis / max(np.linalg.norm(axis), 1e-12)
        return th * axis
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                  R[1, 0] - R[0, 1]]) / (2.0 * np.sin(th))
    return th * w


def _cam_center(pose6: np.ndarray) -> np.ndarray:
    """Camera center -R^T t of a (rvec, tvec) world->camera pose."""
    R = _np_rodrigues(pose6[:3])
    return -R.T @ np.asarray(pose6[3:6])


def _mean_reproj_errors(m, tracks, points: dict, obs_by_track: dict) -> dict:
    """{track: mean pixel reprojection error of ``points[track]`` over the
    track's registered observations ``obs_by_track[track]``}, inf where a
    view sees the point at depth <= 1e-9 (host numpy, one pass over all the
    observations; the JAX package loops a track and a view at a time)."""
    tids = list(points)
    if not tids:
        return {}
    frames = sorted({g for t in tids for g in obs_by_track[t]})
    fidx = {g: i for i, g in enumerate(frames)}
    R = np.stack([_np_rodrigues(m.camera_poses[g][:3]) for g in frames])
    tv = np.stack([np.asarray(m.camera_poses[g][3:], np.float64) for g in frames])
    row = np.array([k for k, t in enumerate(tids) for _ in obs_by_track[t]])
    view = np.array([fidx[g] for t in tids for g in obs_by_track[t]])
    uv = np.stack([tracks[(g, t)] for t in tids for g in obs_by_track[t]])
    X = np.stack([points[t] for t in tids])
    xc = np.einsum("oij,oj->oi", R[view], X[row]) + tv[view]
    K = np.asarray(m.K, np.float64)
    front = xc[:, 2] > 1e-9
    z = np.where(front, xc[:, 2], 1.0)
    pr = (xc[:, :2] / z[:, None]) @ K[:2, :2].T + K[:2, 2]
    err = np.linalg.norm(pr - uv, axis=1)
    n = np.bincount(row, minlength=len(tids))
    mean = np.bincount(row, weights=err, minlength=len(tids)) / np.maximum(n, 1)
    behind = np.bincount(row, weights=~front, minlength=len(tids)) > 0
    mean = np.where(behind | (n == 0), np.inf, mean)
    return dict(zip(tids, mean))


def _widest_pair(gs, centers):
    """The pair of frames ``gs`` with the largest camera-center distance
    (on loop trajectories the index-extreme frames can coincide in
    space), or None when every center coincides."""
    C = np.stack([centers[g] for g in gs])
    d2 = np.sum((C[:, None] - C[None, :]) ** 2, -1)
    i1, i2 = np.unravel_index(int(np.argmax(d2)), d2.shape)
    if d2[i1, i2] <= 0:
        return None
    return tuple(sorted((gs[i1], gs[i2])))


def _retriangulate_widest(m, tracks, gate_n, rebuild: bool = False, device="cuda"):
    """Re-solve map points from their widest pair of registered
    observations (run after each BA), accepting a candidate only if it
    lowers the point's mean reprojection error over all its registered
    observations (a 2-view solve from drifted poses can make a BA-refined
    point worse, so the update is monotone).

    ``rebuild=True`` (after a pose-graph correction): the map is cleared
    and every track with >= 2 registered observations is re-triangulated
    unconditionally (the gates still apply)."""
    frames_reg = sorted(m.camera_poses)
    fset = set(frames_reg)
    if rebuild:
        m.points.clear()
    obs_by_track: dict = {}
    for (g, t), _ in tracks.items():
        if (rebuild or t in m.points) and g in fset:
            obs_by_track.setdefault(t, []).append(g)
    centers = {g: _cam_center(m.camera_poses[g]) for g in frames_reg}
    assign: dict = {}
    for t, gs in obs_by_track.items():
        if len(gs) < 2:
            continue
        pair = _widest_pair(sorted(set(gs)), centers)
        if pair is not None:
            assign[t] = pair
    Kt = torch.tensor(m.K, dtype=torch.float32, device=device)
    new = _triangulate_tracks_batched(m, tracks, assign, Kt, gate_n)
    old = {t: m.points[t] for t in new if not rebuild and t in m.points}
    err_new = _mean_reproj_errors(m, tracks, {t: new[t] for t in old}, obs_by_track)
    err_old = _mean_reproj_errors(m, tracks, old, obs_by_track)
    n_acc = 0
    for tr, X in new.items():
        if tr not in old or err_new[tr] < err_old[tr]:
            m.points[tr] = X
            n_acc += 1
    if n_acc:
        log.info("retriangulated %d map points (widest-pair, monotone)", n_acc)


def reassociate_map_points(m, tracks, keypoints, frames_window,
                           max_px: float = 3.0, added: list | None = None) -> int:
    """Guided re-association (the ORB-SLAM "track local map" step): project
    the current map into each freshly registered frame and attach
    unclaimed detected keypoints within ``max_px`` of a projection as new
    observations of the projected track.

    ``keypoints = (xy [F, K, 2], valid [F, K])`` from the front end.
    One-to-one greedy by distance; keypoints already serving an observation
    in the frame and tracks already observed there are skipped.  Pure
    numpy.  Returns the number of observations added."""
    xy, valid = keypoints
    if added is None:
        added = []
    if not m.points:
        return 0
    tids = sorted(m.points)
    X = np.stack([m.points[t] for t in tids])
    K = np.asarray(m.K, np.float64)
    n_added = 0
    for f in frames_window:
        if f not in m.camera_poses or f >= len(xy):
            continue
        pose = m.camera_poses[f]
        R = _np_rodrigues(pose[:3])
        xc = X @ R.T + pose[3:]
        front = xc[:, 2] > 1e-6
        uv_p = np.full((len(tids), 2), 1e9)
        uv_p[front] = (xc[front, :2] / xc[front, 2:]) @ K[:2, :2].T + K[:2, 2]
        seen_tids = {t for (g, t) in tracks if g == f}
        used_uv = {tuple(np.asarray(tracks[(f, t)], np.float64)) for t in seen_tids}
        kp = np.asarray(xy[f], np.float64)
        kv = np.asarray(valid[f], bool)
        free_kp = [k for k in range(len(kp)) if kv[k] and tuple(kp[k]) not in used_uv]
        if not free_kp:
            continue
        cand_t = [i for i, t in enumerate(tids) if t not in seen_tids and front[i]]
        if not cand_t:
            continue
        d = np.linalg.norm(kp[free_kp][:, None, :] - uv_p[cand_t][None, :, :], axis=2)
        order = np.argsort(d, axis=None)
        taken_k: set = set()
        taken_t: set = set()
        for flat in order:
            ki, ti = np.unravel_index(flat, d.shape)
            if d[ki, ti] > max_px:
                break
            if ki in taken_k or ti in taken_t:
                continue
            taken_k.add(ki)
            taken_t.add(ti)
            tracks[(f, tids[cand_t[ti]])] = kp[free_kp[ki]]
            added.append((f, tids[cand_t[ti]]))
            n_added += 1
    return n_added


def frame_reproj_errors(m, tracks) -> dict:
    """Median reprojection error (pixels) per registered frame over its
    observations of current map points (host numpy)."""
    K = np.asarray(m.K, np.float64)
    errs: dict = {}
    Rs = {f: _np_rodrigues(m.camera_poses[f][:3]) for f in m.camera_poses}
    for (f, t), uv in tracks.items():
        if f not in m.camera_poses or t not in m.points:
            continue
        pose = m.camera_poses[f]
        xc = Rs[f] @ m.points[t] + pose[3:]
        if xc[2] <= 1e-9:
            e = np.inf
        else:
            pr = K[:2, :2] @ (xc[:2] / xc[2]) + K[:2, 2]
            e = float(np.linalg.norm(pr - np.asarray(uv, np.float64)))
        errs.setdefault(f, []).append(e)
    return {f: float(np.median(v)) for f, v in errs.items()}


def reregister_outlier_frames(m, tracks, ransac_cfg=None, factor: float = 3.0,
                              min_px: float = 4.0, engine: str | None = None,
                              seed: int = 99, device="cuda") -> int:
    """Re-localize frames whose pose broke during the reconstruction: a
    frame whose median reprojection error exceeds ``max(factor * the
    trajectory median, min_px)`` is re-registered by PnP-RANSAC against the
    current map on ``device``, and the new pose is kept only if it lowers
    that frame's median error.  Returns the number of frames moved."""
    if engine is None:
        engine = default_engine(device)
    cfg = ransac_cfg or RansacConfig(threshold=4.0, num_hypotheses=2048, exhaustive=False)
    errs = frame_reproj_errors(m, tracks)
    if not errs:
        return 0
    med = float(np.median(list(errs.values())))
    gate = max(factor * med, min_px)
    bad = sorted(f for f, e in errs.items() if e > gate)
    if not bad:
        return 0
    Kt = torch.tensor(m.K, dtype=torch.float32, device=device)
    keys = itertools.count(1)
    n_moved = 0
    for f in bad:
        vis = sorted(t for t in m.points if (f, t) in tracks)
        if len(vis) < 6:
            continue
        Xw, uv, w, nb = _pnp_inputs(m, tracks, f, vis, Kt)
        packed = host(_pnp_dispatch(Xw, uv, Kt, w, fold_seed(seed, next(keys)), cfg,
                                   engine == "sweep" and nb <= 512)).astype(np.float64)
        pose_new = np.concatenate([_np_log_so3(packed[:9].reshape(3, 3)), packed[9:12]])
        old = m.camera_poses[f]
        m.camera_poses[f] = pose_new
        e_new = frame_reproj_errors(m, {k: v for k, v in tracks.items()
                                        if k[0] == f}).get(f, np.inf)
        if e_new < errs[f]:
            n_moved += 1
            log.info("re-registered frame %d: median reproj %.1f -> %.1f px "
                     "(%d/%d PnP inliers)", f, errs[f], e_new, int(packed[12]), len(vis))
        else:
            m.camera_poses[f] = old
    return n_moved


def prune_observations(p: BAProblem, max_px: float) -> tuple[BAProblem, int]:
    """Zero the weight of observations whose current reprojection residual
    exceeds ``max_px`` or that lie behind their camera.  Returns the pruned
    problem (the weights in the form and on the device they came in) and
    the number of observations dropped."""
    cams = np.asarray(host(p.cameras), np.float64)
    pts = np.asarray(host(p.points), np.float64)
    K = np.asarray(host(p.K), np.float64)
    oc = host(p.obs_cam)
    op = host(p.obs_pt)
    uv = np.asarray(host(p.obs_uv), np.float64)
    w = np.asarray(host(p.obs_w), np.float64)
    R = np.stack([_np_rodrigues(c[:3]) for c in cams])
    xc = np.einsum("oij,oj->oi", R[oc], pts[op]) + cams[oc, 3:]
    z = np.where(np.abs(xc[:, 2]) < 1e-12, 1e-12, xc[:, 2])
    proj_uv = (K[:2, :2] @ (xc[:, :2] / z[:, None]).T).T + K[:2, 2]
    r = np.linalg.norm(proj_uv - uv, axis=1)
    bad = (r > max_px) | (xc[:, 2] <= 0)
    n_drop = int((bad & (w > 0)).sum())
    w_new = np.where(bad, 0.0, w).astype(np.float32)
    if isinstance(p.obs_w, torch.Tensor):
        w_new = torch.from_numpy(w_new).to(p.obs_w.device)
    return p._replace(obs_w=w_new), n_drop


def incremental_sfm(
    tracks: dict,            # {(frame, track_id): uv ndarray[2]}
    K: np.ndarray,
    frame_order: list[int],
    ransac_cfg: RansacConfig = RansacConfig(
        threshold=4.0, num_hypotheses=4096, exhaustive=False),
    ba_cfg: BundleAdjustConfig = BundleAdjustConfig(max_iters=15),
    ba_every: int = 1,
    seed: int = 0,
    checkpoint_dir: str | None = None,
    engine: str | None = None,
    bootstrap_stride: int = 1,
    keypoints=None,
    device="cuda",
) -> SfmMap:
    """Run incremental reconstruction over ``frame_order`` on ``device``.

    The world frame is the first camera; global scale is fixed by the
    two-view baseline (unit norm), the standard monocular gauge.

    ``bootstrap_stride``: bootstrap from ``(frame_order[0],
    frame_order[stride])`` instead of the first consecutive pair (adapted
    down to the largest stride whose pair shares >= 16 tracks); the
    skipped frames register afterwards by PnP against the seeded map.

    ``engine``: "sweep" routes bootstrap essential RANSAC and PnP
    registration through the fused sweep kernels, "stage" through the
    stage-wise engine; the default is "sweep" on a CUDA device.  Each
    RANSAC call takes a seed folded from ``seed`` and its call index
    (``utils.prng.fold_seed``).

    With ``checkpoint_dir``, the map snapshots after every BA
    (``utils.checkpointing``) and a rerun resumes from the last registered
    frame instead of recomputing.
    """
    if engine is None:
        engine = default_engine(device)
    m = SfmMap(K=np.asarray(K, np.float64))
    ckpt = None
    if checkpoint_dir is not None:
        from ransac_tpu_torch.utils.checkpointing import CheckpointManager

        ckpt = CheckpointManager(checkpoint_dir)
        state = ckpt.restore()
        if state is not None:
            frames = [int(f) for f in np.atleast_1d(state["frames"])]
            m.camera_poses = {f: np.asarray(p) for f, p in zip(frames, state["poses"])}
            m.points = {int(t): np.asarray(x) for t, x in
                        zip(np.atleast_1d(state["track_ids"]), state["points"])}
            log.info("resumed from checkpoint: %d frames, %d points",
                     len(m.camera_poses), len(m.points))

    def save_ckpt(step):
        # Drops rescued_frames, as the JAX package does (a resumed run
        # reports rescued=0).
        if ckpt is None or not m.camera_poses:
            return
        frames = sorted(m.camera_poses)
        tids = sorted(m.points)
        ckpt.save(step, {
            "frames": np.array(frames),
            "poses": np.stack([m.camera_poses[f] for f in frames]),
            "track_ids": np.array(tids),
            "points": (np.stack([m.points[t] for t in tids]) if tids else np.zeros((0, 3))),
        })

    keys = itertools.count(1)

    def next_key():
        return fold_seed(seed, next(keys))

    # Resume: bootstrap is done iff two frames are registered; registered
    # frames move to the front of frame_order (keeping their order) so they
    # keep serving as triangulation partners.
    reg = [f for f in frame_order if f in m.camera_poses]
    f_boot_done = len(reg) >= 2
    if f_boot_done:
        frame_order = reg + [f for f in frame_order if f not in m.camera_poses]
        start_idx = len(reg)
    else:
        if bootstrap_stride > 1 and len(frame_order) > 2:
            # The largest stride whose pair shares >= 16 tracks (else the
            # most-shared pair): track survival over a wide stride can
            # collapse, and a ~10-point seed map starves every later
            # registration.
            t0_set = {t for g, t in tracks if g == frame_order[0]}
            best_s, best_common = 1, -1
            for s in range(min(bootstrap_stride, len(frame_order) - 1), 0, -1):
                fs = frame_order[s]
                n_common = sum(1 for t in t0_set if (fs, t) in tracks)
                if n_common >= 16:
                    best_s, best_common = s, n_common
                    break
                if n_common > best_common:
                    best_s, best_common = s, n_common
            s = best_s
            if s != bootstrap_stride:
                log.info("bootstrap stride adapted %d -> %d (%d common tracks)",
                         bootstrap_stride, s, best_common)
            f1b = frame_order[s]
            frame_order = [frame_order[0], f1b] + [f for f in frame_order[1:] if f != f1b]
        start_idx = 2
    f0, f1 = frame_order[0], frame_order[1]

    # ---- two-view bootstrap
    Kt = torch.tensor(np.asarray(K), dtype=torch.float32, device=device)
    fx = float(K[0, 0])
    if not f_boot_done:
        common = sorted(t for t in {t for f, t in tracks if f == f0} if (f1, t) in tracks)
        x1, x2, wts, e_cfg, nb = _essential_inputs(tracks, f0, f1, common, Kt,
                                                   ransac_cfg, fx)
        inl, R, t, X, n = _unpack_essential(host(_essential_dispatch(
            x1, x2, wts, e_cfg, next_key(), engine == "sweep" and nb <= 1024)
        ).astype(np.float64), nb)
        log.info("bootstrap %d-%d: %d/%d essential inliers, %d cheiral",
                 f0, f1, inl.sum(), len(common), n)
        m.camera_poses[f0] = np.zeros(6)
        m.camera_poses[f1] = np.concatenate([_np_log_so3(R), t])
        for i, tr in enumerate(common):
            if inl[i] and X[i, 2] > 0:
                m.points[tr] = X[i]
        save_ckpt(1)

    # ---- incremental registration
    tracks_by_frame: dict = {}
    frames_by_track: dict = {}
    for (g_, t_) in tracks:
        tracks_by_frame.setdefault(g_, set()).add(t_)
        frames_by_track.setdefault(t_, []).append(g_)
    gate_n = 2.0 * ransac_cfg.threshold / fx

    def _dispatch_pnp(f):
        """Queue frame f's PnP-RANSAC against the current map without
        reading back; ``(vis, device_result)`` or None (too few map
        correspondences yet).  A window's dispatches are all queued before
        the first read: the map is frozen within a window."""
        vis = sorted(t for t in m.points if (f, t) in tracks)
        if len(vis) < 6:
            log.warning("frame %d: only %d map correspondences, deferring", f, len(vis))
            return None
        Xw, uv, w, nb = _pnp_inputs(m, tracks, f, vis, Kt)
        return vis, _pnp_dispatch(Xw, uv, Kt, w, next_key(), ransac_cfg,
                                  engine == "sweep" and nb <= 512)

    def _finish_pnp(f, vis, packed):
        m.camera_poses[f] = np.concatenate(
            [_np_log_so3(packed[:9].reshape(3, 3)), packed[9:12]])
        log.info("frame %d registered: %d/%d PnP inliers", f, int(packed[12]), len(vis))

    def _triangulate_frames(fs):
        """Triangulate the not-yet-mapped tracks visible in frames ``fs``
        from each track's own widest-baseline pair of registered
        observations, measured in estimated camera-center distance; the
        triangulation angle gate is the real filter.  One batched pass for
        the whole window."""
        reg_set = set(m.camera_poses)
        centers = {g: _cam_center(m.camera_poses[g]) for g in reg_set}
        cand = set()
        for f in fs:
            cand |= tracks_by_frame.get(f, set())
        assign: dict = {}
        for t in cand:
            if t in m.points:
                continue
            gs = sorted(g for g in frames_by_track.get(t, ()) if g in reg_set)
            if len(gs) < 2:
                continue
            pair = _widest_pair(gs, centers)
            if pair is not None:
                assign[t] = pair
        m.points.update(_triangulate_tracks_batched(m, tracks, assign, Kt, gate_n))

    def run_ba(after_f):
        p, frames, track_ids = m.as_ba_problem(tracks)
        res = bundle_adjust(p, ba_cfg, device=device)
        C, P = len(frames), len(track_ids)
        packed = host(torch.cat([
            res.cameras.reshape(-1), res.points.reshape(-1),
            torch.stack([res.initial_cost, res.cost, res.iterations.to(res.cost.dtype)])])
        ).astype(np.float64)
        m.apply_ba(BAResult(cameras=packed[:6 * C].reshape(C, 6),
                            points=packed[6 * C:6 * C + 3 * P].reshape(P, 3),
                            cost=packed[-2], initial_cost=packed[-3],
                            iterations=int(packed[-1])), frames, track_ids)
        log.info("BA after frame %d: cost %.4g -> %.4g (%d iters)",
                 after_f, packed[-3], packed[-2], int(packed[-1]))
        _retriangulate_widest(m, tracks, gate_n, device=device)

    def _reassociate(fs):
        added: list = []
        n_re = reassociate_map_points(m, tracks, keypoints, fs, max_px=2.0, added=added)
        for (gf, gt) in added:
            tracks_by_frame.setdefault(gf, set()).add(gt)
            frames_by_track.setdefault(gt, []).append(gf)
        return n_re

    # Main pass + retry passes, windowed: frames register in windows of
    # ``ba_every`` against a map frozen for the window, then one window-wide
    # triangulation pass and one BA.  A deferred frame often becomes
    # registrable once later frames have grown the map (the retry passes).
    pending = [f for f in frame_order[start_idx:] if f not in m.camera_poses]
    n_done = 0
    for pass_i in range(3):
        if not pending:
            break
        if pass_i:
            log.info("retry pass %d over %d deferred frames", pass_i, len(pending))
        still = []
        win = max(1, ba_every)
        for w0 in range(0, len(pending), win):
            window = pending[w0:w0 + win]
            inflight = []
            for f in window:
                d = _dispatch_pnp(f)
                if d is None:
                    still.append(f)
                else:
                    inflight.append((f, d[0], d[1]))
            if not inflight:
                continue
            for f, vis, dev in inflight:
                _finish_pnp(f, vis, host(dev).astype(np.float64))
            n_done += len(inflight)
            newly = [f for f, _, _ in inflight]
            _triangulate_frames(newly)
            run_ba(newly[-1])
            if keypoints is not None:
                # Guided re-association after the window's BA, whose poses
                # and map make the projections trustworthy; the added
                # observations feed the next window's PnP and BA.
                n_re = _reassociate(newly)
                if n_re:
                    log.info("re-associated %d map-point observations over %d frames",
                             n_re, len(newly))
            save_ckpt(n_done)
        if len(still) == len(pending):
            break  # no progress: a further pass cannot help
        pending = still

    # ---- frame-by-frame rescue: runs only when frames remain unregistered
    # after the windowed passes (a frontier that outran the frozen map).
    # Register one frame at a time, triangulate at once, gate acceptance on
    # the PnP inlier count; BA + re-association every ``win`` rescued frames.
    if pending:
        log.info("rescue pass over %d stalled frames", len(pending))
    rescued_since_ba: list = []

    def _twoview_continue(f):
        """Chain frame ``f`` off the best-sharing registered frame by
        two-view essential RANSAC when PnP cannot see it.  Monocular scale
        comes from the median map / two-view depth ratio over the pair's
        shared mapped tracks (>= 3 anchors), else from a motion prior (the
        median of the last 8 consecutive steps at or before the partner);
        a pose scaled by the prior is committed unchecked, as the JAX
        package commits it.  Returns True if ``f`` was registered."""
        ts_f = tracks_by_frame.get(f, set())
        best_g, shared = None, ()
        for g in m.camera_poses:
            sh = ts_f & tracks_by_frame.get(g, set())
            if len(sh) > len(shared):
                best_g, shared = g, sh
        if best_g is None or len(shared) < 16:
            return False
        common = sorted(shared)
        x1, x2, wts, e_cfg, nb = _essential_inputs(tracks, best_g, f, common, Kt,
                                                   ransac_cfg, float(m.K[0, 0]))
        inl, R_rel, t_rel, X_rel, _n = _unpack_essential(host(_essential_dispatch(
            x1, x2, wts, e_cfg, next_key(), engine == "sweep" and nb <= 1024)
        ).astype(np.float64), nb)
        inl = inl[:len(common)]
        if int(inl.sum()) < 16:
            return False
        Rg = _np_rodrigues(m.camera_poses[best_g][:3])
        tg = np.asarray(m.camera_poses[best_g][3:6], np.float64)
        ratios = []
        for i, tr in enumerate(common):
            if inl[i] and tr in m.points and X_rel[i, 2] > 1e-6:
                d_map = (Rg @ m.points[tr] + tg)[2]
                if d_map > 1e-6:
                    ratios.append(d_map / X_rel[i, 2])
        if len(ratios) >= 3:
            s = float(np.median(ratios))
            src = f"{len(ratios)} map anchors"
        else:
            regs = sorted(g for g in m.camera_poses if g <= best_g)
            steps = [np.linalg.norm(_cam_center(m.camera_poses[a])
                                    - _cam_center(m.camera_poses[b]))
                     for a, b in zip(regs, regs[1:]) if b - a == 1][-8:]
            if not steps:
                return False
            s = float(np.median(steps)) * max(1, abs(f - best_g))
            src = "motion prior (no map anchors)"
        R_f = R_rel @ Rg
        t_f = R_rel @ tg + s * t_rel
        m.camera_poses[f] = np.concatenate([_np_log_so3(R_f), t_f])
        log.info("rescue: frame %d chained by two-view from frame %d "
                 "(%d/%d essential inliers, scale %.3g from %s)",
                 f, best_g, int(inl.sum()), len(common), s, src)
        return True

    def _rescue_ba():
        run_ba(rescued_since_ba[-1])
        if keypoints is not None:
            _reassociate(list(rescued_since_ba))
        rescued_since_ba.clear()
        save_ckpt(n_done)

    for pass_i in range(8):
        if not pending:
            break
        still = []
        for f in pending:
            d = _dispatch_pnp(f)
            ok = False
            if d is not None:
                vis, dev = d
                packed = host(dev).astype(np.float64)
                n_inl = int(packed[12])
                # Inlier gate: absolute floor 8, relative 25% against thin
                # maps, capped at 20.
                if n_inl >= max(8, min(int(0.25 * len(vis)), 20)):
                    _finish_pnp(f, vis, packed)
                    ok = True
                else:
                    log.info("rescue: frame %d PnP rejected (%d/%d inliers)",
                             f, n_inl, len(vis))
            if not ok:
                ok = _twoview_continue(f)
            if not ok:
                still.append(f)
                continue
            n_done += 1
            m.rescued_frames.add(f)
            rescued_since_ba.append(f)
            _triangulate_frames([f])
            if len(rescued_since_ba) >= max(1, ba_every):
                _rescue_ba()
        if len(still) == len(pending):
            break
        pending = still
    if rescued_since_ba:
        _rescue_ba()
    if pending:
        log.warning("%d frames remain unregistered after rescue: %s",
                    len(pending), pending[:16])
    return m
