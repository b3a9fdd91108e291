"""Traffic of kind ``localize``: each request is one photograph through
the port's ``pipelines.localize.localize`` on the CLI's default route (the
batched engine, ``use_sweep=False``).

Set-up draws a pool of ``scenes`` photographs from the seed (each with its
true camera drawn over the grid, fresh landmarks, noise and outliers),
writes each as the reference's CSVs and ingests it through the port's
``io.tables``.  Requests walk the pool in a seeded order, cycling.

The comparison (``judge``) holds every answer of the window against the
plain reference (``reference.py``) on the same photograph, computed once
per photograph.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

import reference as ref
import scenes

#: The numbers compared, in the order they are printed.
NUMBERS = ("h_mask_gap_px2", "err1_gap_px", "err2_gap", "best_gap",
           "pnp_mask_gap_px2", "origin_gap_m", "rot_gap_urad")
#: Every number ``judge_run`` returns: the keys of a mix's ``limits``.
LIMITS = NUMBERS
#: LM passes of the reference's pose refit: enough to converge.
POSE_ITERS = 50


def program_config(cfg: dict):
    """The port's ``LocalizeConfig`` for the configuration file."""
    from ransac_tpu_torch.utils.config import (CameraIntrinsicsConfig,
                                               LocalizeConfig, RansacConfig)

    h, p, cam = cfg["homography"], cfg["pnp"], cfg["camera"]
    return LocalizeConfig(
        ransac=RansacConfig(threshold=h["threshold_px"], exhaustive=h["exhaustive"],
                            selection=h["selection"], refine_iters=h["refine_iters"]),
        pnp_ransac=RansacConfig(threshold=p["threshold_px"], exhaustive=p["exhaustive"],
                                selection=p["selection"], refine_iters=p["refine_iters"]),
        intrinsics=CameraIntrinsicsConfig(**cam),
        observer_height_m=cfg["observer_height_m"], min_pnp_inliers=p["min_inliers"])


def make_photos(cfg: dict, n: int, seed: int, n_candidates: int | None = None):
    """(grid, [Photo] * n): the pool of photographs of ``seed``."""
    grid = scenes.read_grid(n_candidates)
    photos = []
    for k in range(n):
        rng = np.random.default_rng([seed, 1, k])
        photos.append(scenes.planted_photo(grid, cfg, rng,
                                           int(rng.integers(len(grid.east)))))
    return grid, photos


def ingest(cfg: dict, grid, photo, directory: str, device):
    """The photograph as users hand it to ``localize``: its CSVs, read by
    the port's ``io.tables``."""
    from ransac_tpu_torch.io.tables import (build_scene, read_camera_locations,
                                            read_points_data)

    fcsv, ccsv = scenes.write_scene_csvs(directory, grid, photo, cfg["observer_height_m"])
    feats = read_points_data(fcsv, scenes.PIXEL_X, scenes.PIXEL_Y)
    cams = read_camera_locations(ccsv, observer_height=cfg["observer_height_m"])
    return build_scene(feats, cams, device=device)


@dataclass
class Answer:
    scene: int
    best: int
    err1: np.ndarray      # [C]
    err2: np.ndarray      # [C]
    masks: np.ndarray     # [C, N] bool
    R: np.ndarray | None  # [3, 3]
    origin: np.ndarray | None  # [3] UTM
    pnp_mask: np.ndarray | None  # [N]


def answer_of(scene: int, res) -> Answer:
    return Answer(scene, int(res.best_index), np.asarray(res.err1), np.asarray(res.err2),
                  np.asarray(res.inlier_masks, bool), res.R, res.camera_origin_utm,
                  None if res.pnp_inliers is None else np.asarray(res.pnp_inliers, bool))


class Session:
    """The program's side of a run: the ingested pool and its entry."""

    def __init__(self, cfg, traffic, seed, device, workdir, n_candidates=None):
        self.cfg, self.device = cfg, device
        self.grid, self.photos = make_photos(cfg, traffic["scenes"], seed, n_candidates)
        self.lcfg = program_config(cfg)
        self.scenes = [ingest(cfg, self.grid, ph, os.path.join(workdir, f"scene{k}"), device)
                       for k, ph in enumerate(self.photos)]
        self.order = np.random.default_rng([seed, 2]).permutation(len(self.scenes))

    def next_input(self, i: int) -> int:
        return int(self.order[i % len(self.order)])

    def request(self, k: int) -> Answer:
        from ransac_tpu_torch.pipelines.localize import localize

        res = localize(self.scenes[k], tuple(self.cfg["image_size"]), self.lcfg,
                       use_sweep=False, device=self.device)
        return answer_of(k, res)

    def release(self) -> None:
        self.scenes = None


# ------------------------------------------------------------ the reference
class Reference:
    """The reference's searches of one photograph, computed once: the
    homography search on ``device``, the PnP search on the host."""

    def __init__(self, cfg, grid, photo, device, P: ref.Prec = ref.REFERENCE):
        self.cfg, self.P = cfg, P
        K = scenes.film_K(cfg)
        args = (grid.utm, grid.grid_codes, photo.landmarks, photo.pixels, K, P)
        self.pb = ref.make_problem(*args, device)
        self.pb_host = ref.make_problem(*args, "cpu")
        self.search = ref.homography_search(self.pb, cfg["homography"]["threshold_px"], P)
        self.pnp = ref.pnp_search(self.pb_host, cfg["pnp"]["threshold_px"], P)

    def scores(self, masks: torch.Tensor):
        h = self.cfg["homography"]
        return ref.scores(self.pb, self.search, masks, h["threshold_px"],
                          h["refine_iters"], self.P)

    def pnp_mask_gap(self, mask: torch.Tensor) -> float:
        return ref.pnp_mask_gap(self.pnp, mask)

    def pose(self, mask: torch.Tensor):
        R, t = ref.pnp_pose(self.pb_host, self.pnp, mask, POSE_ITERS, self.P)
        return R, ref.camera_origin(self.pb_host, R, t)


def rotation_angle(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """The angle between two rotations, from |Ra - Rb|_F = 2 sqrt(2)
    sin(angle / 2), which keeps its digits where arccos of the trace
    loses them."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(2.0 * np.arcsin(min(d / (2.0 * np.sqrt(2.0)), 1.0)))


def judge_one(r: Reference, a: Answer) -> dict:
    """The numbers of one answer against the reference on its photograph.
    err1 and err2 are compared on the candidates that compete for the
    answer: those whose err2 lies within one outlier's bound of the best.
    A homography fitted badly to few inliers can be nearly singular at one
    of its pixels, and its err2 (through the inverse) then has no digits
    left in float32: the port's own search run in float64 agrees with the
    reference there (PERF.md).  The PnP inliers are held as the homography
    masks are, by the MSAC of the best hypothesis with them above the best
    hypothesis's: 0 where they are the winner's; the pose is then held
    against the reference's refit on them."""
    dev = r.pb.cams.device
    masks = torch.as_tensor(a.masks, device=dev)
    _, e1, e2, best_r, gap = r.scores(masks)
    e1, e2 = e1.double().cpu().numpy(), e2.double().cpu().numpy()
    sel = np.where((e2 == 0) | ~np.isfinite(e2), 1e6, e2)
    near = sel <= sel[best_r] + r.cfg["homography"]["threshold_px"]
    out = {"h_mask_gap_px2": float(gap.max()),
           "err1_gap_px": float(np.abs(e1 - a.err1)[near].max()),
           "err2_gap": float(np.abs(e2 - a.err2)[near].max()),
           "best_gap": float(sel[a.best] - sel[best_r])}
    if a.R is None:
        return dict(out, pnp_mask_gap_px2=math.inf, origin_gap_m=math.inf,
                    rot_gap_urad=math.inf)
    mask = torch.as_tensor(a.pnp_mask)
    R, origin = r.pose(mask)
    return dict(out, pnp_mask_gap_px2=r.pnp_mask_gap(mask),
                origin_gap_m=float(np.linalg.norm(origin - a.origin)),
                rot_gap_urad=rotation_angle(R.double().numpy(), a.R) * 1e6)


def judge(cfg, grid, photos, answers, device):
    """[numbers of each answer]: every answer against the reference of its
    photograph (each computed once)."""
    refs, out = {}, []
    for a in answers:
        if a.scene not in refs:
            refs[a.scene] = Reference(cfg, grid, photos[a.scene], device)
        out.append(judge_one(refs[a.scene], a))
    return out


def control_answers(session: Session, n: int, device) -> list[Answer]:
    """The control's answers to the session's first ``n`` requests."""
    return [control_answer(session.cfg, session.grid, session.photos[k], k, device)
            for k in (session.next_input(i) for i in range(n))]


def control_answer(cfg, grid, photo, scene: int, device,
                   P: ref.Prec = ref.CONTROL) -> Answer:
    """The reference in the program's place, in ``P``: its own winners,
    scores, choice and pose."""
    r = Reference(cfg, grid, photo, device, P)
    _, own = ref.best_of(r.search)
    _, e1, e2, best, _ = r.scores(own)
    k = int(r.pnp.msac.argmin())
    R, origin = r.pose(r.pnp.masks[k])
    return Answer(scene, best, e1.double().cpu().numpy(), e2.double().cpu().numpy(),
                  own.cpu().numpy(), R.double().numpy(), origin, r.pnp.masks[k].numpy())


def judge_run(session: Session, answers, device) -> list[dict]:
    """Every answer of the run, judged."""
    return judge(session.cfg, session.grid, session.photos, answers, device)
