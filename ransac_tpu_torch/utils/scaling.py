"""Scaling harness over mesh sizes (port of ``ransac_tpu.utils.scaling``).

Times the distributed candidate search (candidates/s) and the sharded
keyframe front end (frames/s, weak scaling) on meshes of growing size
inside one ``torch.distributed`` world.  Every rank calls these functions;
a size-n mesh is the world's first n ranks, and the others wait (the
world's maximum of the members' times is a barrier too).  A point's time
is the slowest member's, by the host clock after a device synchronize.
With ranks sharing a card, or on the CPU, the numbers validate the sharded
program and measure its overhead, not a speedup (``report`` says so).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ransac_tpu_torch.parallel import mesh as mesh_mod
from ransac_tpu_torch.parallel.sharded_search import distributed_score_candidates
from ransac_tpu_torch.utils.config import LocalizeConfig, RansacConfig

COUNTS = (1, 2, 4, 8, 16, 32)


@dataclass
class ScalePoint:
    n_devices: int
    mesh_shape: dict
    candidates_per_s: float
    efficiency: float  # vs linear scaling from the first point
    device: str = "cuda"


def _synth(seed, n_pts, n_cand):
    rng = np.random.default_rng(seed)
    cam = np.array([-500.0, 0.0, 50.0])
    X = rng.uniform(-100, 100, size=(n_pts, 3)) + np.array([0, 0, 80.0])
    pix = rng.uniform(0, 2000, size=(n_pts, 2))
    cam_locs = cam + rng.normal(scale=120.0, size=(n_cand, 3))
    grids = np.ones(n_cand, np.int32)
    return (pix.astype(np.float32), X.astype(np.float32), np.ones(n_pts, np.float32),
            cam_locs.astype(np.float32), grids)


def _counts(device_counts):
    if device_counts is None:
        return [d for d in COUNTS if d <= mesh_mod.world_size()]
    return list(device_counts)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(mesh, run, iters: int) -> float:
    """Seconds a call of ``run(i)`` on the mesh's members (warm, the slowest
    member's mean over ``iters``); every rank of the world gets it."""
    dt = 0.0
    if mesh.member:
        run(0)
        _sync(mesh.device)
        t0 = time.perf_counter()
        for i in range(iters):
            run(i)
        _sync(mesh.device)
        dt = (time.perf_counter() - t0) / iters
    return mesh_mod.world_max(dt, mesh.device)


def measure_scaling(device_counts=None, n_candidates: int = 64, n_points: int = 13,
                    hypotheses: int = 4096, iters: int = 5, seed: int = 0,
                    device="cuda") -> list[ScalePoint]:
    """Candidates/s of ``distributed_score_candidates`` at each mesh size
    (default: 1, 2, 4, ... up to the world size), the squarest mesh of each;
    efficiency against linear scaling from the first point."""
    device_counts = _counts(device_counts)
    pix, X, mask, cam_locs, grids = _synth(seed, n_points, n_candidates)
    cfg = LocalizeConfig(ransac=RansacConfig(threshold=5.0, num_hypotheses=hypotheses,
                                             exhaustive=False))
    points: list[ScalePoint] = []
    base = None
    for nd in device_counts:
        mesh = mesh_mod.make_mesh(nd, device=device)
        dt = _timed(mesh, lambda i: distributed_score_candidates(
            pix, X, mask, cam_locs, grids, cfg, i, mesh)["err2"], iters)
        cps = n_candidates / dt
        if base is None:
            base = cps
        points.append(ScalePoint(n_devices=nd, mesh_shape=dict(mesh.shape),
                                 candidates_per_s=cps, efficiency=cps / (base * nd),
                                 device=mesh.device.type))
    return points


def measure_frontend_scaling(device_counts=None, frames_per_device: int = 2,
                             img_hw: int = 128, max_kp: int = 256, iters: int = 3,
                             seed: int = 0, device="cuda") -> list[ScalePoint]:
    """Frames/s of the keyframe-sharded front end (detect + describe +
    consecutive-pair match over the mesh's ``data`` axis) at each mesh
    size.  Weak scaling: the frame count grows with the data axis, so
    perfect scaling is flat time and linear frames/s."""
    from ransac_tpu_torch.parallel.sharded_frontend import distributed_frontend
    from ransac_tpu_torch.utils.config import TwoViewConfig

    device_counts = _counts(device_counts)
    cfg = TwoViewConfig(max_keypoints=max_kp)
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((img_hw + 64, img_hw + 64)).astype(np.float32)
    points: list[ScalePoint] = []
    base_fps = None
    for nd in device_counts:
        mesh = mesh_mod.make_mesh(nd, data=nd, model=1, device=device)
        n_frames = frames_per_device * mesh.shape["data"]
        imgs = torch.from_numpy(np.stack([base[f:f + img_hw, f:f + img_hw]
                                          for f in range(n_frames)]))
        dt = _timed(mesh, lambda i: distributed_frontend(imgs, mesh, cfg)[0], iters)
        fps = n_frames / dt
        if base_fps is None:
            base_fps = fps
        points.append(ScalePoint(
            n_devices=nd, mesh_shape=dict(mesh.shape), candidates_per_s=fps,
            # Against the first measured count, so explicit counts like
            # [2, 4, 8] report 100% at their base point.
            efficiency=fps * device_counts[0] / (base_fps * nd), device=mesh.device.type))
    return points


def report(points: list[ScalePoint], virtual: bool | None = None,
           unit: str = "cand/s") -> str:
    """The JAX harness's table.  ``virtual`` None: true when the points ran
    on the CPU or the ranks share a card (``parallel.mesh.ranks_share_a_device``)."""
    if virtual is None:
        virtual = (any(p.device == "cpu" for p in points)
                   or (mesh_mod.world_size() > 1 and mesh_mod.ranks_share_a_device()))
    lines = []
    if virtual:
        lines.append("# NOTE: virtual single-host devices — validates the "
                     "sharded program, not real speedup")
    lines.append(f"{'devices':>8} {'mesh':>14} {unit:>12} {'eff':>6}")
    for p in points:
        lines.append(f"{p.n_devices:8d} {str(p.mesh_shape):>14} "
                     f"{p.candidates_per_s:12.1f} {100*p.efficiency:5.1f}%")
    return "\n".join(lines)
