"""Distributed candidate search over a (data, model) mesh (port of
``ransac_tpu.parallel.sharded_search``).

- Candidate cameras shard over the ``data`` axis (the reference's
  458-iteration loop, main_v1.py:274);
- the RANSAC hypotheses shard over the ``model`` axis, each shard drawing
  its own sample block from ``utils.prng.fold_seed(seed, di, mi)`` (JAX's
  ``fold_in(fold_in(key, di), mi)``);
- each candidate's best hypothesis across the model shards comes from an
  all-gather over ``model`` and an argmin, the scores of every candidate
  from an all-gather over ``data``: every rank returns the whole result.

``emulate_hypothesis_sharded`` runs the same shards on one device, the
collectives replaced by stacking: the same per-shard draws and the same
combine (``_combine_and_score``), so it and the distributed search make
the same decision.  The refit is plain DLT with no LM (the JAX functions'
throughput trade), then the reference's err1 / err2, the grid gate and the
1e6 argmin guard of ``pipelines.localize``.
"""

from __future__ import annotations

import torch

from ransac_tpu_torch.models import ransac as ransac_mod
from ransac_tpu_torch.ops import homography as hops
from ransac_tpu_torch.ops import projection as proj
from ransac_tpu_torch.parallel import mesh as mesh_mod
from ransac_tpu_torch.utils.config import LocalizeConfig, RansacConfig
from ransac_tpu_torch.utils.prng import fold_seed


def _local_candidate_scores(pixels, pos3d, point_mask, cam_locs, seed: int,
                            rcfg: RansacConfig):
    """Score a block of candidates [c_l, 3] with one block of hypotheses
    (``rcfg``'s budget is already the shard's), drawn from ``seed``.
    Returns per candidate (msac_best [c_l], model [c_l,3,3], inlier mask
    [c_l,N], count [c_l], pos2 [c_l,N,2])."""
    c_l = cam_locs.shape[0]
    pos2, _ = proj.east_axis_plane_projection(pos3d[None], cam_locs)     # [c_l,N,2]
    flat, _, counts, msac, best, best_mask = ransac_mod.ransac_fit(
        ransac_mod._h_solve, hops.transfer_errors, pos2, pixels.expand(c_l, -1, -1),
        point_mask.expand(c_l, -1), 4, rcfg, degenerate_fn=ransac_mod._h_degenerate,
        key_or_seed=seed)
    take = ransac_mod._take
    return take(msac, best), take(flat, best), best_mask, take(counts, best), pos2


def _combine_and_score(pixels, point_mask, msac_all, model_all, mask_all, pos2_l, grid_l,
                       cfg: LocalizeConfig):
    """Each candidate's best hypothesis across the stacked model shards
    (``msac_all`` [m, c_l], ``model_all`` [m, c_l, 3, 3], ``mask_all`` [m,
    c_l, N]), refit by plain DLT on its inliers (a non-finite refit keeps
    the minimal model), the reference's (err1, err2) and the grid gate.
    Shared by the distributed search and its emulation."""
    from ransac_tpu_torch.pipelines.localize import reference_scores

    c_l = msac_all.shape[1]
    best_shard = msac_all.argmin(0)                                       # [c_l]
    rows = torch.arange(c_l, device=msac_all.device)
    H_raw = model_all[best_shard, rows]
    inl = mask_all[best_shard, rows].bool()
    w = inl.to(pixels.dtype) * point_mask
    H = hops.dlt_homography(pos2_l, pixels.expand(c_l, -1, -1), w)
    bad = ~torch.isfinite(H).all(-1).all(-1)
    H = torch.where(bad[:, None, None], H_raw, H)
    err1, err2 = reference_scores(H, pos2_l, pixels, inl, point_mask, cfg.ransac.threshold)
    gate = grid_l >= cfg.grid_code_min
    return torch.where(gate, err1, 0.0), torch.where(gate, err2, 0.0)


def _local_rcfg(rcfg: RansacConfig, n_model: int) -> RansacConfig:
    """The hypothesis budget of one model shard (shared by both paths):
    enumeration only on a model axis of one."""
    return RansacConfig(
        threshold=rcfg.threshold, num_hypotheses=max(rcfg.num_hypotheses // n_model, 64),
        exhaustive=rcfg.exhaustive and n_model == 1,
        max_exhaustive_samples=rcfg.max_exhaustive_samples, selection=rcfg.selection,
        refit=False, refine_iters=0, seed=rcfg.seed)


def _select(err1, err2) -> dict:
    """The zero-score and non-finite guard, then the argmin (as
    ``pipelines.localize``)."""
    err2_sel = torch.where((err2 == 0.0) | ~torch.isfinite(err2), 1e6, err2)
    best = err2_sel.argmin()
    return {"err1": err1, "err2": err2, "best": best, "best_err2": err2_sel[best]}


def pad_candidates(cam_locs, grid_codes, multiple: int):
    """Pad the candidate axis to a multiple of ``multiple`` with copies of
    the first candidate carrying grid code -1, which the grid gate scores 0
    and the argmin guard then excludes (main_v1.py:863-866)."""
    cam_locs, grid_codes = torch.as_tensor(cam_locs), torch.as_tensor(grid_codes)
    pad = (-cam_locs.shape[0]) % multiple
    if pad:
        cam_locs = torch.cat([cam_locs, cam_locs[:1].expand(pad, -1)])
        grid_codes = torch.cat([grid_codes, grid_codes.new_full((pad,), -1)])
    return cam_locs, grid_codes


def _inputs(device, pixels, pos3d, point_mask, cam_locs, grid_codes):
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return (f32(pixels), f32(pos3d), f32(point_mask), f32(cam_locs),
            torch.as_tensor(grid_codes, device=device))


def emulate_hypothesis_sharded(pixels, pos3d, point_mask, cam_locs, grid_codes,
                               cfg: LocalizeConfig, seed: int, n_data: int, n_model: int,
                               device="cuda") -> dict:
    """``distributed_score_candidates`` on an (n_data x n_model) mesh, on
    one ``device``: the same per-shard seeds and budgets and the same
    combine, the collectives replaced by stacking.  C must divide by
    n_data (``pad_candidates``)."""
    pixels, pos3d, point_mask, cam_locs, grid_codes = _inputs(
        torch.device(device), pixels, pos3d, point_mask, cam_locs, grid_codes)
    C = cam_locs.shape[0]
    if C % n_data:
        raise ValueError(f"{C} candidates do not split over data = {n_data}")
    c_l = C // n_data
    rcfg_local = _local_rcfg(cfg.ransac, n_model)
    err1, err2 = [], []
    for di in range(n_data):
        locs_l = cam_locs[di * c_l:(di + 1) * c_l]
        shards = [_local_candidate_scores(pixels, pos3d, point_mask, locs_l,
                                          fold_seed(seed, di, mi), rcfg_local)
                  for mi in range(n_model)]
        msac_all, model_all, mask_all = (torch.stack([s[k] for s in shards])
                                         for k in range(3))
        e1, e2 = _combine_and_score(pixels, point_mask, msac_all, model_all, mask_all,
                                    shards[0][4], grid_codes[di * c_l:(di + 1) * c_l], cfg)
        err1.append(e1)
        err2.append(e2)
    return _select(torch.cat(err1), torch.cat(err2))


def distributed_score_candidates(pixels, pos3d, point_mask, cam_locs, grid_codes,
                                 cfg: LocalizeConfig, seed: int,
                                 mesh: mesh_mod.Mesh) -> dict:
    """The candidate search sharded over ``mesh`` (data = candidates, model
    = hypotheses), called by every rank of the mesh with the same
    arguments (arrays or tensors: pixels [N,2], pos3d [N,3], point_mask
    [N], cam_locs [C,3] with C divisible by the data axis, grid_codes [C]).

    Returns on every rank err1 [C], err2 [C], best and best_err2 on the
    rank's device.  Scoring is ``pipelines.localize``'s; the refit is plain
    DLT without the LM polish, so scores can differ slightly from
    ``score_candidates`` unless its ``refine_iters`` is 0."""
    pixels, pos3d, point_mask, cam_locs, grid_codes = _inputs(
        mesh.device, pixels, pos3d, point_mask, cam_locs, grid_codes)
    n_model = mesh.shape["model"]
    di = mesh_mod.axis_index(mesh, "data")
    mi = mesh_mod.axis_index(mesh, "model")
    locs_l = mesh_mod.block(mesh, cam_locs, "data")
    grid_l = mesh_mod.block(mesh, grid_codes, "data")
    msac_l, model_l, mask_l, _, pos2_l = _local_candidate_scores(
        pixels, pos3d, point_mask, locs_l, fold_seed(seed, di, mi),
        _local_rcfg(cfg.ransac, n_model))
    # Combine the hypothesis shards: all-gather over 'model', argmin MSAC.
    err1_l, err2_l = _combine_and_score(
        pixels, point_mask, mesh_mod.all_gather(mesh, msac_l, "model"),
        mesh_mod.all_gather(mesh, model_l, "model"),
        mesh_mod.all_gather(mesh, mask_l, "model"), pos2_l, grid_l, cfg)
    # Identical on every model rank; gather the candidate shards over 'data'.
    err1 = mesh_mod.all_gather(mesh, err1_l, "data").reshape(-1)
    err2 = mesh_mod.all_gather(mesh, err2_l, "data").reshape(-1)
    return _select(err1, err2)
