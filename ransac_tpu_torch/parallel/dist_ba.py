"""Distributed bundle adjustment over a mesh's ``data`` axis (port of
``ransac_tpu.parallel.dist_ba``).

- ``distributed_bundle_adjust``: the observations shard over ``data``;
  each rank accumulates its normal-equation blocks by ``index_add_`` (as
  ``ba.bundle`` does: the JAX function's one-hot contractions would make
  an [O, C, P] tensor), the sums are completed by ``all_reduce`` (U, V,
  gc, gp, then the cross terms, then W^T dc and the cost: the ``psum``
  hook of ``ba.bundle._solve_schur``), and the reduced camera system is
  solved on every rank by ``solve_spd_gj``.
- ``distributed_bundle_adjust_cg``: the point axis of the [D, P] slots
  shards over ``data`` and the cameras are replicated; the only traffic is
  the camera-side sums of ``ba.schur_cg._schur_cg_step`` through its
  ``cam_psum`` hook (no warm start, ``cg_tol`` 1e-4, as the JAX function).

Both run ``n_iters`` LM passes with the JAX functions' damping schedule and
no host read.  Padding (zero-weight observations or points) is added here
and contributes exactly nothing.  Every rank returns the whole result.
"""

from __future__ import annotations

import torch

from ransac_tpu_torch.ba import bundle, schur_cg
from ransac_tpu_torch.ba.bundle import BAProblem
from ransac_tpu_torch.parallel import mesh as mesh_mod


def lm_passes(cost_of, step, x0, cost0, damping: float, n_iters: int,
              lam_min: float = 1e-10):
    """``n_iters`` LM passes over a state tuple ``x0``: ``step(x, lam)``
    gives the candidate state, accepted where its ``cost_of`` falls
    (damping x 0.3 down to ``lam_min``, else x 5 up to 1e8), as the JAX
    functions' ``lax.scan``.  Returns (state, cost)."""
    x, cost = x0, cost0
    lam = torch.full((), damping, dtype=cost0.dtype, device=cost0.device)
    for _ in range(n_iters):
        x_new = step(x, lam)
        cost_new = cost_of(x_new)
        accept = cost_new < cost
        x = tuple(torch.where(accept, a, b) for a, b in zip(x_new, x))
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=lam_min),
                          torch.clamp(lam * 5.0, max=1e8))
        cost = torch.where(accept, cost_new, cost)
    return x, cost


def _pad(a: torch.Tensor, pad: int, dim: int = 0) -> torch.Tensor:
    """``a`` with ``pad`` zero entries appended along ``dim``."""
    if not pad:
        return a
    shape = list(a.shape)
    shape[dim] = pad
    return torch.cat([a, a.new_zeros(shape)], dim)


def distributed_bundle_adjust(p: BAProblem, mesh: mesh_mod.Mesh, n_iters: int = 10,
                              damping: float = 1e-3, huber_scale: float = 0.0,
                              fix_first_camera: bool = True):
    """LM bundle adjustment with the observations sharded over ``data``,
    called by every rank of the mesh with the same problem.  Returns
    (cameras [C,6], points [P,3], cost) on every rank."""
    p = bundle.to_device(p, mesh.device)
    n_cam, n_pt = p.cameras.shape[0], p.points.shape[0]
    pad = (-p.obs_cam.shape[0]) % mesh.shape["data"]
    pb = p._replace(**{k: mesh_mod.block(mesh, _pad(getattr(p, k), pad), "data")
                       for k in ("obs_cam", "obs_pt", "obs_uv", "obs_w")})

    def psum(x):
        return mesh_mod.all_reduce(mesh, x, "data")

    def cost_of(x):
        return psum(bundle.cost_fn(pb, x[0], x[1], huber_scale))

    def step(x, lam):
        cams, pts = x
        r, Jc, Jp = bundle._blocks(pb, cams, pts, huber_scale)
        dc, dp = bundle._solve_schur(pb, r, Jc, Jp, lam, n_cam, n_pt, fix_first_camera,
                                     psum=psum)
        return cams + dc, pts + dp

    x0 = (p.cameras, p.points)
    (cams, pts), cost = lm_passes(cost_of, step, x0, cost_of(x0), damping, n_iters)
    return cams, pts, cost


def distributed_bundle_adjust_cg(sp: schur_cg.BASlotProblem, mesh: mesh_mod.Mesh,
                                 n_iters: int = 10, cg_iters: int = 24,
                                 damping: float = 1e-3, huber_scale: float = 0.0,
                                 fix_first_camera: bool = True):
    """``ba.schur_cg.bundle_adjust_cg`` with the points (the P axis of the
    [D, P] slots) sharded over ``data``, called by every rank of the mesh
    with the same problem.  Returns (cameras [C,6], points [P,3], cost) on
    every rank."""
    sp = schur_cg.to_device(sp, mesh.device)
    n_cam, n_pt = sp.cameras.shape[0], sp.points.shape[0]
    pad = (-n_pt) % mesh.shape["data"]
    pts_l = mesh_mod.block(mesh, _pad(sp.points, pad), "data")
    local = sp._replace(
        points=pts_l,
        slot_cam=mesh_mod.block(mesh, _pad(sp.slot_cam, pad, 1), "data", 1),
        slot_uv=mesh_mod.block(mesh, _pad(sp.slot_uv, pad, 2), "data", 2),
        slot_w=mesh_mod.block(mesh, _pad(sp.slot_w, pad, 1), "data", 1))

    def psum(x):
        return mesh_mod.all_reduce(mesh, x, "data")

    def cost_of(x):
        return psum(schur_cg.slot_cost(local, x[0], x[1], huber_scale))

    def step(x, lam):
        cams, pts = x
        r, Jc, Jp = schur_cg._slot_blocks(local, cams, pts, huber_scale)
        dc, dp = schur_cg._schur_cg_step(local, r, Jc, Jp, lam, n_cam, fix_first_camera,
                                         cg_iters, cam_psum=psum)
        return cams + dc, pts + dp

    x0 = (sp.cameras, pts_l)
    (cams, pts), cost = lm_passes(cost_of, step, x0, cost_of(x0), damping, n_iters)
    points = mesh_mod.all_gather(mesh, pts, "data").flatten(0, 1)[:n_pt]
    return cams, points, cost
