"""Edge-sharded pose-graph optimization (port of
``ransac_tpu.parallel.dist_posegraph``).

The edges shard over the mesh's ``data`` axis and the node poses are
replicated.  Each rank takes the Jacobian of its edges' residuals with
``torch.func.jacfwd`` and forms its share of the dense Gauss-Newton system;
one ``all_reduce`` of J^T J, J^T r and of the cost a pass is the only
traffic, and every rank runs the same damped solve (``torch.linalg.solve_ex``,
which reads nothing back) with node 0 pinned, for a fixed ``n_iters``.
Padding edges carry weight 0 and contribute nothing.  As in the JAX
functions, the Sim(3) translation floor is taken over each rank's own edges.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from ransac_tpu_torch.ba.posegraph import (PoseGraph, PoseGraphSim3, _graph_on,
                                           edge_residuals, edge_residuals_sim3)
from ransac_tpu_torch.parallel import mesh as mesh_mod
from ransac_tpu_torch.parallel.dist_ba import _pad, lm_passes


def _pad_edges(g: PoseGraph, mult: int) -> PoseGraph:
    """The graph with zero-weight edges (0 -> 0) appended up to a multiple
    of ``mult``."""
    pad = (-g.edge_i.shape[0]) % mult
    return g._replace(**{k: _pad(getattr(g, k), pad)
                         for k in ("edge_i", "edge_j", "edge_z", "edge_w")})


def _pad_edges_sim3(g: PoseGraphSim3, mult: int) -> PoseGraphSim3:
    pad = (-g.edge_i.shape[0]) % mult
    return g._replace(**{k: _pad(getattr(g, k), pad)
                         for k in ("edge_i", "edge_j", "edge_z", "edge_w", "edge_sw")})


def _sharded_gauss_newton(g, residuals, n: int, mesh: mesh_mod.Mesh, n_iters: int,
                          damping: float):
    """LM over the [V, n] poses of ``g`` (already padded) with its edges
    sharded over ``data``.  Returns (poses [V, n], cost)."""
    V = g.poses.shape[0]
    local = g._replace(**{k: mesh_mod.block(mesh, getattr(g, k), "data")
                          for k in g._fields if k != "poses"})
    poses0 = g.poses

    def psum(x):
        return mesh_mod.all_reduce(mesh, x, "data")

    def res_fn(x):
        poses = torch.cat([poses0[:1], x.reshape(V, n)[1:]])
        return residuals(local, poses).reshape(-1)

    fix = torch.ones(V * n, dtype=poses0.dtype, device=poses0.device)
    fix[:n] = 0.0

    def cost_of(x):
        return psum(0.5 * (res_fn(x[0]) ** 2).sum())

    def step(x, lam):
        (x,) = x
        r = res_fn(x)
        J = jacfwd(res_fn)(x)                                   # [n E_l, n V]
        JtJ = psum(J.T @ J)
        Jtr = psum(J.T @ r)
        dU = torch.clamp(JtJ.diagonal(), min=1e-8)
        A = JtJ + torch.diag(lam * dU)
        # Pin node 0: zero its rows and columns, unit diagonal.
        A = A * fix[:, None] * fix[None, :] + torch.diag(1.0 - fix)
        dx = torch.linalg.solve_ex(A, -Jtr * fix)[0]
        return (x + dx * fix,)

    x0 = (poses0.reshape(-1),)
    (x,), cost = lm_passes(cost_of, step, x0, cost_of(x0), damping, n_iters, lam_min=1e-12)
    return torch.cat([poses0[:1], x.reshape(V, n)[1:]]), cost


def distributed_pose_graph(g: PoseGraph, mesh: mesh_mod.Mesh, n_iters: int = 20,
                           damping: float = 1e-4):
    """LM over SE(3) node poses with node 0 pinned, the edges sharded over
    ``data``; called by every rank of the mesh with the same graph.
    Returns (poses [V,6], cost) on every rank."""
    g = _pad_edges(_graph_on(g, mesh.device), mesh.shape["data"])
    return _sharded_gauss_newton(g, edge_residuals, 6, mesh, n_iters, damping)


def distributed_pose_graph_sim3(g: PoseGraphSim3, mesh: mesh_mod.Mesh, n_iters: int = 30,
                                damping: float = 1e-4):
    """The Sim(3) form of ``distributed_pose_graph`` (7-dof nodes with a
    log-scale; ``edge_sw`` weighs each edge's scale row as given): node 0
    pins the similarity gauge.  Returns (poses [V,7], cost) on every rank."""
    g = _pad_edges_sim3(_graph_on(g, mesh.device), mesh.shape["data"])
    return _sharded_gauss_newton(g, edge_residuals_sim3, 7, mesh, n_iters, damping)
