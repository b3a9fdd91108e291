"""SE(3) and Sim(3) pose-graph optimization (port of
``ransac_tpu.ba.posegraph``).

Node poses T_i = (R_i, t_i) world->camera as [V, 6] (rvec, tvec); an edge
(i, j) with measured relative transform Z_ij contributes the residual

    r_ij = log( Z_ij^-1 * T_j * T_i^-1 )        (6-vector)

through the port's LM (``ops.lm.levenberg_marquardt``) on a batch of one
(x0 [1, 6V]; above 16 parameters its step is ``solve_spd_gj``), with the
gauge fixed by pinning node 0.  The Sim(3) graph adds a log-scale per node
(ORB-SLAM-style loop closing: optimize over Sim(3), then flatten each node
back to SE(3) as (R, t / s)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ransac_tpu_torch.ba.bundle import tensor_on
from ransac_tpu_torch.ops.lm import levenberg_marquardt
from ransac_tpu_torch.ops.rotation import exp_so3, log_so3


class PoseGraph(NamedTuple):
    poses: torch.Tensor      # [V,6] (rvec, tvec), world->camera
    edge_i: torch.Tensor     # [E]
    edge_j: torch.Tensor     # [E]
    edge_z: torch.Tensor     # [E,6] measured relative pose j<-i (rvec, tvec)
    edge_w: torch.Tensor     # [E] weights


class PoseGraphSim3(NamedTuple):
    """Sim(3) pose graph: nodes (rvec, tvec, log_s) [V,7]; an edge measures
    the relative similarity j <- i, its relative scale included.
    ``edge_sw`` weighs each edge's scale residual: monocular odometry does
    not observe the relative scale of consecutive frames, so odometry edges
    carry 0 and loop closures measured with map anchors 1."""
    poses: torch.Tensor      # [V,7] (rvec, tvec, log_s), world->camera
    edge_i: torch.Tensor     # [E]
    edge_j: torch.Tensor     # [E]
    edge_z: torch.Tensor     # [E,7] measured relative similarity j<-i
    edge_w: torch.Tensor     # [E]
    edge_sw: torch.Tensor    # [E]


def _rotate(R, v):
    return (R @ v[..., None])[..., 0]


def compose(a6: torch.Tensor, b6: torch.Tensor) -> torch.Tensor:
    """SE(3) composition c = a * b in (rvec, tvec) form: R_c = R_a R_b,
    t_c = R_a t_b + t_a."""
    Ra = exp_so3(a6[..., :3])
    Rb = exp_so3(b6[..., :3])
    return torch.cat([log_so3(Ra @ Rb), _rotate(Ra, b6[..., 3:6]) + a6[..., 3:6]], -1)


def invert(a6: torch.Tensor) -> torch.Tensor:
    Rinv = exp_so3(a6[..., :3]).transpose(-1, -2)
    return torch.cat([log_so3(Rinv), -_rotate(Rinv, a6[..., 3:6])], -1)


def relative(a6: torch.Tensor, b6: torch.Tensor) -> torch.Tensor:
    """T_b * T_a^-1: the relative transform taking frame a to frame b."""
    return compose(b6, invert(a6))


def edge_residuals(g: PoseGraph, poses: torch.Tensor) -> torch.Tensor:
    """[..., E, 6] residuals of poses [..., V, 6]."""
    pred = relative(poses[..., g.edge_i, :], poses[..., g.edge_j, :])
    return compose(invert(g.edge_z), pred) * g.edge_w[:, None]


def compose_sim3(a7: torch.Tensor, b7: torch.Tensor) -> torch.Tensor:
    """Similarity composition c = a * b: R_c = R_a R_b, s_c = s_a s_b,
    t_c = s_a R_a t_b + t_a."""
    Ra = exp_so3(a7[..., :3])
    Rb = exp_so3(b7[..., :3])
    sa = torch.exp(a7[..., 6:7])
    tc = sa * _rotate(Ra, b7[..., 3:6]) + a7[..., 3:6]
    return torch.cat([log_so3(Ra @ Rb), tc, a7[..., 6:7] + b7[..., 6:7]], -1)


def invert_sim3(a7: torch.Tensor) -> torch.Tensor:
    Rinv = exp_so3(a7[..., :3]).transpose(-1, -2)
    sinv = torch.exp(-a7[..., 6:7])
    return torch.cat([log_so3(Rinv), -sinv * _rotate(Rinv, a7[..., 3:6]),
                      -a7[..., 6:7]], -1)


def relative_sim3(a7: torch.Tensor, b7: torch.Tensor) -> torch.Tensor:
    """S_b * S_a^-1: the relative similarity taking frame a to frame b."""
    return compose_sim3(b7, invert_sim3(a7))


def median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values of an even count
    (``torch.median`` returns the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def edge_residuals_sim3(g: PoseGraphSim3, poses: torch.Tensor) -> torch.Tensor:
    """[..., E, 7] residuals of poses [..., V, 7].  The scale row is
    weighted by ``edge_sw``; the translation rows are divided by each
    edge's measured |t|, floored at half the graph's median |t| (a loop
    closure's short baseline would otherwise outweigh every other row)."""
    err = compose_sim3(invert_sim3(g.edge_z),
                       relative_sim3(poses[..., g.edge_i, :], poses[..., g.edge_j, :]))
    t_norm = torch.linalg.vector_norm(g.edge_z[:, 3:6], dim=-1)
    floor = torch.clamp(0.5 * median(t_norm), min=1e-2)
    t_scale = torch.maximum(t_norm, floor)
    err = torch.cat([err[..., :3], err[..., 3:6] / t_scale[:, None],
                     err[..., 6:7] * g.edge_sw[:, None]], -1)
    return err * g.edge_w[:, None]


def _graph_on(g, device):
    """The graph's arrays as tensors on ``device``, the edge ends as int64."""
    g = type(g)(*(tensor_on(a, device) for a in g))
    return g._replace(edge_i=g.edge_i.long(), edge_j=g.edge_j.long())


def _optimize(g, residual_of, n: int, max_iters: int, damping_init: float):
    V = g.poses.shape[0]
    pin = g.poses[0]

    def pinned(x):
        poses = x.reshape(x.shape[0], V, n)
        return torch.cat([pin.expand(x.shape[0], 1, n), poses[:, 1:]], 1)

    def flat_residual(x):
        return residual_of(g, pinned(x)).flatten(1)

    res = levenberg_marquardt(flat_residual, g.poses.reshape(1, -1), max_iters=max_iters,
                              damping_init=damping_init)
    return pinned(res.x)[0], res.cost[0], res.iterations[0]


def optimize_pose_graph(g: PoseGraph, max_iters: int = 30, damping_init: float = 1e-4,
                        device="cuda"):
    """LM over all node poses with node 0 pinned, on ``device``.  Returns
    (poses [V,6], cost, iterations)."""
    g = _graph_on(g, device)
    return _optimize(g, edge_residuals, 6, max_iters, damping_init)


def optimize_pose_graph_sim3(g: PoseGraphSim3, max_iters: int = 40,
                             damping_init: float = 1e-4, scale_smooth: float = 1.0,
                             device="cuda"):
    """LM over Sim(3) node poses with node 0 pinned (the similarity gauge),
    on ``device``.  Returns (poses [V,7], cost, iterations).

    ``scale_smooth`` floors the scale-row weight of edges with ``edge_sw =
    0``: a smoothness prior saying per-step monocular scale drift is small
    (odometry z carries log-rel-scale 0), which still admits large
    accumulated drift."""
    g = _graph_on(g, device)
    g = g._replace(edge_sw=torch.clamp(g.edge_sw, min=scale_smooth))
    return _optimize(g, edge_residuals_sim3, 7, max_iters, damping_init)


def sim3_to_se3(poses7: torch.Tensor) -> torch.Tensor:
    """Flatten Sim(3) nodes to SE(3) camera poses (R, t / s): the node's
    scale is the local map-scale error (ORB-SLAM loop-closing convention)."""
    s = torch.exp(poses7[..., 6:7])
    return torch.cat([poses7[..., :3], poses7[..., 3:6] / s], -1)
