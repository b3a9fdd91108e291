"""Spawned ``torch.distributed`` ranks for the port's parallel tests.

``spawn(case, world, *args)`` starts ``world`` processes (``spawn``
start method, a gloo group on the CPU through a ``file://`` store in a
temporary directory, one torch thread each), runs ``case(*args)`` in every
rank and returns every rank's result (numpy, pickled by the ranks into the
temporary directory).  A failing rank fails the call, and so does a rank
still running at the deadline.  The cases below are the rank side of
``test_torch_parallel.py`` and ``test_torch_dist_ba.py``.  This module
imports nothing of JAX: the spawned children import it.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import torch

#: Seconds a spawned world may take before it is killed and the test fails.
DEADLINE_S = 600.0


def _host(x):
    """Tensors (also inside tuples, lists and dicts) as numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _rank_main(rank, world, case, directory, args):
    from ransac_tpu_torch.parallel.multihost import initialize_cluster, shutdown_cluster

    torch.set_num_threads(1)
    initialize_cluster(f"file://{os.path.join(directory, 'store')}", world, rank,
                       device="cpu", backend="gloo", timeout_s=120.0)
    try:
        out = _host(globals()[case](*args))
    finally:
        shutdown_cluster()
    with open(os.path.join(directory, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(case: str, world: int, *args, deadline_s: float = DEADLINE_S) -> list:
    """Every rank's ``case(*args)`` result, in rank order."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as directory:
        ctx = mp.start_processes(_rank_main, args=(world, case, directory, args),
                                 nprocs=world, join=False, start_method="spawn")
        end = time.monotonic() + deadline_s
        while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
            if time.monotonic() >= end:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{case}: {world} ranks still running after {deadline_s} s")
        out = []
        for r in range(world):
            with open(os.path.join(directory, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ------------------------------------------------------------ rank-side cases
def mesh_and_search_cases(search_problem, frames, fe_cfg) -> dict:
    """The mesh, its helpers, the candidate searches, the front end and the
    scaling harness in a world of 4 (every rank calls this)."""
    from ransac_tpu_torch.parallel import mesh as m
    from ransac_tpu_torch.parallel.multihost import is_primary, pod_mesh
    from ransac_tpu_torch.parallel.sharded_frontend import distributed_frontend
    from ransac_tpu_torch.parallel.sharded_search import (distributed_score_candidates,
                                                          emulate_hypothesis_sharded)
    from ransac_tpu_torch.utils.config import LocalizeConfig, RansacConfig
    from ransac_tpu_torch.utils.scaling import measure_frontend_scaling, measure_scaling

    out = {"rank": m.world_rank(), "primary": is_primary()}
    out["shapes"] = {n: m.make_mesh(n, device="cpu").shape for n in range(1, 5)}
    out["shapes_split"] = {(d, mo): m.make_mesh(4, data=d, model=mo, device="cpu").shape
                           for d, mo in ((4, 1), (2, 2), (1, 4))}
    out["pod"] = pod_mesh(device="cpu").shape
    try:
        m.make_mesh(5, device="cpu")
        out["too_many"] = "no error"
    except ValueError as e:
        out["too_many"] = str(e)

    mesh22 = m.make_mesh(4, data=2, model=2, device="cpu")
    r = m.world_rank()
    x = torch.tensor([r + 1.0, 10.0 * r])
    out["axis_index"] = (m.axis_index(mesh22, "data"), m.axis_index(mesh22, "model"))
    out["psum_data"] = m.all_reduce(mesh22, x, "data")
    out["gather_model"] = m.all_gather(mesh22, x, "model")
    out["gather_bool"] = m.all_gather(mesh22, torch.tensor([r % 2 == 0]), "model")
    out["from_right_data"] = m.from_right(mesh22, x, "data")

    pix, X, mask, cam_locs, grids = search_problem
    cfg_x = LocalizeConfig(ransac=RansacConfig(threshold=5.0, exhaustive=True,
                                               refine_iters=0))
    out["data_sharded"] = distributed_score_candidates(
        pix, X, mask, cam_locs, grids, cfg_x, 0, m.make_mesh(4, data=4, model=1, device="cpu"))
    cfg_h = LocalizeConfig(ransac=RansacConfig(threshold=5.0, num_hypotheses=2048,
                                               exhaustive=False))
    for d, mo in ((2, 2), (1, 4)):
        mesh = m.make_mesh(4, data=d, model=mo, device="cpu")
        out[f"hyp_{d}x{mo}"] = distributed_score_candidates(pix, X, mask, cam_locs, grids,
                                                            cfg_h, 0, mesh)
        if is_primary():
            out[f"emu_{d}x{mo}"] = emulate_hypothesis_sharded(
                pix, X, mask, cam_locs, grids, cfg_h, 0, d, mo, device="cpu")

    out["frontend_4"] = distributed_frontend(frames, m.make_mesh(4, data=4, model=1,
                                                                device="cpu"), fe_cfg)
    one = m.make_mesh(1, device="cpu")
    if one.member:
        out["frontend_1"] = distributed_frontend(frames, one, fe_cfg)
    out["scaling"] = [vars(p) for p in measure_scaling(
        [1, 2, 4], n_candidates=16, hypotheses=256, iters=1, device="cpu")]
    out["frontend_scaling"] = [vars(p) for p in measure_frontend_scaling(
        [1, 2, 4], img_hw=64, max_kp=64, iters=1, device="cpu")]
    return out


def ba_cases(ba_problem, slot_problem, se3_graph, sim3_graph, n_iters: dict) -> dict:
    """Dense and CG distributed BA and both pose graphs on 4 ranks and on
    the primary's 1-rank sub-mesh (every rank calls this)."""
    from ransac_tpu_torch.ba.bundle import BAProblem
    from ransac_tpu_torch.ba.posegraph import PoseGraph, PoseGraphSim3
    from ransac_tpu_torch.ba.schur_cg import BASlotProblem
    from ransac_tpu_torch.parallel import mesh as m
    from ransac_tpu_torch.parallel.dist_ba import (distributed_bundle_adjust,
                                                   distributed_bundle_adjust_cg)
    from ransac_tpu_torch.parallel.dist_posegraph import (distributed_pose_graph,
                                                          distributed_pose_graph_sim3)

    p, sp = BAProblem(*ba_problem), BASlotProblem(*slot_problem)
    g3, g7 = PoseGraph(*se3_graph), PoseGraphSim3(*sim3_graph)
    cases = {
        "dense": lambda mesh: distributed_bundle_adjust(p, mesh, n_iters=n_iters["dense"]),
        "cg": lambda mesh: distributed_bundle_adjust_cg(sp, mesh, n_iters=n_iters["cg"]),
        "se3": lambda mesh: distributed_pose_graph(g3, mesh, n_iters=n_iters["se3"]),
        "sim3": lambda mesh: distributed_pose_graph_sim3(g7, mesh, n_iters=n_iters["sim3"]),
    }
    four = m.make_mesh(4, data=4, model=1, device="cpu")
    one = m.make_mesh(1, device="cpu")
    out = {}
    for name, run in cases.items():
        out[name + "_4"] = run(four)
        if one.member:
            out[name + "_1"] = run(one)
    return out



def full_width_search(search_problem) -> dict:
    """The candidate-sharded exhaustive search on 4 x 1 (every rank calls
    this)."""
    from ransac_tpu_torch.parallel import mesh as m
    from ransac_tpu_torch.parallel.sharded_search import distributed_score_candidates
    from ransac_tpu_torch.utils.config import LocalizeConfig, RansacConfig

    cfg = LocalizeConfig(ransac=RansacConfig(threshold=75.0, exhaustive=True,
                                             refine_iters=0))
    return distributed_score_candidates(*search_problem, cfg, 0,
                                        m.make_mesh(4, data=4, model=1, device="cpu"))
