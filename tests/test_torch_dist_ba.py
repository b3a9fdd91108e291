"""The port's distributed bundle adjustment and pose graphs
(``parallel.dist_ba``, ``parallel.dist_posegraph``) and the ``cam_psum``
hook of ``ba.schur_cg._schur_cg_step`` against the JAX package on the CPU.

The port runs once, in 4 spawned gloo ranks (``torch_ranks.spawn``, a
module fixture), each case over 4 ranks and on the primary's 1-rank
sub-mesh; the JAX references once on 4 of conftest's 8 virtual CPU
devices.  Holds:

- ``cam_psum`` None, the identity and a counting identity give the same
  step bit for bit, the counter seeing U / gc, the rhs and every operator
  application; the dense Schur step's ``psum`` hook likewise;
- dense and CG distributed BA (8 cameras, 24 / 64 points): 4 ranks
  against JAX's 4 devices and against 1 rank, cost within rtol 1e-3,
  cameras within rtol 5e-3 and atol 5e-4 (the dryrun's tolerances);
- SE(3) and Sim(3) pose graphs (the JAX loop-closure tests' circuits):
  poses and cost within 1e-3 of JAX's and of 1 rank (Sim(3): the centred
  ATE within 1e-3 of 1 rank's, each rank flooring its translation rows at
  its own edges' median as JAX's shards do); the centred ATE below half
  the drifted chain's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from ransac_tpu.ba import posegraph as jpg
from ransac_tpu.ba import schur_cg as jc
from ransac_tpu.parallel import dist_ba as jdba
from ransac_tpu.parallel import dist_posegraph as jdpg
from ransac_tpu.parallel.mesh import make_mesh as jmake_mesh
from ransac_tpu_torch.ba import bundle as tb
from ransac_tpu_torch.ba import schur_cg as tc
from ransac_tpu_torch.ba.posegraph import sim3_to_se3
from ransac_tpu_torch.io.synthetic import centered_ate, se3_loop_graph, sim3_drift_graph
from tests.test_torch_ba import synth_ba
from tests.test_torch_schur_cg import synth_problem as synth_slots
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
N_ITERS = {"dense": 5, "cg": 5, "se3": 20, "sim3": 40}


def problems():
    """(JAX, numpy) of each case: the dense BA problem, the slot problem,
    the SE(3) and Sim(3) graphs (with their truth and drifted chains)."""
    jd, td, _ = synth_ba(seed=1, n_cam=8, n_pt=24, pix_noise=0.5)
    js, ts = synth_slots(n_cam=8, n_pt=64, seed=2)
    g3, gt3, drift3 = se3_loop_graph(32)
    g7, gt7, drift7 = sim3_drift_graph(24)
    return {"dense": (jd, td), "cg": (jc.from_ba_problem(js), tc.from_ba_problem(ts)),
            "se3": (jpg.PoseGraph(*map(jnp.asarray, g3)), g3, gt3, drift3),
            "sim3": (jpg.PoseGraphSim3(*map(jnp.asarray, g7)), g7, gt7, drift7)}


def _arrays(p):
    return tuple(a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in p)


@pytest.fixture(scope="module")
def cases():
    return problems()


@pytest.fixture(scope="module")
def ranks(cases):
    """Every rank's results of ``torch_ranks.ba_cases``."""
    return torch_ranks.spawn("ba_cases", WORLD, _arrays(cases["dense"][1]),
                             _arrays(cases["cg"][1]), _arrays(cases["se3"][1]),
                             _arrays(cases["sim3"][1]), N_ITERS)


@pytest.fixture(scope="module")
def jax_runs(cases):
    """JAX's distributed functions on 4 virtual CPU devices."""
    mesh = jmake_mesh(WORLD, data=WORLD, model=1)
    jd = cases["dense"][0]
    pad = (-jd.obs_cam.shape[0]) % WORLD
    pz = lambda a: jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])  # noqa: E731
    jd = jd._replace(obs_cam=pz(jd.obs_cam), obs_pt=pz(jd.obs_pt), obs_uv=pz(jd.obs_uv),
                     obs_w=pz(jd.obs_w))
    out = {"dense": jdba.distributed_bundle_adjust(jd, mesh, n_iters=N_ITERS["dense"]),
           "cg": jdba.distributed_bundle_adjust_cg(cases["cg"][0], mesh,
                                                   n_iters=N_ITERS["cg"]),
           "se3": jdpg.distributed_pose_graph(cases["se3"][0], mesh, n_iters=N_ITERS["se3"]),
           "sim3": jdpg.distributed_pose_graph_sim3(cases["sim3"][0], mesh,
                                                    n_iters=N_ITERS["sim3"])}
    return jax.tree.map(np.asarray, out)


def test_cam_psum_default_is_the_identity(cases):
    """``_schur_cg_step`` with ``cam_psum`` None, the identity, or an
    identity that counts its calls: the same (dc, dp) bit for bit; the hook
    sees U / gc, the rhs and each of the 24 operator applications."""
    st = tc.to_device(cases["cg"][1], "cpu")
    C = st.cameras.shape[0]
    r, Jc, Jp = tc._slot_blocks(st, st.cameras, st.points, 0.0)
    calls = []

    def counting(x):
        calls.append(tuple(x.shape))
        return x

    lam = torch.tensor(1e-3)
    base = tc._schur_cg_step(st, r, Jc, Jp, lam, C, True, 24)
    for hook in (None, lambda x: x, counting):
        got = tc._schur_cg_step(st, r, Jc, Jp, lam, C, True, 24, cam_psum=hook)
        for a, b in zip(base, got):
            assert torch.equal(a, b)
    assert calls == [(C, 27), (C, 6)] + [(C, 6)] * 24


def test_dense_schur_psum_default_is_the_identity(cases):
    tp = tb.to_device(cases["dense"][1], "cpu")
    C, P = tp.cameras.shape[0], tp.points.shape[0]
    blocks = tb._blocks(tp, tp.cameras, tp.points, 0.0)
    lam = torch.tensor(1e-3)
    calls = []
    base = tb._solve_schur(tp, *blocks, lam, C, P, True)
    got = tb._solve_schur(tp, *blocks, lam, C, P, True,
                          psum=lambda x: calls.append(tuple(x.shape)) or x)
    for a, b in zip(base, got):
        assert torch.equal(a, b)
    assert calls == [(C, 6, 6), (P, 3, 3), (C, 6), (P, 3), (C * P, 6, 3), (C * P, 6, 3),
                     (P, 3)]


@pytest.mark.parametrize("case", ["dense", "cg"])
def test_distributed_ba_matches_jax_and_one_rank(ranks, jax_runs, cases, case):
    cams_j, pts_j, cost_j = jax_runs[case]
    cams_1, pts_1, cost_1 = ranks[0][case + "_1"]
    for r in ranks:
        cams, pts, cost = r[case + "_4"]
        assert cams.dtype == np.float32 and pts.shape == pts_j.shape
        for want_cams, want_cost in ((cams_j, cost_j), (cams_1, cost_1)):
            np.testing.assert_allclose(cost, want_cost, rtol=1e-3, atol=1e-5)
            np.testing.assert_allclose(cams, want_cams, rtol=5e-3, atol=5e-4)
        np.testing.assert_array_equal(cams, ranks[0][case + "_4"][0])
    if case == "dense":
        p = tb.to_device(cases[case][1], "cpu")
        init = tb.cost_fn(p, p.cameras, p.points)
    else:
        p = tc.to_device(cases[case][1], "cpu")
        init = tc.slot_cost(p, p.cameras, p.points)
    assert float(cost_1) < 0.5 * float(init)


@pytest.mark.parametrize("case", ["se3", "sim3"])
def test_distributed_pose_graphs_match_jax_and_one_rank(ranks, jax_runs, cases, case):
    poses_j, cost_j = jax_runs[case]
    poses_1, cost_1 = ranks[0][case + "_1"]
    _, _, gt, drifted = cases[case]
    to_se3 = (lambda p: sim3_to_se3(torch.from_numpy(p)).numpy()) if case == "sim3" \
        else (lambda p: p)
    for r in ranks:
        poses, cost = r[case + "_4"]
        assert poses.shape == poses_j.shape
        np.testing.assert_allclose(poses, poses_j, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(cost, cost_j, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(cost, cost_1, rtol=1e-3, atol=1e-3)
        if case == "se3":
            np.testing.assert_allclose(poses, poses_1, rtol=1e-3, atol=1e-3)
        else:
            # Each rank floors its translation rows at its own edges' median,
            # as JAX's shards do: against one rank, the ATE within 1e-3, as the
            # dryrun holds JAX's.
            assert abs(centered_ate(to_se3(poses), gt) - centered_ate(to_se3(poses_1), gt)) \
                < 1e-3
    ate = centered_ate(to_se3(ranks[0][case + "_4"][0]), gt)
    assert ate < 0.5 * centered_ate(drifted, gt), (ate, centered_ate(drifted, gt))
