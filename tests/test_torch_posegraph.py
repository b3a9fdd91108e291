"""SE(3) and Sim(3) pose graphs of the port (``ransac_tpu_torch.ba.posegraph``)
against the JAX package on the CPU, on the same numpy-seeded inputs.

Tolerances: the SE(3) / Sim(3) algebra rtol 1e-5 (atol 1e-6); the
optimized poses within atol 1e-3 of JAX's, on the JAX tests' graphs: the
12-node loop of ``tests/test_ba.py`` and the drifted circuits of
``tests/test_loop_closure.py`` (``io.synthetic.se3_loop_graph``,
``sim3_drift_graph``), the Sim(3) one with an even and an odd edge count
(its translation rows are normalized by the edges' median |t|, which
``jnp.median`` takes as the mean of the two middle values of an even
count).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu.ba import posegraph as jp
from ransac_tpu_torch.ba import posegraph as tp
from ransac_tpu_torch.io.synthetic import centered_ate, se3_loop_graph, sim3_drift_graph
from ransac_tpu_torch.ops import lm as tlm
from torch_threads import one_torch_thread  # noqa: F401


def random_poses(rng, n, k=6):
    p = np.concatenate([rng.normal(size=(n, 3)) * 0.3, rng.normal(size=(n, 3))], 1)
    if k == 7:
        p = np.concatenate([p, rng.normal(size=(n, 1)) * 0.2], 1)
    return p.astype(np.float32)


def close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


def test_se3_algebra_matches_jax():
    rng = np.random.default_rng(4)
    a, b = random_poses(rng, 64), random_poses(rng, 64)
    ta, tb_ = torch.tensor(a), torch.tensor(b)
    ja, jb_ = jnp.asarray(a), jnp.asarray(b)
    close(tp.compose(ta, tb_), jp.compose(ja, jb_))
    close(tp.invert(ta), jp.invert(ja))
    close(tp.relative(ta, tb_), jp.relative(ja, jb_))
    # (a*b)*b^-1 == a, as the JAX test holds it.
    np.testing.assert_allclose(tp.compose(tp.compose(ta, tb_), tp.invert(tb_)).numpy(), a,
                               atol=1e-5)


def test_sim3_algebra_matches_jax():
    rng = np.random.default_rng(5)
    a, b = random_poses(rng, 64, 7), random_poses(rng, 64, 7)
    ta, tb_ = torch.tensor(a), torch.tensor(b)
    ja, jb_ = jnp.asarray(a), jnp.asarray(b)
    close(tp.compose_sim3(ta, tb_), jp.compose_sim3(ja, jb_))
    close(tp.invert_sim3(ta), jp.invert_sim3(ja))
    close(tp.relative_sim3(ta, tb_), jp.relative_sim3(ja, jb_))
    close(tp.sim3_to_se3(ta), jp.sim3_to_se3(ja))


@pytest.mark.parametrize("n", [7, 8, 26])
def test_median_is_jnp_median(n):
    """``torch.median`` returns the lower middle value of an even count;
    the port takes the mean of the two, as ``jnp.median`` does."""
    x = np.random.default_rng(n).random(n).astype(np.float32)
    assert float(tp.median(torch.tensor(x))) == float(jnp.median(jnp.asarray(x)))
    if n % 2 == 0:
        assert float(tp.median(torch.tensor(x))) != float(torch.tensor(x).median())


def test_edge_residuals_match_jax():
    g, _, _ = sim3_drift_graph(16, n_loop=3)
    g3, _, _ = se3_loop_graph(16)
    close(tp.edge_residuals(tp._graph_on(g3, "cpu"), torch.tensor(g3.poses)),
          jp.edge_residuals(jp.PoseGraph(*map(jnp.asarray, g3)), jnp.asarray(g3.poses)))
    close(tp.edge_residuals_sim3(tp._graph_on(g, "cpu"), torch.tensor(g.poses)),
          jp.edge_residuals_sim3(jp.PoseGraphSim3(*map(jnp.asarray, g)),
                                 jnp.asarray(g.poses)))


def loop12():
    """The 12-node loop of the JAX test ``test_pose_graph_closes_loop``:
    noisy odometry (0.01) and one exact closure (weight 3); 12 edges."""
    rng = np.random.default_rng(5)
    V = 12

    def f(a):
        return torch.tensor(a, dtype=torch.float64)

    step = np.array([0.0, 0.02, 0.0, 1.0, 0.05, 0.0])
    true = [np.zeros(6)]
    for _ in range(1, V):
        true.append(tp.compose(f(step), f(true[-1])).numpy())
    true = np.array(true)
    ei, ej, ez, ew, noisy = [], [], [], [], [true[0]]
    for i in range(V - 1):
        z = tp.relative(f(true[i]), f(true[i + 1])).numpy() + rng.normal(scale=0.01, size=6)
        ei.append(i), ej.append(i + 1), ez.append(z), ew.append(1.0)
        noisy.append(tp.compose(f(z), f(noisy[-1])).numpy())
    ei.append(0), ej.append(V - 1), ew.append(3.0)
    ez.append(tp.relative(f(true[0]), f(true[-1])).numpy())
    g = tp.PoseGraph(np.array(noisy, np.float32), np.array(ei, np.int32),
                     np.array(ej, np.int32), np.array(ez, np.float32), np.array(ew, np.float32))
    return g, true


@pytest.mark.parametrize("graph", ["loop12", "circuit"])
def test_optimize_pose_graph_matches_jax(graph):
    if graph == "loop12":
        g, true = loop12()
        max_iters = 40
    else:
        g, true, _ = se3_loop_graph(16)
        max_iters = 30
    pj, cj, _ = jp.optimize_pose_graph(jp.PoseGraph(*map(jnp.asarray, g)), max_iters=max_iters)
    tlm.reset_counts()
    pt, ct, it = tp.optimize_pose_graph(g, max_iters=max_iters, device="cpu")
    assert pt.dtype == torch.float32 and pt.shape == g.poses.shape
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-3)
    np.testing.assert_array_equal(pt[0].numpy(), g.poses[0])
    assert float(ct) < 1e-2 and int(it) <= tlm.COUNTS["passes"] <= max_iters
    if graph == "loop12":
        drift_before = np.linalg.norm(g.poses[-1, 3:] - true[-1, 3:])
        assert np.linalg.norm(pt[-1, 3:].numpy() - true[-1, 3:]) < 0.5 * drift_before
    else:
        assert centered_ate(pt.numpy(), true) < centered_ate(g.poses, true)


@pytest.mark.parametrize("n_loop", [3, 2])
def test_optimize_pose_graph_sim3_matches_jax(n_loop):
    """The scale-drift repair of the JAX test on a 16-node circuit: 18
    edges (even) with 3 closures, 17 (odd) with 2."""
    g, gt, drifted = sim3_drift_graph(16, n_loop=n_loop)
    assert len(g.edge_i) == 15 + n_loop
    pj, cj, _ = jp.optimize_pose_graph_sim3(jp.PoseGraphSim3(*map(jnp.asarray, g)),
                                            max_iters=60)
    pt, ct, _ = tp.optimize_pose_graph_sim3(g, max_iters=60, device="cpu")
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-3)
    fixed = tp.sim3_to_se3(pt).double().numpy()
    assert centered_ate(fixed, gt) < 0.5 * centered_ate(drifted, gt)


def test_pose_graph_entry_points_default_to_the_card():
    for fn in (tp.optimize_pose_graph, tp.optimize_pose_graph_sim3):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        g, _ = loop12()
        with pytest.raises((AssertionError, RuntimeError)):
            tp.optimize_pose_graph(g, max_iters=1)
