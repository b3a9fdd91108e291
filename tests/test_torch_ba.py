"""Dense-Schur bundle adjustment of the port (``ransac_tpu_torch.ba.bundle``)
against the JAX package on the CPU, on the same numpy-seeded inputs: the
JAX test's ``synth_ba`` scene (6 cameras, 60 points, cameras 1.. and the
points perturbed).

Tolerances: ``cost_fn`` rtol 1e-6; ``_blocks`` (r, Jc, Jp) rtol 1e-5, atol
1e-6, of the magnitude each entry is formed at: r's of the pixel it is a
difference of (r = pix - uv cancels: the two packages' float32 projections
of a 300 px pixel differ by a few ulp, 1e-4 px, which is 1e-3 of a 0.1 px
residual), a Jacobian entry's of its observation's block (a small entry is
a sum of terms of the block's size and carries their rounding); one ``_solve_schur`` at lambda 1e-3: dc and dp rtol 1e-3 (entries
below 1e-3 of the step's largest held to that); ``bundle_adjust`` over 15
passes (plain, and Huber 4 px with 1 in 15 observations shifted 80 px):
cost rtol 5e-2 / atol 1e-4, the non-gauge cameras atol 5e-3, the same pass
count, camera 0 unmoved.  The early exit is held to the fixed loop bit for
bit.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu.ba import bundle as jb
from ransac_tpu.ops import projection as jproj
from ransac_tpu.ops.rotation import exp_so3 as jexp
from ransac_tpu.utils.config import BundleAdjustConfig as JConfig
from ransac_tpu_torch.ba import bundle as tb
from ransac_tpu_torch.ops import lm as tlm
from ransac_tpu_torch.utils.config import BundleAdjustConfig
from torch_threads import one_torch_thread  # noqa: F401


def synth_ba(seed=0, n_cam=6, n_pt=60, pix_noise=0.0):
    """The JAX test's ``synth_ba`` (``tests/test_ba.py``): (JAX problem,
    the same arrays as numpy, true cameras)."""
    rng = np.random.default_rng(seed)
    K = np.array([[700.0, 0, 320.0], [0, 700.0, 240.0], [0, 0, 1.0]])
    pts = rng.uniform(-2, 2, size=(n_pt, 3)) * np.array([3, 3, 1]) + [0, 0, 8]
    cams = []
    for c in range(n_cam):
        rvec = rng.normal(size=3) * 0.1
        t = np.array([c * 0.8 - 2.0, 0.1 * rng.normal(), 0.0])
        cams.append(np.concatenate([rvec, t]))
    cams = np.array(cams)
    obs_cam, obs_pt, obs_uv = [], [], []
    for c in range(n_cam):
        pix, z = jproj.project_points(jnp.asarray(pts), jexp(jnp.asarray(cams[c, :3])),
                                      jnp.asarray(cams[c, 3:]), jnp.asarray(K))
        pix = np.asarray(pix)
        for i in np.where(np.asarray(z) > 0)[0]:
            obs_cam.append(c)
            obs_pt.append(i)
            obs_uv.append(pix[i] + rng.normal(scale=pix_noise, size=2))
    cams_init = cams.copy()
    cams_init[1:] += rng.normal(scale=0.01, size=cams_init[1:].shape)
    pts_init = pts + rng.normal(scale=0.05, size=pts.shape)
    arrays = (cams_init.astype(np.float32), pts_init.astype(np.float32),
              K.astype(np.float32), np.array(obs_cam, np.int32),
              np.array(obs_pt, np.int32), np.array(obs_uv, np.float32),
              np.ones(len(obs_cam), np.float32))
    return jb.BAProblem(*map(jnp.asarray, arrays)), tb.BAProblem(*arrays), cams


def with_outliers(jp, tp, every=15, shift=80.0):
    uv = np.array(tp.obs_uv)
    uv[::every] += shift
    return jp._replace(obs_uv=jnp.asarray(uv)), tp._replace(obs_uv=uv)


CASES = {"plain": 0.0, "huber": 4.0}


@pytest.fixture(scope="module")
def problems():
    jp, tp, cams = synth_ba(0)
    jo, to = with_outliers(jp, tp)
    return {"plain": (jp, tb.to_device(tp, "cpu"), cams),
            "huber": (jo, tb.to_device(to, "cpu"), cams)}


@pytest.mark.parametrize("case", CASES)
def test_cost_matches_jax(problems, case):
    jp, tp, _ = problems[case]
    s = CASES[case]
    cj = float(jb.cost_fn(jp, jp.cameras, jp.points, s))
    ct = tb.cost_fn(tp, tp.cameras, tp.points, s)
    assert ct.dtype == torch.float32
    np.testing.assert_allclose(float(ct), cj, rtol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_blocks_match_jax(problems, case):
    jp, tp, _ = problems[case]
    out_j = jb._blocks(jp, jp.cameras, jp.points, CASES[case])
    out_t = tb._blocks(tp, tp.cameras, tp.points, CASES[case])
    for name, j, t in zip(("r", "Jc", "Jp"), out_j, out_t):
        assert t.dtype == torch.float32 and t.shape == j.shape, name
        j, t = np.asarray(j), t.numpy()
        if name == "r":
            scale = np.abs(tp.obs_uv.numpy())
        else:
            scale = np.abs(j).max((-2, -1), keepdims=True)
        bad = np.abs(t - j) > 1e-6 + 1e-5 * scale
        assert not bad.any(), (name, np.abs(t - j)[bad].max(), bad.sum())


@pytest.mark.parametrize("fix_first", [True, False])
def test_solve_schur_matches_jax(problems, fix_first):
    jp, tp, _ = problems["plain"]
    C, P = tp.cameras.shape[0], tp.points.shape[0]
    dc_j, dp_j = jb._solve_schur(jp, *jb._blocks(jp, jp.cameras, jp.points, 0.0),
                                 1e-3, C, P, fix_first)
    dc_t, dp_t = tb._solve_schur(tp, *tb._blocks(tp, tp.cameras, tp.points, 0.0),
                                 torch.tensor(1e-3), C, P, fix_first)
    for j, t in ((dc_j, dc_t), (dp_j, dp_t)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-3, atol=1e-3 * np.abs(j).max())
    if fix_first:
        assert float(dc_t[0].abs().max()) == 0.0


@pytest.mark.parametrize("case", CASES)
def test_bundle_adjust_matches_jax(problems, case):
    jp, tp, cams_true = problems[case]
    s = CASES[case]
    rj = jb.bundle_adjust(jp, JConfig(max_iters=15, huber_scale=s))
    tb.reset_counts()
    rt = tb.bundle_adjust(tp, BundleAdjustConfig(max_iters=15, huber_scale=s), device="cpu")
    assert float(rt.cost) < 0.05 * float(rt.initial_cost)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=5e-2, atol=1e-4)
    np.testing.assert_allclose(rt.cameras[1:].numpy(), np.asarray(rj.cameras)[1:], atol=5e-3)
    np.testing.assert_array_equal(rt.cameras[0].numpy(), tp.cameras[0].numpy())
    assert int(rt.iterations) == int(rj.iterations) == 15
    # A float32 run with rtol 1e-8 cannot be done before pass 19: no read.
    assert tb.COUNTS == {"passes": 15, "reads": 0}
    if case == "plain":
        np.testing.assert_allclose(rt.cameras[1:].numpy(), cams_true[1:], atol=5e-3)


def test_first_read_follows_the_config():
    """The BA reads ``done`` from the first pass at which the damping can
    reach its cap (19 rejections from 1e-3 by 4) in float32, and from pass 1
    where a step can meet rtol."""
    f = BundleAdjustConfig()
    assert tlm._first_read(torch.float32, f.rtol, f.damping_init, f.damping_up,
                           tb.DAMPING_MAX) == 19
    assert tlm._first_read(torch.float64, f.rtol, f.damping_init, f.damping_up,
                           tb.DAMPING_MAX) == 1


def test_early_exit_equals_fixed_passes(problems, monkeypatch):
    """In float64 a run converges (rtol 1e-8) in 7 passes: read every
    CHECK_EVERY passes, it stops early with the fixed loop's result bit for
    bit."""
    _, tp, _ = problems["plain"]
    tp64 = tp._replace(cameras=tp.cameras.double(), points=tp.points.double(),
                       K=tp.K.double(), obs_uv=tp.obs_uv.double(), obs_w=tp.obs_w.double())
    cfg = BundleAdjustConfig(max_iters=16)
    tb.reset_counts()
    early = tb.bundle_adjust(tp64, cfg, device="cpu")
    counts = dict(tb.COUNTS)
    monkeypatch.setattr(tlm, "CHECK_EVERY", 0)
    tb.reset_counts()
    fixed = tb.bundle_adjust(tp64, cfg, device="cpu")
    assert tb.COUNTS == {"passes": 16, "reads": 0}
    assert counts["reads"] >= 1 and counts["passes"] < 16
    assert int(early.iterations) < 16
    for a, b in zip(early, fixed):
        assert torch.equal(a, b)


def test_ba_entry_points_default_to_the_card():
    """Every BA entry point runs on the card unless the caller asks for
    the CPU; where there is no CUDA the default fails."""
    from ransac_tpu_torch.ba import bench, posegraph, schur_cg

    fns = (tb.bundle_adjust, schur_cg.bundle_adjust_cg, posegraph.optimize_pose_graph,
           posegraph.optimize_pose_graph_sim3, bench.synth_slot_problem,
           bench.bench_ba_scale, bench.time_passes)
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    if not torch.cuda.is_available():
        _, tp, _ = synth_ba(0)
        with pytest.raises((AssertionError, RuntimeError)):
            tb.bundle_adjust(tp, BundleAdjustConfig(max_iters=1))
        with pytest.raises((AssertionError, RuntimeError)):
            bench.synth_slot_problem(4, 10, 2)
        assert bench.main(["4", "10", "2"]) == 2


def test_bench_json_on_the_cpu(capsys):
    """``python -m ransac_tpu_torch.ba.bench ... --device cpu`` prints the
    JAX bench's keys with the port's readings, at a tiny size."""
    import json

    from ransac_tpu_torch.ba import bench

    assert bench.main(["8", "300", "4", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("n_cam", "n_pt", "n_obs", "cg_iters", "sec_per_lm_iter", "lm_iters_per_s",
                "cost_initial", "cost_final"):
        assert key in out, key
    assert out["device"] == "cpu" and out["n_obs"] == 1200
    assert out["cost_final"] < out["cost_initial"]
    assert out["lm_reads"] == 0
