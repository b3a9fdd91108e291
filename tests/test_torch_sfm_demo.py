"""The SfM demo of the port (``ransac_tpu_torch.pipelines.sfm_demo``, ``cli
sfm --demo``) and its keyframe front end (``parallel.sharded_frontend``,
``parallel.mesh``) against the JAX package on the CPU.

The front end is held on the JAX parallel test's frames (``_synth_frames``,
8 frames of 64 x 64, 64 keypoints) at the decision level, as two-view is:
>= 95% of the keypoints in common within 1e-3 px, >= 90% of the matches.
JAX's ``detect_harris`` defaults to ``approx_topk=True``, which is exact
on the CPU, as the port's selection always is.  ``matches_to_tracks`` and
the rendered frames are held exactly.

Each package's demo runs once at 8 frames (seed 0, one device), in a module
fixture (the JAX one ~50 s, most of it compiles): the same frames
registered, tracks and observations within 10%, both ATEs finite and the
port's at most max(1.5 x JAX's, 5% of the trajectory).  The 64-frame line
and loop demos against JAX's CPU runs are marked ``slow``, as the JAX
package marks its own demo test.
"""

import json

import numpy as np
import pytest
import torch

from ransac_tpu_torch import cli as tcli
from ransac_tpu_torch.parallel import mesh as tmesh
from ransac_tpu_torch.parallel import sharded_frontend as tfe
from ransac_tpu_torch.pipelines import sfm_demo as tdemo
from ransac_tpu_torch.utils.config import TwoViewConfig
from torch_threads import one_torch_thread  # noqa: F401

FE_CFG = TwoViewConfig(max_keypoints=64, nms_radius=3, patch_size=8)


def synth_frames(F=8, H=64, W=64, seed=3):
    """The JAX parallel test's ``_synth_frames`` (``tests/test_parallel.py``):
    smooth textured frames with a drifting pattern."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((H + 16, W + 16))
    k = np.ones(5) / 5.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, base)
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    yy, xx = np.mgrid[0:H + 16, 0:W + 16]
    base = base * 3 + 0.5 * np.sin(yy / 2.1) * np.sin(xx / 2.3)
    return np.stack([base[f:f + H, f:f + W] for f in range(F)]).astype(np.float32)


@pytest.fixture(scope="module")
def frontends():
    """(JAX arrays, port tensors) of the front end on ``synth_frames``."""
    import jax.numpy as jnp

    from ransac_tpu.parallel import sharded_frontend as jfe

    imgs = synth_frames()
    xy, valid, desc = jfe.frontend_frames(jnp.asarray(imgs), FE_CFG.max_keypoints,
                                          FE_CFG.nms_radius, FE_CFG.harris_k,
                                          FE_CFG.patch_size)
    idx2, mvalid = jfe.match_consecutive(xy, valid, desc, FE_CFG.match_ratio)
    jax_out = tuple(np.asarray(a) for a in (xy, valid, desc, idx2, mvalid))
    t = torch.from_numpy(imgs)
    txy, tvalid, tdesc = tfe.frontend_frames(t, FE_CFG.max_keypoints, FE_CFG.nms_radius,
                                             FE_CFG.harris_k, FE_CFG.patch_size)
    tidx2, tmvalid = tfe.match_consecutive(txy, tvalid, tdesc, FE_CFG.match_ratio)
    return imgs, jax_out, (txy, tvalid, tdesc, tidx2, tmvalid)


def keypoint_map(xy_j, v_j, xy_t, v_t, tol=1e-3):
    """{JAX slot: port slot} of the valid keypoints within ``tol`` px."""
    out = {}
    pt = xy_t[v_t]
    slots = np.nonzero(v_t)[0]
    for k in np.nonzero(v_j)[0]:
        d = np.linalg.norm(pt - xy_j[k], axis=1)
        if len(d) and d.min() <= tol:
            out[k] = slots[int(d.argmin())]
    return out


def assert_frontend_agrees(jax_out, port_out):
    """The port's front end (numpy ``xy, valid, desc, idx2, mvalid``) holds
    the JAX one's: >= 95% of the keypoints within 1e-3 px, the valid count
    within 5%, >= 90% of the matches, the match count within 10%."""
    xy, valid, _, idx2, mvalid = jax_out
    txy, tvalid, _, tidx2, tmvalid = port_out
    F = xy.shape[0]
    maps = [keypoint_map(xy[f], valid[f], txy[f], tvalid[f]) for f in range(F)]
    n_j = int(valid.sum())
    assert sum(len(m) for m in maps) >= 0.95 * n_j, (sum(len(m) for m in maps), n_j)
    assert abs(int(tvalid.sum()) - n_j) <= 0.05 * n_j
    common = total = 0
    for f in range(F - 1):
        for k in np.nonzero(mvalid[f])[0]:
            total += 1
            a, b = maps[f].get(k), maps[f + 1].get(idx2[f, k])
            common += a is not None and b is not None and bool(tmvalid[f, a]) \
                and tidx2[f, a] == b
    assert total > 20
    assert common >= 0.90 * total, (common, total)
    assert abs(int(tmvalid.sum()) - total) <= 0.10 * total


def test_frontend_keypoints_and_matches_match_jax(frontends):
    _, jax_out, port = frontends
    assert_frontend_agrees(jax_out, tuple(a.numpy() for a in port))


def test_distributed_frontend_equals_frames_and_matches(frontends):
    imgs, _, (txy, tvalid, tdesc, tidx2, tmvalid) = frontends
    mesh = tmesh.make_mesh(1, data=1, model=1, device="cpu")
    xy, valid, desc, idx2, mvalid = tfe.distributed_frontend(imgs, mesh, FE_CFG)
    assert torch.equal(xy, txy) and torch.equal(valid, tvalid) and torch.equal(desc, tdesc)
    assert torch.equal(mvalid[:-1], tmvalid)
    assert torch.equal(idx2[:-1][tmvalid], tidx2[tmvalid])
    assert not mvalid[-1].any()
    assert tmvalid.sum() > 20


def test_matches_to_tracks_equals_jax(frontends):
    from ransac_tpu.parallel.sharded_frontend import matches_to_tracks

    _, (xy, _, _, idx2, mvalid), _ = frontends
    for min_len in (2, 3):
        want = matches_to_tracks(xy, idx2, mvalid, min_len=min_len)
        got = tfe.matches_to_tracks(torch.tensor(xy), torch.tensor(idx2),
                                    torch.tensor(mvalid), min_len=min_len)
        assert list(got) == list(want) and len(want) > 20
        for k in want:
            assert got[k].dtype == np.float64 and np.array_equal(got[k], want[k])


def test_mesh_is_one_device_and_refuses_more():
    """With no process group a mesh is this process's one device, the
    demo's default; a mesh of more devices than the world's ranks raises
    (``tests/test_torch_parallel.py`` runs the meshes of a 4-rank world)."""
    assert not torch.distributed.is_initialized()
    m = tmesh.make_mesh(1, data=1, model=1, device="cpu")
    assert m.shape == {"data": 1, "model": 1} and len(m.devices) == 1
    assert m.device == torch.device("cpu") and m.member and m.device_mesh is None
    assert tmesh.make_mesh(device="cpu").shape == {"data": 1, "model": 1}
    x = torch.arange(3.0)
    assert tmesh.all_reduce(m, x, "data") is x and tmesh.axis_index(m, "model") == 0
    assert torch.equal(tmesh.all_gather(m, x, "data"), x[None])
    assert torch.equal(tmesh.from_right(m, x, "data"), torch.zeros(3))
    for kw in ({"n_devices": 2}, {"n_devices": 4, "data": 4, "model": 1},
               {"n_devices": 2, "data": 2, "model": 1}):
        with pytest.raises(ValueError, match="process group"):
            tmesh.make_mesh(device="cpu", **kw)
    with pytest.raises(ValueError, match="is not 1 devices"):
        tmesh.make_mesh(1, data=2, model=1, device="cpu")


@pytest.mark.parametrize("loop", [False, True])
def test_synth_trajectory_frames_equal_jax(loop):
    from ransac_tpu.pipelines.sfm_demo import synth_trajectory_frames

    kw = dict(F=6, H=64, W=80, n_pts=120, seed=4, loop=loop)
    for a, b in zip(tdemo.synth_trajectory_frames(**kw), synth_trajectory_frames(**kw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_umeyama_ate_and_centers_equal_jax():
    from ransac_tpu.pipelines import sfm_demo as jdemo

    rng = np.random.default_rng(0)
    poses = {f: rng.normal(size=6) for f in range(7)}
    np.testing.assert_allclose(tdemo._cam_centers(poses), jdemo._cam_centers(poses),
                               rtol=1e-12, atol=1e-12)
    est, gt = rng.normal(size=(7, 3)), rng.normal(size=(7, 3))
    assert tdemo._umeyama_ate(est, gt) == pytest.approx(jdemo._umeyama_ate(est, gt),
                                                        rel=1e-12)


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    """JAX's ``run_demo(frames=8, seed=0, device_counts=[1])`` and the port's
    ``cli sfm --demo 8 --device cpu --out`` (its JSON), once each."""
    from ransac_tpu.pipelines.sfm_demo import run_demo

    jax_out = run_demo(frames=8, seed=0, device_counts=[1])
    path = tmp_path_factory.mktemp("demo") / "demo.json"
    assert tcli.main(["sfm", "--demo", "8", "--device", "cpu", "--out", str(path)]) == 0
    return jax_out, json.loads(path.read_text())


def test_demo_matches_jax(demos):
    j, t = demos
    assert t["frames"] == j["frames"] == 8
    assert t["registered"] == j["registered"]
    for key in ("tracks", "observations"):
        assert abs(t[key] - j[key]) <= 0.10 * j[key], (key, t[key], j[key])
    assert np.isfinite(j["ate_frac"]) and np.isfinite(t["ate_frac"])
    assert t["ate_frac"] <= max(1.5 * j["ate_frac"], 0.05), (t["ate_frac"], j["ate_frac"])
    assert t["platform"] == "cpu" and t["loop_edges"] == 0
    assert t["posegraph_committed"] is None and t["ate_no_posegraph"] is None


def test_cli_demo_out_has_jax_keys(demos):
    j, t = demos
    assert set(t) == (set(j) - {"report"}) | {"slots"}
    s = t["slots"]
    assert 0 < s["live"] <= s["total"] == s["D"] * s["P"]
    assert len(t["frontend"]) == 1 and t["frontend"][0][0] == 1


def test_missing_card_exit_code_2_and_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["sfm", "--demo", "8"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdemo.run_demo(frames=8)
    assert tcli.main(["sfm", "--device", "cpu"]) == 2


@pytest.mark.slow
@pytest.mark.parametrize("loop", [False, True])
def test_demo_64_matches_jax(loop, tmp_path):
    """The 64-frame demos of ``cli sfm --demo 64 [--loop]``, seed 0, on
    the CPU (minutes each side)."""
    from ransac_tpu.pipelines.sfm_demo import run_demo

    j = run_demo(frames=64, seed=0, device_counts=[1], loop=loop)
    t = tdemo.run_demo(frames=64, seed=0, loop=loop, device="cpu")
    assert t["registered"] == j["registered"] == 64
    for key in ("tracks", "observations"):
        assert abs(t[key] - j[key]) <= 0.10 * j[key], (key, t[key], j[key])
    assert np.isfinite(t["ate_frac"])
    assert t["ate_frac"] <= max(1.5 * j["ate_frac"], 0.05), (t["ate_frac"], j["ate_frac"])


def test_line_demo_bootstrap_sweep_matches_jax():
    """The 64-frame line demo's bootstrap pool (frames 0 and 8, seed 0's
    first RANSAC seed) through the fused 8-point sweep: the port's plain
    version of kernel row 8 keeps the inlier set JAX's sweep (interpreted)
    keeps on the same inputs and seed.  On this pool the sweep keeps all
    25 matches, one of which the stage-wise engine's model puts 26 px off:
    the card's line demo, which bootstraps through row 8, starts from that
    point."""
    import jax.numpy as jnp

    from ransac_tpu.models import ransac as jr
    from ransac_tpu.utils.config import RansacConfig as JCfg
    from ransac_tpu_torch.models import ransac as tr
    from ransac_tpu_torch.pipelines import sfm as tsfm
    from ransac_tpu_torch.utils.config import RansacConfig
    from ransac_tpu_torch.utils.prng import fold_seed

    imgs, K, _, _ = tdemo.synth_trajectory_frames(F=64, seed=0)
    cfg = TwoViewConfig(max_keypoints=256, nms_radius=3, patch_size=8)
    out = tfe.distributed_frontend(imgs[:9], tmesh.make_mesh(1, device="cpu"), cfg)
    tracks = tfe.matches_to_tracks(out[0], out[3], out[4], min_len=3)
    common = sorted(t for t in {t for f, t in tracks if f == 0} if (8, t) in tracks)
    x1, x2, w, e_cfg, nb = tsfm._essential_inputs(
        tracks, 0, 8, common, torch.tensor(K, dtype=torch.float32),
        RansacConfig(threshold=4.0, num_hypotheses=2048, exhaustive=False), float(K[0, 0]))
    # The sweeps read their seed mod 2^32; JAX takes it as an int32.
    seed = fold_seed(0, 1) % 2 ** 32
    got = tr.ransac_essential_sweep(x1, x2, w, e_cfg, fold_seed(0, 1))
    want = jr.ransac_essential_sweep(
        jnp.asarray(x1.numpy()), jnp.asarray(x2.numpy()), jnp.asarray(w.numpy()),
        JCfg(threshold=e_cfg.threshold, num_hypotheses=2048, exhaustive=False),
        seed - 2 ** 32 if seed >= 2 ** 31 else seed, interpret=True)
    assert (len(common), nb) == (25, 32)
    np.testing.assert_array_equal(got.inlier_mask.numpy(), np.asarray(want.inlier_mask))
    assert int(got.best_index) == int(want.best_index)
    assert int(got.num_inliers) == 25
