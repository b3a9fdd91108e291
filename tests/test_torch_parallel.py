"""The port's ``parallel/`` over ``torch.distributed`` (``parallel.mesh``,
``parallel.multihost``, ``parallel.sharded_search``,
``parallel.sharded_frontend``, ``utils.scaling``, ``cli profile
--scaling-only``) against the JAX package on the CPU.

The port runs once, in 4 spawned gloo ranks (``torch_ranks.spawn``, a
module fixture), and the JAX references once on 4 of conftest's 8 virtual
CPU devices.  Holds:

- mesh shapes equal JAX's for 1-8 devices and explicit splits; more
  devices than ranks raises; the axis helpers give the psum, all-gather,
  ppermute hop and axis index of a 2 x 2 mesh;
- the data-sharded exhaustive search (4 x 1, ``tests/test_parallel.py``'s
  16-candidate problem): best 3 on both, err1 / err2 within rtol 2e-4 and
  atol 2e-3 of JAX's (the dryrun's tolerances);
- the hypothesis-sharded searches (2 x 2, 1 x 4) equal their one-device
  emulation: the same best, err within rtol 1e-5 and atol 1e-4, as JAX's
  own test holds it; the draws differ from JAX's, so against JAX only the
  decision (candidate 3);
- the front end over 4 ranks equals the 1-rank one bit for bit, holds
  JAX's 4-device one by ``test_torch_sfm_demo``'s criteria, and its tracks
  keep ``tests/test_parallel.py``'s invariants;
- the scaling harness gives a point a mesh size, ``report`` JAX's text.

The full-width search (the planted scene's 458 candidates, padded to 460)
against JAX's is marked ``slow``: a third spawned world and JAX's compile
at that width add ~20 s alone to the tier-1 budget, and the card's
``main_path_parallel`` holds the port there against its one-device search
on every run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from ransac_tpu.parallel import mesh as jmesh
from ransac_tpu.utils.config import LocalizeConfig as JLocalize
from ransac_tpu.utils.config import RansacConfig as JRansac
from ransac_tpu.utils.config import TwoViewConfig as JTwoView
from ransac_tpu_torch import cli as tcli
from ransac_tpu_torch.parallel import mesh as tmesh
from ransac_tpu_torch.parallel import multihost
from ransac_tpu_torch.parallel.sharded_frontend import matches_to_tracks
from ransac_tpu_torch.utils import scaling as tscaling
from tests.test_parallel import _synth_frames, synth_problem
from tests.test_torch_sfm_demo import FE_CFG, assert_frontend_agrees

WORLD = 4
SPLITS = ((2, 2), (1, 4))


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results of ``torch_ranks.mesh_and_search_cases``."""
    return torch_ranks.spawn("mesh_and_search_cases", WORLD, synth_problem(),
                             _synth_frames(F=8), FE_CFG)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's searches and front end on 4 virtual CPU devices."""
    from ransac_tpu.parallel.sharded_frontend import distributed_frontend
    from ransac_tpu.parallel.sharded_search import distributed_score_candidates

    args = tuple(jnp.asarray(a) for a in synth_problem())
    key = jax.random.key(0)
    cfg_x = JLocalize(ransac=JRansac(threshold=5.0, exhaustive=True, refine_iters=0))
    cfg_h = JLocalize(ransac=JRansac(threshold=5.0, num_hypotheses=2048, exhaustive=False))
    out = {"data_sharded": distributed_score_candidates(
        *args, cfg_x, key, jmesh.make_mesh(WORLD, data=WORLD, model=1))}
    for d, m in SPLITS:
        out[f"hyp_{d}x{m}"] = distributed_score_candidates(
            *args, cfg_h, key, jmesh.make_mesh(WORLD, data=d, model=m))
    cfg = JTwoView(max_keypoints=FE_CFG.max_keypoints, nms_radius=FE_CFG.nms_radius,
                   patch_size=FE_CFG.patch_size)
    out["frontend"] = distributed_frontend(jnp.asarray(_synth_frames(F=8)),
                                           jmesh.make_mesh(WORLD, data=WORLD, model=1), cfg)
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shapes_match_jax(ranks, n):
    want = dict(jmesh.make_mesh(n).shape)
    assert tmesh._factor(n) == (want["data"], want["model"])
    if n <= WORLD:
        for r in ranks:
            assert r["shapes"][n] == want
    if n == WORLD:
        for (d, m), shape in ranks[0]["shapes_split"].items():
            assert shape == dict(jmesh.make_mesh(n, data=d, model=m).shape)
            assert shape == {"data": d, "model": m}
    if n == WORLD + 1:
        assert "asks for 5 devices of a world of 4" in ranks[0]["too_many"]


def test_axis_helpers_on_a_2x2_mesh(ranks):
    """Rank r holds x = (r + 1, 10 r); ranks (0, 1) / (2, 3) are the model
    rows of data index 0 / 1."""
    x = lambda r: np.array([r + 1.0, 10.0 * r])  # noqa: E731
    for r, out in enumerate(ranks):
        di, mi = divmod(r, 2)
        assert out["rank"] == r and out["primary"] == (r == 0)
        assert out["axis_index"] == (di, mi)
        np.testing.assert_array_equal(out["psum_data"], x(mi) + x(mi + 2))
        np.testing.assert_array_equal(out["gather_model"], np.stack([x(2 * di), x(2 * di + 1)]))
        assert out["gather_bool"].dtype == bool
        np.testing.assert_array_equal(out["gather_bool"], [[True], [False]])
        want = x(r + 2) if di == 0 else np.zeros(2)
        np.testing.assert_array_equal(out["from_right_data"], want)


@pytest.mark.parametrize("spec,want", [((), ("R", "R")), (("data",), ("S0", "R")),
                                       ((None, "model"), ("R", "S1")),
                                       (("model", "data"), ("S1", "S0"))])
def test_placements_follow_the_partition_spec(spec, want):
    """``replicated`` / ``sharded``: DTensor placements on (data, model)
    for JAX's ``PartitionSpec``."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = tmesh.make_mesh(1, device="cpu")
    names = {"R": Replicate(), "S0": Shard(0), "S1": Shard(1)}
    assert tmesh.sharded(mesh, *spec) == tuple(names[w] for w in want)
    assert tmesh.replicated(mesh) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="no mesh axis"):
        tmesh.sharded(mesh, "rows")


def test_initialize_cluster_and_pod_mesh(ranks, monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert not torch.distributed.is_initialized()
    assert multihost.initialize_cluster(device="cpu") is False
    assert multihost.choose_backend("cpu")[0] == "gloo"
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port)),
                 ("WORLD_SIZE", "1"), ("RANK", "0"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    try:
        assert multihost.initialize_cluster(device="cpu", timeout_s=60.0) is True
        assert multihost.backend_name() == "gloo" and multihost.is_primary()
        mesh = multihost.pod_mesh(device="cpu")
        assert mesh.shape == {"data": 1, "model": 1} and mesh.device_mesh is not None
        x = torch.arange(4.0)
        assert torch.equal(tmesh.all_reduce(mesh, x, "data"), x)
    finally:
        multihost.shutdown_cluster()
    assert not torch.distributed.is_initialized()
    # One host's ranks lie on the model axis, as JAX's pod mesh lays out its
    # one host's devices.
    from ransac_tpu.parallel.multihost import pod_mesh

    assert dict(pod_mesh().shape) == {"data": 1, "model": len(jax.devices())}
    for r in ranks:
        assert r["pod"] == {"data": 1, "model": WORLD}


def test_data_sharded_search_matches_jax(ranks, jax_runs):
    j = jax_runs["data_sharded"]
    for r in ranks:
        t = r["data_sharded"]
        assert int(t["best"]) == int(j["best"]) == 3
        for k in ("err1", "err2"):
            np.testing.assert_allclose(t[k], j[k], rtol=2e-4, atol=2e-3)
            np.testing.assert_array_equal(t[k], ranks[0]["data_sharded"][k])


@pytest.mark.parametrize("split", SPLITS)
def test_hypothesis_sharded_equals_emulation(ranks, jax_runs, split):
    name = "{}x{}".format(*split)
    emu = ranks[0]["emu_" + name]
    for r in ranks:
        t = r["hyp_" + name]
        assert int(t["best"]) == int(emu["best"]) == 3
        for k in ("err1", "err2"):
            np.testing.assert_allclose(t[k], emu[k], rtol=1e-5, atol=1e-4)
    assert int(jax_runs["hyp_" + name]["best"]) == 3


def test_sharded_frontend_equals_one_rank(ranks):
    one = ranks[0]["frontend_1"]
    for r in ranks:
        xy, valid, desc, idx2, mvalid = r["frontend_4"]
        np.testing.assert_array_equal(valid, one[1])
        np.testing.assert_array_equal(xy, one[0])
        np.testing.assert_array_equal(desc, one[2])
        np.testing.assert_array_equal(mvalid[:-1], one[4][:-1])
        keep = one[4][:-1]
        np.testing.assert_array_equal(idx2[:-1][keep], one[3][:-1][keep])
        assert not mvalid[-1].any()
    assert one[4].sum() > 20


def test_sharded_frontend_matches_jax(ranks, jax_runs):
    j = jax_runs["frontend"]
    t = ranks[0]["frontend_4"]
    assert not j[4][-1].any() and not t[4][-1].any()
    assert_frontend_agrees(tuple(a[:-1] if i >= 3 else a for i, a in enumerate(j)),
                           tuple(a[:-1] if i >= 3 else a for i, a in enumerate(t)))


def test_sharded_frontend_tracks_keep_the_invariants(ranks):
    xy, _, _, idx2, mvalid = ranks[0]["frontend_4"]
    tracks = matches_to_tracks(xy, idx2, mvalid, min_len=3)
    assert tracks
    assert len({f for f, _ in tracks}) >= 3
    by_tid = {}
    for (f, t), uv in tracks.items():
        by_tid.setdefault(t, []).append(f)
        assert uv.shape == (2,)
    for fs in by_tid.values():
        fs = sorted(fs)
        assert fs == list(range(fs[0], fs[0] + len(fs))) and len(fs) >= 3
    assert len(by_tid) >= 5


@pytest.mark.parametrize("which", ["scaling", "frontend_scaling"])
def test_scaling_gives_a_point_a_mesh_size(ranks, which):
    pts = ranks[0][which]
    assert [p["n_devices"] for p in pts] == [1, 2, 4]
    assert pts[0]["efficiency"] == 1.0 and all(p["device"] == "cpu" for p in pts)
    want = [dict(jmesh.make_mesh(n).shape) if which == "scaling"
            else {"data": n, "model": 1} for n in (1, 2, 4)]
    assert [p["mesh_shape"] for p in pts] == want
    assert all(np.isfinite(p["candidates_per_s"]) and p["candidates_per_s"] > 0 for p in pts)
    for r in ranks:
        assert r[which] == pts


@pytest.mark.parametrize("virtual", [True, False])
@pytest.mark.parametrize("unit", ["cand/s", "frames/s"])
def test_report_text_equals_jax(virtual, unit):
    from ransac_tpu.utils import scaling as jscaling

    rows = [(1, {"data": 1, "model": 1}, 1234.5, 1.0), (2, {"data": 2, "model": 1}, 2000.25,
                                                         0.81), (4, {"data": 2, "model": 2},
                                                                 3321.0, 0.6725)]
    got = tscaling.report([tscaling.ScalePoint(*r) for r in rows], virtual, unit)
    want = jscaling.report([jscaling.ScalePoint(*r) for r in rows], virtual, unit)
    assert got == want


def test_cli_profile_scaling_only_on_the_cpu(monkeypatch, capsys):
    """``profile --scaling-only --device cpu`` in one process: both tables,
    one point each, the CPU note (the harness's sizes cut for the test)."""
    from functools import partial

    monkeypatch.setattr(tscaling, "measure_scaling", partial(
        tscaling.measure_scaling, n_candidates=8, hypotheses=128, iters=1))
    monkeypatch.setattr(tscaling, "measure_frontend_scaling", partial(
        tscaling.measure_frontend_scaling, img_hw=64, max_kp=32, iters=1))
    assert tcli.main(["profile", "--scaling-only", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "# scaling: backend none (one process)" in out
    assert out.count("# NOTE: virtual single-host devices") == 2
    assert "# keyframe front end (weak scaling over mesh data axis)" in out
    rows = [ln.split() for ln in out.splitlines() if ln.strip().startswith("1 {")]
    assert len(rows) == 2 and all(r[-1] == "100.0%" for r in rows)
    assert "# launches" not in out


@pytest.mark.slow
def test_full_width_search_matches_jax(tmp_path):
    """The planted scene's grid padded to 460 candidates, exhaustive, 4 x 1:
    the port's 4 ranks and JAX's 4 devices both pick the planted candidate,
    err1 / err2 within rtol 2e-4 and atol 2e-3."""
    from ransac_tpu.parallel.sharded_search import distributed_score_candidates
    from ransac_tpu_torch.io.synthetic import write_planted_scene
    from ransac_tpu_torch.io.tables import (build_scene, read_camera_locations,
                                            read_points_data)
    from ransac_tpu_torch.parallel.sharded_search import pad_candidates

    ps = write_planted_scene(str(tmp_path), seed=0)
    scene = build_scene(read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y),
                        read_camera_locations(ps.cameras_csv), device="cpu")
    cam_locs, grids = pad_candidates(scene.cam_locs, scene.grid_codes, WORLD)
    problem = tuple(a.numpy() for a in (scene.pixels, scene.pos3d, scene.point_mask,
                                        cam_locs, grids))
    got = torch_ranks.spawn("full_width_search", WORLD, problem)[0]
    cfg = JLocalize(ransac=JRansac(threshold=75.0, exhaustive=True, refine_iters=0))
    want = jax.tree.map(np.asarray, distributed_score_candidates(
        *map(jnp.asarray, problem), cfg, jax.random.key(0),
        jmesh.make_mesh(WORLD, data=WORLD, model=1)))
    assert problem[3].shape[0] == 460
    assert int(got["best"]) == int(want["best"]) == ps.planted
    for k in ("err1", "err2"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-3)
