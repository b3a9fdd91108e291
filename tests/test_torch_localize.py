"""The localize slice end to end: ``ransac_tpu_torch.pipelines.localize``
on the CPU against ``ransac_tpu.pipelines.localize`` on both routes, on a
planted scene of the reference's size (the real 458-candidate grid, 13
seeded landmarks, 2 outliers; ``io.synthetic.write_planted_scene``).

Decisions must be equal: the best candidate (the planted one), every
candidate's search inlier mask and the PnP inlier mask.  err2 is held at
rtol 1e-4 / atol 1e-3 (the JAX suite's own bounds).  err1 is the sum of
pixel errors of the LM-refit homography, whose cost valley is flat along
one direction: float32 rounding anywhere in the refit moves the minimum
along it.  The JAX package itself gives err1 values up to 8.2e-4 apart on
this scene when the same refit runs vmapped over the candidates (as in
``localize``) or jitted one candidate at a time.  So err1 is held at rtol
2e-3 against both, and at rtol 1e-4 at the winning candidate.  PnP
origins agree within 0.05 m.
"""

import csv
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu import cli as jcli
from ransac_tpu.io import tables as jt
from ransac_tpu.ops import homography as jh
from ransac_tpu.ops import projection as jproj
from ransac_tpu.ops import lm as jlm
from ransac_tpu.ops.lm import refine_homography
from ransac_tpu.pipelines import localize as jl
from ransac_tpu.utils.config import LocalizeConfig as JLocalizeConfig
from ransac_tpu_torch import cli as tcli
from ransac_tpu_torch.io import tables as tt
from ransac_tpu_torch.io.synthetic import film_K, write_planted_scene
from ransac_tpu_torch.models import ransac as tr
from ransac_tpu_torch.ops import _build
from ransac_tpu_torch.ops import homography as th
from ransac_tpu_torch.ops import lm as tlm
from ransac_tpu_torch.ops import projection as tproj
from ransac_tpu_torch.ops.rotation import log_so3
from ransac_tpu_torch.pipelines import localize as tl
from ransac_tpu_torch.utils.config import LocalizeConfig
from torch_threads import one_torch_thread  # noqa: F401

ROUTES = ["engine", "sweep"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    return write_planted_scene(tmp_path_factory.mktemp("planted"), seed=0)


@pytest.fixture(scope="module")
def results(planted):
    js = jt.build_scene(
        jt.read_points_data(planted.features_csv, planted.pixel_x,
                            planted.pixel_y, use_native="never"),
        jt.read_camera_locations(planted.cameras_csv, use_native="never"))
    ts = tt.build_scene(
        tt.read_points_data(planted.features_csv, planted.pixel_x, planted.pixel_y),
        tt.read_camera_locations(planted.cameras_csv), device="cpu")
    out = {}
    for route in ROUTES:
        sweep = route == "sweep"
        out[route] = (jl.localize(js, planted.image_size, use_sweep=sweep),
                      tl.localize(ts, planted.image_size, use_sweep=sweep,
                                  device="cpu"))
    return js, out


@pytest.mark.parametrize("route", ROUTES)
def test_best_candidate_is_planted_on_both(results, planted, route):
    rj, rt = results[1][route]
    assert rt.best_index == rj.best_index == planted.planted
    np.testing.assert_allclose(rt.best_location_utm, planted.origin_utm,
                               rtol=0, atol=1e-3)


@pytest.mark.parametrize("route", ROUTES)
def test_inlier_masks_match(results, route):
    rj, rt = results[1][route]
    np.testing.assert_array_equal(rt.inlier_masks, rj.inlier_masks)
    np.testing.assert_array_equal(rt.pnp_inliers, rj.pnp_inliers)
    assert rt.pnp_inliers.sum() == 11  # the 2 planted outliers are out


@pytest.mark.parametrize("route", ROUTES)
def test_scores_match(results, route):
    rj, rt = results[1][route]
    np.testing.assert_allclose(rt.err2, rj.err2, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(rt.err1, rj.err1, rtol=2e-3, atol=1e-3)
    b = rt.best_index
    np.testing.assert_allclose(rt.err1[b], rj.err1[b], rtol=1e-4)
    assert rt.err2[b] == pytest.approx(150.0, abs=0.01)


def test_err1_matches_single_candidate_jax_refit(results):
    """err1 against the JAX refit jitted one candidate at a time on the same
    inlier masks (the other float32 rounding of the same refit)."""
    js, out = results
    rt = out["engine"][1]
    cfg = JLocalizeConfig().ransac
    pix = jnp.asarray(js.pixels)
    mask = jnp.asarray(js.point_mask)

    @jax.jit
    def one(loc, inl):
        pos2, _ = jproj.east_axis_plane_projection(jnp.asarray(js.pos3d), loc)
        w = inl.astype(jnp.float32)
        H = jh.dlt_homography(pos2, pix, w)
        H, _ = refine_homography(H, pos2, pix, w, max_iters=cfg.refine_iters)
        return jl.reference_scores(H, pos2, pix, inl, mask, cfg.threshold)[0]

    err1 = np.array([float(one(jnp.asarray(js.cam_locs[c]),
                               jnp.asarray(rt.inlier_masks[c])))
                     for c in range(len(rt.err1))])
    np.testing.assert_allclose(rt.err1, err1, rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(out["engine"][0].err1, err1, rtol=2e-3, atol=1e-3)


def _refit_batch(js, rt, n_cands, dtype=torch.float32):
    """The candidate refit batch: the first ``n_cands`` candidates' plane
    points, pixels, engine-route inlier masks and DLT seeds."""
    pos2, _ = tproj.east_axis_plane_projection(
        torch.from_numpy(np.asarray(js.pos3d))[None].to(dtype),
        torch.from_numpy(np.asarray(js.cam_locs))[:n_cands].to(dtype))
    pix = torch.from_numpy(np.asarray(js.pixels))[None].expand(n_cands, -1, -1).to(dtype)
    w = torch.from_numpy(rt.inlier_masks[:n_cands]).to(dtype)
    return th.dlt_homography(pos2, pix, w), pos2, pix, w


def _pnp_refit_args(ts, planted, dtype=torch.float32):
    """The PnP refit's inputs from the engine's seed on the planted scene."""
    K = torch.tensor(film_K(planted.image_size), dtype=torch.float32)
    res = tr.ransac_pnp(ts.pos3d, ts.pixels, K, ts.point_mask, LocalizeConfig().pnp_ransac)
    return tuple(a.to(dtype) for a in (
        log_so3(res.raw_model[:9].reshape(3, 3))[None], res.raw_model[9:][None],
        ts.pos3d[None], ts.pixels[None], K[None], res.inlier_mask.float()[None]))


def _fixed_passes(fn):
    """``fn()`` with the LM's done reads off: every pass runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlm, "CHECK_EVERY", 0)
        return fn()


@pytest.mark.parametrize("max_iters, n_cands", [(10, 458), (40, 96)])
def test_lm_early_exit_equals_fixed_passes(results, planted, max_iters, n_cands):
    """The LM that reads ``done`` every CHECK_EVERY passes and stops once
    every item is done gives the fixed loop's x, cost, iterations and
    converged bit for bit, on the candidate refit batch (the engine route's
    inlier masks; at localize's 10 passes, and on its first 96 candidates at
    40, where they converge) and on the PnP refit.  At 10 passes no float32
    item can set ``done`` (a step is taken only on a cost decrease of at
    least an ulp, above rtol 1e-10, and the damping needs 11 rejections to
    reach its cap), so every item runs all 10, as JAX's, and the loop reads
    nothing; at 40 it reads from pass 12 on.  Every item converges on both
    sides at 40, after pass counts that float32 rounding moves by a few
    passes either way (their means within one pass; item by item in float64,
    ``test_lm_iterations_equal_jax_in_float64``)."""
    js, out = results
    H0, pos2, pix, w = _refit_batch(js, out["engine"][1], n_cands)
    h0 = H0.reshape(-1, 9)[:, :8]  # H0[2, 2] = 1

    def lm():
        return tlm.levenberg_marquardt(tlm._homography_residuals, h0, (pos2, pix, w),
                                       max_iters=max_iters)

    fixed = _fixed_passes(lm)
    assert torch.equal(fixed.x, tlm.refine_homography(H0, pos2, pix, w, max_iters=max_iters)[1].x)
    tlm.reset_counts()
    launches = dict(_build.LAUNCHES)
    early = lm()
    for a, b in zip(early, fixed):
        assert torch.equal(a, b)
    _, jres = jax.jit(jax.vmap(partial(refine_homography, max_iters=max_iters)))(
        jnp.asarray(H0.numpy()), jnp.asarray(pos2.numpy()), jnp.asarray(pix.numpy()),
        jnp.asarray(w.numpy()))
    it_t, it_j = fixed.iterations.numpy(), np.asarray(jres.iterations)
    if max_iters == 10:
        assert (it_t == 10).all() and (it_j == 10).all() and not fixed.converged.any()
        assert tlm.COUNTS == {"passes": 10, "reads": 0}
    else:
        assert fixed.converged.all() and np.asarray(jres.converged).all()
        assert abs(it_t.mean() - it_j.mean()) < 1.0
        passes = min(max_iters, max(12, -(-it_t.max() // 4) * 4))
        assert tlm.COUNTS == {"passes": passes, "reads": (passes - 12) // 4 + 1}
    assert _build.LAUNCHES == launches
    # The PnP refit (localize's 10 passes, and 30) from its seed.
    args = _pnp_refit_args(tt.scene_from_numpy(js, device="cpu"), planted)
    for iters in (10, 30):
        fixed = _fixed_passes(lambda: tlm.refine_pose(*args, max_iters=iters))
        early = tlm.refine_pose(*args, max_iters=iters)
        for a, b in zip(early[2], fixed[2]):
            assert torch.equal(a, b)
    rj = jlm.refine_pose(*(jnp.asarray(a[0].numpy()) for a in args), max_iters=10)[2]
    assert int(rj.iterations) == int(tlm.refine_pose(*args, max_iters=10)[2].iterations[0]) == 10


def test_lm_iterations_equal_jax_in_float64(results, planted):
    """Both LMs in float64, where a converging step can meet rtol 1e-10: on
    the 96-candidate refit batch at 40 passes every item stops after JAX's
    pass count, item by item, and converges, with x within 1e-9.  The PnP
    refit's costs pass by pass agree within 1e-12 while they fall (passes
    1-3) and both converge at the cost within 1e-12; after that the cost
    sits at its float64 floor, where a step is taken only on a decrease by
    rounding, so the pass at which it stops is rounding's, not the test's
    (PERF.md, the LM's pass counts)."""
    js, out = results
    H0, pos2, pix, w = _refit_batch(js, out["engine"][1], 96, torch.float64)
    _, res = tlm.refine_homography(H0, pos2, pix, w, max_iters=40)
    with jax.enable_x64(True):
        _, jres = jax.jit(jax.vmap(partial(refine_homography, max_iters=40)))(
            *(jnp.asarray(a.numpy()) for a in (H0, pos2, pix, w)))
        it_j, conv_j, x_j = (np.asarray(a) for a in (jres.iterations, jres.converged, jres.x))
    assert x_j.dtype == np.float64
    np.testing.assert_array_equal(res.iterations.numpy(), it_j)
    assert res.converged.all() and conv_j.all() and (it_j < 40).all()
    np.testing.assert_allclose(res.x.numpy(), x_j, rtol=1e-9, atol=1e-12)
    args = _pnp_refit_args(tt.scene_from_numpy(js, device="cpu"), planted, torch.float64)
    for iters in (1, 2, 3, 30):
        r_t = tlm.refine_pose(*args, max_iters=iters)[2]
        with jax.enable_x64(True):
            r_j = jlm.refine_pose(*(jnp.asarray(a[0].numpy()) for a in args),
                                  max_iters=iters)[2]
            cost_j, conv_j = float(r_j.cost), bool(r_j.converged)
        assert float(r_t.cost[0]) == pytest.approx(cost_j, rel=1e-12, abs=0)
        assert bool(r_t.converged[0]) == conv_j == (iters == 30)


@pytest.mark.parametrize("route", ROUTES)
def test_pnp_origins_agree(results, planted, route):
    rj, rt = results[1][route]
    assert np.linalg.norm(rt.camera_origin_utm - rj.camera_origin_utm) < 0.05
    assert np.linalg.norm(rt.camera_origin_utm - planted.origin_utm) < 2.0


def _cli_args(planted, output):
    return ["localize", "--features", planted.features_csv, "--cameras",
            planted.cameras_csv, "--pixel-x", planted.pixel_x, "--pixel-y",
            planted.pixel_y, "--width", str(planted.image_size[0]), "--height",
            str(planted.image_size[1]), "--sweep", "--output", str(output)]


def test_cli_location_csv_matches_jax(results, planted, tmp_path):
    assert tcli.main(_cli_args(planted, tmp_path / "port.jpg")
                     + ["--device", "cpu"]) == 0
    jcli.main(_cli_args(planted, tmp_path / "jax.jpg"))
    port = list(csv.reader(open(tmp_path / "port_location.csv", encoding="utf-8")))
    ref = list(csv.reader(open(tmp_path / "jax_location.csv", encoding="utf-8")))
    assert port[0] == ref[0] and len(port) == len(ref) == 459
    p, r = np.array(port[1:], float), np.array(ref[1:], float)
    np.testing.assert_array_equal(p[:, [0, 3]], r[:, [0, 3]])
    np.testing.assert_allclose(p[:, 4:], r[:, 4:], rtol=0, atol=1e-6)
    np.testing.assert_allclose(p[:, 2], r[:, 2], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(p[:, 1], r[:, 1], rtol=2e-3, atol=1e-3)


def test_cli_cuda_without_cuda_exits_nonzero(planted, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = tcli.main(_cli_args(planted, tmp_path / "x.jpg") + ["--device", "cuda"])
    assert rc != 0
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "x_location.csv").exists()


def test_port_imports_no_jax():
    code = (
        "import pkgutil, sys, ransac_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(ransac_tpu_torch.__path__, 'ransac_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "import ransac_tpu_torch.cli\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'ransac_tpu' or m.startswith('ransac_tpu.')]\n"
        "assert not bad, bad\n"
        "heavy = [m for m in ('matplotlib', 'PIL') if m in sys.modules]\n"
        "assert not heavy, heavy\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
