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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu import cli as jcli
from ransac_tpu.io import tables as jt
from ransac_tpu.ops import homography as jh
from ransac_tpu.ops import projection as jproj
from ransac_tpu.ops.lm import refine_homography
from ransac_tpu.pipelines import localize as jl
from ransac_tpu.utils.config import LocalizeConfig as JLocalizeConfig
from ransac_tpu_torch import cli as tcli
from ransac_tpu_torch.io import tables as tt
from ransac_tpu_torch.io.synthetic import write_planted_scene
from ransac_tpu_torch.pipelines import localize as tl

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
