"""The intrinsics search of the port (``pipelines.intrinsics_search``) and
the commands that complete the ``localize`` family (``cli intrinsics``,
``cli run``, ``cli localize --calibration``, and ``--device`` handling of
every new command) against the JAX package on the CPU.

The JAX search runs once, in a module fixture, on the JAX package's own
planted case (``tests/test_intrinsics_search.py``, made by
``io.synthetic.planted_focal_case``: 14 points seen at f = 180 mm on film
127 x 178 mm, 0.3 px of noise).  Held: the same best
combination and the same top-5 order, every combination's inlier count,
its mean error within 1e-3 px or 1e-4 of it in the top 5 (1e-3 of it
below); the refined error within 1e-3 px.  The JAX ``localize
--calibration`` runs once too: on a planted scene whose pixels went
through a lens (``write_planted_scene(dist=...)``), both commands pick the
planted candidate.
"""

import json
import os

import numpy as np
import pytest
import torch

from ransac_tpu import cli as jcli
from ransac_tpu.pipelines.intrinsics_search import search_intrinsics as jsearch
from ransac_tpu_torch import cli as tcli
from ransac_tpu_torch.io.synthetic import (LENS_DIST, planted_focal_case,
                                           write_planted_calibration, write_planted_scene)
from ransac_tpu_torch.ops import lm as tlm
from ransac_tpu_torch.pipelines.intrinsics_search import search_intrinsics as tsearch
from torch_threads import one_torch_thread  # noqa: F401

X, PIX, ORIGIN, SIZE, F_MM, SENSOR = planted_focal_case()


@pytest.fixture(scope="module")
def searched():
    res_j = jsearch(X, PIX, SIZE, known_origin=ORIGIN, rank_by="err")
    tlm.reset_counts()
    res_t = tsearch(X, PIX, SIZE, known_origin=ORIGIN, rank_by="err", device="cpu")
    return res_j, res_t, dict(tlm.COUNTS)


def key(c):
    return (c.focal_mm, tuple(c.sensor_mm))


def test_search_picks_the_planted_combination_as_jax(searched):
    res_j, res_t, counts = searched
    assert key(res_t.best) == key(res_j.best) == (F_MM, SENSOR)
    assert [key(c) for c in res_t.candidates[:5]] == [key(c) for c in res_j.candidates[:5]]
    assert len(res_t.candidates) == len(res_j.candidates) == 27
    assert abs(res_t.refined_mean_err_px - res_j.refined_mean_err_px) <= 1e-3
    assert res_t.refined_mean_err_px < 1.0
    # 27 engine refits of 10 passes, then the winner's refine, which stops on
    # its done read before its 30 passes.
    assert 270 < counts["passes"] < 300 and counts["reads"] >= 1


def test_every_combination_matches_jax(searched):
    res_j, res_t, _ = searched
    by_j = {key(c): c for c in res_j.candidates}
    for rank, c in enumerate(res_t.candidates):
        cj = by_j[key(c)]
        assert c.n_inliers == cj.n_inliers, key(c)
        np.testing.assert_array_equal(c.K, cj.K)
        # A wrong camera's pose is an LM refit of 10 passes far from any
        # minimum (mean errors of 8-730 px), where float32 rounding moves the
        # error by up to ~3e-4 of it: the top 5 within 1e-4, all within 1e-3.
        tol = max(1e-3, (1e-4 if rank < 5 else 1e-3) * cj.mean_err_px)
        assert abs(c.mean_err_px - cj.mean_err_px) <= tol, key(c)
        assert abs(c.dist_to_known - cj.dist_to_known) <= 1e-3 * max(1.0, cj.dist_to_known)
    # Ranked by the distance to the known origin instead, as the reference
    # ranks (testpro-K.py:99): the same order on both sides.
    order = sorted(res_t.candidates, key=lambda c: (c.dist_to_known, c.mean_err_px))
    order_j = sorted(res_j.candidates, key=lambda c: (c.dist_to_known, c.mean_err_px))
    assert [key(c) for c in order[:5]] == [key(c) for c in order_j[:5]]


# ------------------------------------------------------------ commands
@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    plain = write_planted_scene(d / "plain", seed=0)
    lens = write_planted_scene(d / "lens", seed=0, dist=LENS_DIST)
    return plain, lens, write_planted_calibration(os.path.join(d, "cal.npz"), lens)


def _localize_args(ps, output):
    return ["localize", "--features", ps.features_csv, "--cameras", ps.cameras_csv,
            "--pixel-x", ps.pixel_x, "--pixel-y", ps.pixel_y,
            "--width", str(ps.image_size[0]), "--height", str(ps.image_size[1]),
            "--output", str(output)]


def _best(csv_path):
    rows = np.loadtxt(csv_path, delimiter=",", skiprows=1)
    return int(np.argmin(rows[:, 2])), rows


def test_cli_localize_calibration_matches_jax(scenes, tmp_path, capsys):
    """``localize --calibration`` on the lens scene: both commands undistort
    the annotated pixels, pick the planted candidate and find a PnP pose;
    their err2 columns agree (rtol 1e-3)."""
    _, lens, cal = scenes
    assert tcli.main(_localize_args(lens, tmp_path / "t.jpg")
                     + ["--calibration", cal, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "undistorted 13 feature pixels" in out and "PnP camera origin" in out
    jcli.main(_localize_args(lens, tmp_path / "j.jpg") + ["--calibration", cal])
    (best_t, rows_t), (best_j, rows_j) = (_best(tmp_path / f"{s}_location.csv")
                                          for s in ("t", "j"))
    assert best_t == best_j == lens.planted
    np.testing.assert_allclose(rows_t[:, 2], rows_j[:, 2], rtol=1e-3, atol=1e-2)


def test_cli_run_equals_two_localize_calls(scenes, tmp_path, monkeypatch):
    """``run`` with a two-job config (the plain scene on the engine route,
    the lens scene with its calibration on the sweep route) writes the
    location CSVs of the two ``localize`` calls it stands for."""
    plain, lens, cal = scenes
    monkeypatch.chdir(tmp_path)

    def job(ps, out, **kw):
        return dict(features=ps.features_csv, camera_locations=ps.cameras_csv,
                    pixel_x=ps.pixel_x, pixel_y=ps.pixel_y, width=ps.image_size[0],
                    height=ps.image_size[1], output=out, **kw)

    cfg = tmp_path / "jobs.json"
    cfg.write_text(json.dumps({"images": [
        job(plain, "run_a.jpg"), job(lens, "run_b.jpg", sweep=True, calibration=cal)]}))
    assert tcli.main(["run", "--config", str(cfg), "--device", "cpu"]) == 0
    assert tcli.main(_localize_args(plain, "one_a.jpg") + ["--device", "cpu"]) == 0
    assert tcli.main(_localize_args(lens, "one_b.jpg")
                     + ["--sweep", "--calibration", cal, "--device", "cpu"]) == 0
    for s in ("a", "b"):
        assert ((tmp_path / f"run_{s}_location.csv").read_text()
                == (tmp_path / f"one_{s}_location.csv").read_text())
    assert _best(tmp_path / "run_b_location.csv")[0] == lens.planted


@pytest.mark.parametrize("full", [False, True])
def test_cli_run_jobs_parse_as_localize(tmp_path, monkeypatch, full):
    """Each ``run`` job goes through ``localize``'s own parser: a job with
    only the required keys, and one with every key, give the Namespace that
    ``localize`` with the matching flags gives (its defaults where a key is
    absent), ``--device`` included."""
    seen = []
    monkeypatch.setattr(tcli, "_cmd_localize", lambda ns: seen.append(vars(ns)) or 0)
    job = dict(features="f.csv", camera_locations="c.csv", pixel_x="px", pixel_y="py",
               width=2142, height=1620)
    flags = ["--features", "f.csv", "--cameras", "c.csv", "--pixel-x", "px",
             "--pixel-y", "py", "--width", "2142", "--height", "1620"]
    if full:
        job.update(scale=0.5, ransacbound=40.0, grid_code_min=3, observer_height=1.5,
                   z_mode="height_plus_elevation", calibration="cal.npz", output="o.jpg",
                   dem_file="d.tif", dem_spacing=5.0, json_file="b.json",
                   query=["10,20", "30,40"], seed=7, min_pnp_inliers=5, viz_pass=5.0,
                   image_name="img.npy", sweep=True, report=True)
        flags += ["--scale", "0.5", "--ransacbound", "40", "--grid-code-min", "3",
                  "--observer-height", "1.5", "--z-mode", "height_plus_elevation",
                  "--calibration", "cal.npz", "--output", "o.jpg", "--dem", "d.tif",
                  "--dem-spacing", "5", "--json-file", "b.json", "--query", "10,20",
                  "30,40", "--seed", "7", "--min-pnp-inliers", "5", "--viz-pass", "5",
                  "--image", "img.npy", "--sweep", "--report"]
    cfg = tmp_path / "jobs.json"
    cfg.write_text(json.dumps([job]))
    assert tcli.main(["run", "--config", str(cfg), "--device", "cpu"]) == 0
    assert tcli.main(["localize", *flags, "--device", "cpu"]) == 0
    run_ns, localize_ns = seen
    localize_ns.pop("cmd")
    assert run_ns == localize_ns


def test_cli_intrinsics_ranks_the_planted_camera(scenes, capsys):
    """``intrinsics`` on the planted scene's CSV: the film camera that made
    its pixels (240 mm on 127 x 178 mm) ranks first by the distance to the
    planted origin; the table has 5 rows and the refined error."""
    plain, _, _ = scenes
    e, n, z = plain.origin_utm
    assert tcli.main(["intrinsics", "--features", plain.features_csv,
                      "--pixel-x", plain.pixel_x, "--pixel-y", plain.pixel_y,
                      "--width", str(plain.image_size[0]),
                      "--height", str(plain.image_size[1]),
                      "--known-origin", f"{e},{n},{z}", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    table = [ln for ln in lines if ln.split() and ln.split()[0].isdigit()]
    assert len(table) == 5
    assert table[0].split()[1:4] == ["240", "(127,", "178)"], table[0]
    assert lines[-1].startswith("refined mean reprojection error:")


@pytest.mark.parametrize("cmd", ["calibrate", "intrinsics", "run", "localize"])
def test_new_commands_refuse_cuda_without_cuda(cmd, scenes, tmp_path, monkeypatch, capsys):
    """``--device cuda`` where CUDA is missing: exit code 2 and a message,
    nothing written, no quiet run on the CPU."""
    plain, _, cal = scenes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "jobs.json"
    cfg.write_text(json.dumps([dict(features=plain.features_csv,
                                    camera_locations=plain.cameras_csv,
                                    pixel_x=plain.pixel_x, pixel_y=plain.pixel_y,
                                    width=2142, height=1620, output="x.jpg")]))
    argv = {"calibrate": ["calibrate", "--images", str(tmp_path / "*.npy"),
                          "--out", "x.npz"],
            "intrinsics": ["intrinsics", "--features", plain.features_csv,
                           "--pixel-x", plain.pixel_x, "--pixel-y", plain.pixel_y,
                           "--width", "2142", "--height", "1620"],
            "run": ["run", "--config", str(cfg)],
            "localize": _localize_args(plain, "x.jpg") + ["--calibration", cal]}[cmd]
    assert tcli.main(argv + ["--device", "cuda"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
    assert os.listdir(tmp_path) == ["jobs.json"]
