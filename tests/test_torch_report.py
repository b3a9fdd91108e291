"""``localize --report`` of the port (``ransac_tpu_torch.analytics``,
``io.export``, ``viz``, ``pipelines.localize.export_best_candidate_report``)
against the JAX package on the CPU.

The analytics rows are equal.  The report CSVs are held on one planted
scene with 3 unannotated landmarks (``write_planted_scene(n_unannotated=3)``):
both packages localize on the engine route, and each report writer runs
on the winner.  The JAX writer is also given the port's result (the state
carried across), so the two writers meet one homography: the LM-refit
homography moves by ~1e-4 between the two packages (its err1 valley is
flat, ``test_torch_localize.py``), which would move every projected pixel
by as much.  Headers, row counts, symbols and names are equal; numbers
within rtol 1e-5.
"""

import csv
import os

import numpy as np
import pytest
import torch

from ransac_tpu import analytics as janalytics
from ransac_tpu.io import tables as jt
from ransac_tpu.pipelines import localize as jl
from ransac_tpu_torch import analytics, cli
from ransac_tpu_torch.io import tables as tt
from ransac_tpu_torch.io.synthetic import write_planted_scene
from ransac_tpu_torch.pipelines import localize as tl
from torch_threads import one_torch_thread  # noqa: F401

N_UNANNOTATED = 3


def _read(path):
    with open(path, encoding="utf-8-sig") as f:
        return list(csv.reader(f))


def _assert_rows_close(port, ref, text_cols):
    """Header and length equal; text columns equal, the rest within rtol
    1e-5."""
    assert port[0] == ref[0] and len(port) == len(ref)
    for rp, rr in zip(port[1:], ref[1:]):
        for k, (a, b) in enumerate(zip(rp, rr)):
            if k in text_cols:
                assert a == b, (k, a, b)
            else:
                np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-9)


# ------------------------------------------------------------ analytics
def _feature_rows(seed, n=9):
    rng = np.random.default_rng(seed)
    symbols = [f"S{k}" for k in rng.permutation(n)]
    symbols[3] = symbols[1]  # a repeated symbol: pairs of it are skipped
    pos_xy = rng.uniform(-2e3, 2e3, (n, 2)) + [7.4e5, 2.888e6]
    pixels = rng.uniform(1, 2000, (n, 2))
    pixels[[2, 5]] = 0.0  # the reference's missing-pixel sentinel
    calc = pixels + rng.normal(scale=3.0, size=(n, 2))
    calc[5] = rng.uniform(1, 2000, 2)
    return symbols, [f"name {s}" for s in symbols], pos_xy, pixels, calc


@pytest.mark.parametrize("seed", [0, 1])
def test_accuracy_and_correlation_rows_equal_jax(seed):
    symbols, names, pos_xy, pixels, calc = _feature_rows(seed)
    assert (analytics.accuracy_rows(symbols, names, pos_xy, pixels, calc)
            == janalytics.accuracy_rows(symbols, names, pos_xy, pixels, calc))
    for depth in (1.0, 2.5):
        port = analytics.correlate_features(symbols, pos_xy, pixels, calc, depth)
        ref = janalytics.correlate_features(symbols, pos_xy, pixels, calc, depth)
        assert port == ref
        assert port[0] == analytics.CORRELATION_HEADER and len(port) > 1


def test_calc_bearing_keeps_the_zero_sentinel():
    x1 = np.array([0.0, 10.0, 10.0, 10.0, 5.0])
    y1 = np.array([3.0, 0.0, 10.0, 10.0, 5.0])
    x2 = np.array([4.0, 4.0, 0.0, 20.0, 1.0])
    y2 = np.array([5.0, 5.0, 7.0, 0.0, 9.0])
    out = analytics.calc_bearing(x1, y1, x2, y2)
    np.testing.assert_array_equal(out[:4], 0.0)
    assert 0.0 < out[4] < 360.0
    np.testing.assert_array_equal(out, janalytics.calc_bearing(x1, y1, x2, y2))


def test_nearest_neighbor_distances_equal_jax():
    pts = np.random.default_rng(3).uniform(0, 100, (12, 2))
    np.testing.assert_array_equal(analytics.nearest_neighbor_distances(pts),
                                  janalytics.nearest_neighbor_distances(pts))


# ------------------------------------------------------------ the report
@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    return write_planted_scene(tmp_path_factory.mktemp("report"), seed=0,
                               n_unannotated=N_UNANNOTATED)


@pytest.fixture(scope="module")
def localized(planted):
    """(JAX scene, JAX result, port scene, port result, both tables with the
    unannotated rows), the engine route on the CPU."""
    args = (planted.features_csv, planted.pixel_x, planted.pixel_y)
    js = jt.build_scene(jt.read_points_data(*args, use_native="never"),
                        jt.read_camera_locations(planted.cameras_csv,
                                                 use_native="never"))
    ts = tt.build_scene(tt.read_points_data(*args),
                        tt.read_camera_locations(planted.cameras_csv), device="cpu")
    all_j = jt.read_points_data(*args, keep_unannotated=True, use_native="never")
    all_t = tt.read_points_data(*args, keep_unannotated=True)
    return (js, jl.localize(js, planted.image_size), ts,
            tl.localize(ts, planted.image_size, device="cpu"), all_j, all_t)


def test_planted_scene_default_output_unchanged(planted, tmp_path):
    """``n_unannotated`` appends rows with pixel (0, 0) and moves no other:
    the default file is the first rows of the longer one."""
    ps0 = write_planted_scene(tmp_path, seed=0)
    rows0, rows3 = _read(ps0.features_csv), _read(planted.features_csv)
    assert rows3[:len(rows0)] == rows0 and len(rows3) == len(rows0) + N_UNANNOTATED
    assert all(r[-2:] == ["0.0", "0.0"] for r in rows3[len(rows0):])
    np.testing.assert_array_equal(planted.landmarks_utm[:13], ps0.landmarks_utm)
    with open(ps0.cameras_csv, "rb") as f0, open(planted.cameras_csv, "rb") as f3:
        assert f0.read() == f3.read()


def test_report_csvs_match_jax(localized, tmp_path):
    js, rj, ts, rt, all_j, all_t = localized
    assert rt.best_index == rj.best_index
    out_t, out_j, out_x = (str(tmp_path / f"{k}.jpg") for k in ("port", "jax", "cross"))
    acc_t, corr_t = tl.export_best_candidate_report(
        ts, rt, out_t, make_plots=False, all_features=all_t)
    jl.export_best_candidate_report(js, rj, out_j, make_plots=False,
                                    all_features=all_j)
    # The JAX writer on the port's result: one homography for both writers.
    jl.export_best_candidate_report(js, jl.LocalizationResult(**vars(rt)), out_x,
                                    make_plots=False, all_features=all_j)
    acc_p = _read(out_t.replace(".jpg", "_accuracies.csv"))
    corr_p = _read(out_t.replace(".jpg", "_correlations.csv"))
    assert acc_p == [[str(v) for v in r] for r in acc_t]
    assert len(corr_p) == len(corr_t)
    n = 13 + N_UNANNOTATED
    assert len(acc_p) == n + 1 and len(corr_p) == n * (n - 1) // 2 + 1
    # The unannotated rows are forward-projected: pixel (0, 0), calc_pixel not.
    for r in acc_p[-N_UNANNOTATED:]:
        assert r[1].startswith("U") and float(r[5]) == float(r[6]) == 0.0
        assert float(r[7]) != 0.0 and float(r[8]) != 0.0
    _assert_rows_close(acc_p, _read(out_x.replace(".jpg", "_accuracies.csv")),
                       text_cols={0, 1, 2})
    _assert_rows_close(corr_p, _read(out_x.replace(".jpg", "_correlations.csv")),
                       text_cols={0, 1, 8})
    # Against the JAX run's own winner: the same rows, pixels within the
    # refit homography's float32 spread.
    acc_j = _read(out_j.replace(".jpg", "_accuracies.csv"))
    assert [r[:7] for r in acc_p] == [r[:7] for r in acc_j]
    np.testing.assert_allclose(np.array([r[7:] for r in acc_p[1:]], float),
                               np.array([r[7:] for r in acc_j[1:]], float), rtol=1e-3)


def test_calc_pixels_are_float32_as_in_jax(localized, tmp_path):
    """With the full table, the report projects its landmarks in float32, as
    the JAX writer does: on one homography every row's calc pixel is a
    float32 and lies within 2 float32 ulp of JAX's, the unannotated rows
    included."""
    js, _, ts, rt, all_j, all_t = localized
    acc_t, _ = tl.export_best_candidate_report(
        ts, rt, str(tmp_path / "p.jpg"), make_plots=False, all_features=all_t)
    acc_j, _ = jl.export_best_candidate_report(
        js, jl.LocalizationResult(**vars(rt)), str(tmp_path / "j.jpg"),
        make_plots=False, all_features=all_j)
    calc_t = np.array([r[7:9] for r in acc_t[1:]])
    calc_j = np.array([r[7:9] for r in acc_j[1:]])
    assert calc_t.dtype == calc_j.dtype == np.float32
    assert calc_t.shape == (13 + N_UNANNOTATED, 2)
    ulp = np.spacing(np.abs(calc_j))
    assert (np.abs(calc_t - calc_j) <= 2 * ulp).all(), np.abs(calc_t - calc_j) / ulp


def _cli_args(planted, output):
    return ["localize", "--features", planted.features_csv, "--cameras",
            planted.cameras_csv, "--pixel-x", planted.pixel_x, "--pixel-y",
            planted.pixel_y, "--width", str(planted.image_size[0]), "--height",
            str(planted.image_size[1]), "--output", str(output), "--device", "cpu"]


def test_report_and_viz_pass_render(planted, tmp_path):
    """``--report`` draws its eight PNGs, ``--viz-pass`` its location CSV,
    report CSVs and three dashboards."""
    pytest.importorskip("matplotlib")
    image = tmp_path / "image.npy"
    np.save(image, np.zeros((32, 48), np.uint8))
    assert cli.main(_cli_args(planted, tmp_path / "r.jpg")
                    + ["--report", "--viz-pass", "5.0", "--image", str(image)]) == 0
    names = ["output", "err_hist", "rose", "nn", "H", "ransac", "scores", "pose"]
    files = ([f"r_{k}.png" for k in names]
             + [f"r_viz_{k}.png" for k in ("accuracies", "correlations", "locations")]
             + ["r_accuracies.csv", "r_correlations.csv", "r_viz_location.csv",
                "r_viz_accuracies.csv", "r_viz_correlations.csv"])
    for name in files:
        assert os.path.getsize(tmp_path / name) > 0, name
    with open(tmp_path / "r_output.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plot_without_matplotlib_names_it(monkeypatch):
    """Where matplotlib is missing, a plot raises an ImportError naming it."""
    import builtins

    from ransac_tpu_torch import viz

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="matplotlib"):
        viz.plot_homography_heatmap(np.eye(3))


def test_report_without_matplotlib_writes_the_csvs(planted, tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(cli, "_have_matplotlib", lambda: False)
    assert cli.main(_cli_args(planted, tmp_path / "m.jpg") + ["--report"]) == 0
    assert "plots are not" in capsys.readouterr().err
    assert (tmp_path / "m_accuracies.csv").exists()
    assert not list(tmp_path.glob("*.png"))


def test_report_on_cpu_tensors_only(localized, tmp_path):
    """The report projects on the scene's device; a CPU scene stays there."""
    _, _, ts, rt, _, all_t = localized
    assert ts.device == torch.device("cpu")
    acc, _ = tl.export_best_candidate_report(ts, rt, str(tmp_path / "c.jpg"),
                                             make_plots=False)
    assert len(acc) == 14  # the 13 annotated rows without all_features
