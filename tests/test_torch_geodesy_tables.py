"""The port's host path — geodesy (``ransac_tpu_torch.ops.geodesy``) and
CSV ingest (``ransac_tpu_torch.io.tables``) — against the JAX package's
host path on the same inputs.  Geodesy is float64 on both sides: agreement
is required to 1 mm (it is in fact to float64 rounding)."""

import csv

import numpy as np
import pytest
import torch

from ransac_tpu.io import tables as jt
from ransac_tpu.ops import geodesy as jg
from ransac_tpu_torch.io import tables as tt
from ransac_tpu_torch.io.synthetic import GRID_CSV, write_planted_scene
from ransac_tpu_torch.ops import geodesy as tg
from torch_threads import one_torch_thread  # noqa: F401

MM = 1e-3


def test_utm_forward_and_inverse_match_jax():
    rng = np.random.default_rng(0)
    lon = rng.uniform(114.0, 120.0, 200)
    lat = rng.uniform(-60.0, 70.0, 200)
    for northern in (True, False):
        e_t, n_t = tg.wgs84_to_utm(lon, lat, 50, northern)
        e_j, n_j = jg.wgs84_to_utm(lon, lat, 50, northern)
        np.testing.assert_allclose(e_t, e_j, rtol=0, atol=MM)
        np.testing.assert_allclose(n_t, n_j, rtol=0, atol=MM)
        lo_t, la_t = tg.utm_to_wgs84(e_t, n_t, 50, northern)
        lo_j, la_j = jg.utm_to_wgs84(e_j, n_j, 50, northern)
        np.testing.assert_allclose(lo_t, lo_j, rtol=0, atol=1e-9)
        np.testing.assert_allclose(la_t, la_j, rtol=0, atol=1e-9)
        np.testing.assert_allclose(lo_t, lon, rtol=0, atol=1e-9)


def test_geo_transformer_and_scene_frame():
    tr = tg.GeoTransformer()
    e, n = tr.wgs84_to_utm(119.39055, 26.09361)
    ej, nj = jg.GeoTransformer().wgs84_to_utm(119.39055, 26.09361)
    assert abs(e - ej) < MM and abs(n - nj) < MM
    assert abs(e - 739093.6) < 1.0 and abs(n - 2888245.3) < 1.0
    with pytest.raises(ValueError):
        tr.utm_to_wgs84(np.nan, 0.0)
    pts = np.array([[739093.6, 2888245.3, 712.0], [741000.0, 2889000.0, 650.0]])
    ft, fj = tg.SceneFrame.from_points(pts), jg.SceneFrame.from_points(pts)
    np.testing.assert_array_equal(ft.anchor, fj.anchor)
    np.testing.assert_array_equal(ft.center(pts), fj.center(pts))
    np.testing.assert_allclose(ft.uncenter(ft.center(pts)), pts, atol=0.05)
    for a, b in zip(ft.to_wgs84(ft.center(pts)), fj.to_wgs84(fj.center(pts))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    return write_planted_scene(tmp_path_factory.mktemp("planted"), seed=3)


def test_read_points_and_cameras_match_jax(planted):
    ft = tt.read_points_data(planted.features_csv, planted.pixel_x, planted.pixel_y)
    fj = jt.read_points_data(planted.features_csv, planted.pixel_x,
                             planted.pixel_y, use_native="never")
    for field in ("pixels", "pos3d_utm", "lonlat", "heights", "elevations"):
        np.testing.assert_allclose(getattr(ft, field), getattr(fj, field),
                                   rtol=0, atol=MM)
    assert ft.symbols == fj.symbols and ft.names == fj.names
    ct = tt.read_camera_locations(planted.cameras_csv)
    cj = jt.read_camera_locations(planted.cameras_csv, use_native="never")
    np.testing.assert_array_equal(ct.grid_codes, cj.grid_codes)
    np.testing.assert_allclose(ct.pos3d_utm, cj.pos3d_utm, rtol=0, atol=MM)
    assert len(ct) == 458 and len(ft) == 13


def test_build_scene_and_scene_from_numpy_match_jax(planted):
    ft = tt.read_points_data(planted.features_csv, planted.pixel_x, planted.pixel_y)
    ct = tt.read_camera_locations(planted.cameras_csv)
    st = tt.build_scene(ft, ct, device="cpu")
    sj = jt.build_scene(
        jt.read_points_data(planted.features_csv, planted.pixel_x,
                            planted.pixel_y, use_native="never"),
        jt.read_camera_locations(planted.cameras_csv, use_native="never"))
    carried = tt.scene_from_numpy(sj, device="cpu")
    for s in (st, carried):
        for field in ("pixels", "pos3d", "point_mask", "cam_locs"):
            got = getattr(s, field)
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_allclose(got.numpy(), getattr(sj, field), rtol=0,
                                       atol=MM)
        np.testing.assert_array_equal(s.grid_codes.numpy(), sj.grid_codes)
        np.testing.assert_allclose(s.frame.anchor, sj.frame.anchor, rtol=0, atol=MM)
    # The planted camera round-trips the lon/lat CSV to the grid's UTM.
    np.testing.assert_allclose(ct.pos3d_utm[planted.planted], planted.origin_utm,
                               rtol=0, atol=MM)


def test_unannotated_rows_and_scale(tmp_path, planted):
    rows = list(csv.reader(open(planted.features_csv, encoding="utf-8")))
    rows[2][7] = rows[2][8] = "0"       # an unannotated landmark
    rows[3][3] = ""                     # empty Height reads as 0.0
    path = tmp_path / "features.csv"
    with open(path, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows(rows)
    for kw in ({}, {"keep_unannotated": True, "scale": 2.0,
                    "z_mode": "height_plus_elevation"}):
        ft = tt.read_points_data(str(path), planted.pixel_x, planted.pixel_y, **kw)
        fj = jt.read_points_data(str(path), planted.pixel_x, planted.pixel_y,
                                 use_native="never", **kw)
        np.testing.assert_allclose(ft.pixels, fj.pixels, rtol=0, atol=MM)
        np.testing.assert_allclose(ft.pos3d_utm, fj.pos3d_utm, rtol=0, atol=MM)
        np.testing.assert_array_equal(ft.point_mask, fj.point_mask)
    assert len(tt.read_points_data(str(path), planted.pixel_x, planted.pixel_y)) == 12


def test_planted_scene_uses_the_in_repo_grid(planted):
    grid = list(csv.DictReader(open(GRID_CSV, encoding="utf-8")))
    assert len(grid) == 458
    g = grid[planted.planted]
    np.testing.assert_array_equal(
        planted.origin_utm, [float(g["Z"]), float(g["X"]), float(g["Y"])])
    assert len(planted.outliers) == 2
