"""The port's native CSV reader (``ransac_tpu_torch.io.native``, built from
``native/fastio.cpp`` into ``build/native/`` at first use) and the
``planar`` schema of ``io.tables``, against the JAX package on the CPU.

``use_native="always"`` equals ``"never"`` on the planted scene written by
``io.synthetic.write_planted_scene`` (and in the JAX package, where its
library is already built; the test never builds it: that would write into
``native/``); ``planar`` equals JAX's ``planar`` on a small written CSV;
"always" raises when the build fails and "auto" then takes the Python
path; ``native/libfastio.so`` keeps its bytes (or stays absent).
"""

import csv
import hashlib
import os

import numpy as np
import pytest

from ransac_tpu.io import tables as jt
from ransac_tpu_torch.io import native as tn
from ransac_tpu_torch.io import tables as tt
from ransac_tpu_torch.io.synthetic import write_planted_scene
from tests.conftest import REPO_ROOT

TRACKED_SO = os.path.join(REPO_ROOT, "native", "libfastio.so")


def digest(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest() if os.path.exists(path) else None


SO_BEFORE = digest(TRACKED_SO)
NATIVE_BEFORE = sorted(os.listdir(os.path.join(REPO_ROOT, "native")))


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    return write_planted_scene(tmp_path_factory.mktemp("planted"), seed=0, n_unannotated=3)


def needs_native():
    if not tn.available():
        pytest.skip(f"no C++ compiler to build the native reader: {tn.error()}")


def assert_features_equal(a, b):
    assert a.symbols == b.symbols and a.names == b.names
    for field in ("pixels", "pos3d_utm", "lonlat", "heights", "elevations"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)


def assert_cameras_equal(a, b):
    np.testing.assert_array_equal(a.grid_codes, b.grid_codes)
    np.testing.assert_allclose(a.pos3d_utm, b.pos3d_utm, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(a.lonlat, b.lonlat)


@pytest.mark.parametrize("kw", [{}, {"keep_unannotated": True, "scale": 2.0,
                                     "z_mode": "height_plus_elevation"}])
def test_native_equals_python_path(planted, kw):
    needs_native()
    ps = planted
    t_nat = tt.read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y, use_native="always",
                                **kw)
    t_py = tt.read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y, use_native="never",
                               **kw)
    assert_features_equal(t_nat, t_py)
    assert len(t_py) == 13 + 3 * bool(kw)
    j_py = jt.read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y, use_native="never",
                               **kw)
    assert_features_equal(t_nat, j_py)
    assert_cameras_equal(tt.read_camera_locations(ps.cameras_csv, use_native="always"),
                         tt.read_camera_locations(ps.cameras_csv, use_native="never"))
    assert_cameras_equal(tt.read_camera_locations(ps.cameras_csv, use_native="always"),
                         jt.read_camera_locations(ps.cameras_csv, use_native="never"))
    from ransac_tpu.io import native as jn

    if os.path.exists(TRACKED_SO) and jn.available():
        assert_features_equal(
            jt.read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y,
                                use_native="always", **kw), j_py)
        assert_cameras_equal(jt.read_camera_locations(ps.cameras_csv, use_native="always"),
                             jt.read_camera_locations(ps.cameras_csv, use_native="never"))


def test_native_calls_match_jax_bindings(tmp_path):
    needs_native()
    path = str(tmp_path / "t.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "a", "b", "name"])
        w.writerow([1, 1.5, "", "x"])
        w.writerow([2, -2.25e3, "7", "quoted,comma"])
        w.writerow([3, "nan-ish", "8.125", "y"])
    np.testing.assert_array_equal(tn.read_numeric(path, [0, 1, 2]),
                                  [[1, 1.5, 0.0], [2, -2250.0, 7.0], [3, 0.0, 8.125]])
    assert tn.count_rows(path) == 3
    assert tn.read_strings(path, 3) == ["x", "quoted,comma", "y"]
    assert tn.read_numeric(path, [1], fill_value=-1.0)[:, 0].tolist() == [1.5, -2250.0, -1.0]
    path2 = str(tmp_path / "s.csv")
    open(path2, "w").write('h1,h2\n"a,b",c\nplain,d\n')
    assert tn.read_strings(path2, 0) == ["a,b", "plain"]
    lib = tn.library_path()
    assert lib.parent == tn.BUILD_DIR and lib.exists()
    assert str(tn.BUILD_DIR).startswith(os.path.join(REPO_ROOT, "build"))


def test_always_raises_when_the_build_fails(planted, monkeypatch):
    ps = planted
    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setenv("CXX", "ransac-tpu-no-such-compiler")
    assert not tn.available() and "no-such-compiler" in tn.error()
    with pytest.raises(RuntimeError, match="cannot be built"):
        tt.read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y, use_native="always")
    with pytest.raises(RuntimeError, match="cannot be built"):
        tt.read_camera_locations(ps.cameras_csv, use_native="always")
    auto = tt.read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y)
    assert_features_equal(auto, tt.read_points_data(ps.features_csv, ps.pixel_x,
                                                    ps.pixel_y, use_native="never"))
    with pytest.raises(ValueError, match="use_native"):
        tt.read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y, use_native="yes")


def write_planar(tmp_path):
    """Planar-schema CSVs (process.py:297-348): features id, name, Height,
    x, y, Elevation, symbol, pixel columns; cameras id, name, grid code,
    x, y, elevation."""
    rng = np.random.default_rng(5)
    feats = tmp_path / "planar_features.csv"
    with open(feats, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["id", "name", "Height", "x", "y", "Elevation", "symbol", "Pixel_x_p.jpg",
                    "Pixel_y_p.jpg"])
        for i in range(9):
            px, py = (0, 0) if i == 4 else rng.uniform(10, 900, 2).round(2)
            w.writerow([i + 1, f"peak {i}", "" if i == 2 else round(rng.uniform(0, 30), 1),
                        round(rng.uniform(-5e3, 5e3), 3), round(rng.uniform(-5e3, 5e3), 3),
                        round(rng.uniform(100, 900), 2), f"S{i}", px, py])
        w.writerow([])
    cams = tmp_path / "planar_cameras.csv"
    with open(cams, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["id", "name", "grid_code", "x", "y", "elevation"])
        for i in range(7):
            w.writerow([i + 1, f"c{i}", 100 + i, round(rng.uniform(-5e3, 5e3), 3),
                        round(rng.uniform(-5e3, 5e3), 3), round(rng.uniform(100, 900), 2)])
    return str(feats), str(cams)


def test_planar_schema_matches_jax(tmp_path):
    feats, cams = write_planar(tmp_path)
    for kw in ({}, {"keep_unannotated": True, "scale": 0.5}):
        for use_native in ("auto", "always", "never"):
            got = tt.read_points_data(feats, "Pixel_x_p.jpg", "Pixel_y_p.jpg", schema="planar",
                                      use_native=use_native, **kw)
            want = jt.read_points_data(feats, "Pixel_x_p.jpg", "Pixel_y_p.jpg",
                                       schema="planar", use_native="never", **kw)
            assert_features_equal(got, want)
            assert len(got) == 8 + bool(kw)
            assert not got.lonlat.any()
    for obs in (2.0, 0.0):
        got = tt.read_camera_locations(cams, observer_height=obs, schema="planar")
        want = jt.read_camera_locations(cams, observer_height=obs, schema="planar",
                                        use_native="never")
        assert_cameras_equal(got, want)
        assert got.grid_codes.tolist() == list(range(100, 107))


def test_native_directory_is_left_alone():
    """Run last in the file: every build above went to ``build/native/``."""
    assert digest(TRACKED_SO) == SO_BEFORE
    assert sorted(os.listdir(os.path.join(REPO_ROOT, "native"))) == NATIVE_BEFORE
