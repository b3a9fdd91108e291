"""The benchmark's inputs and its comparison, on the CPU at small cuts:
generators fixed by the seed, the reference agreeing with the port's CPU
path, the control and the planted faults coming out not correct, and no
JAX in a run.  The chip's half is the ``cuda`` test at the end.

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(HERE / "lib"), str(ROOT)]

import kind_localize as kl  # noqa: E402
import kind_pixel_to_geo as kg  # noqa: E402
import readings  # noqa: E402
import run  # noqa: E402
import scenes  # noqa: E402

BIG_SEED = 2**31 + 2**30 + 12345
LOC = {"candidates": 24, "traffic": {"scenes": 2}}
GEO = {"candidates": 24, "traffic": {"pixels": 21}}
CASES = [("kuliang1898.engine", LOC), ("kuliang1898-dem.repl21", GEO)]


def cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def traffic(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", [0, BIG_SEED])
def test_photos_and_terrain_are_fixed_by_the_seed(seed):
    c = cfg("kuliang1898-dem")
    (g1, p1), (g2, p2) = (kl.make_photos(c, 3, seed) for _ in range(2))
    _, p3 = kl.make_photos(c, 3, seed + 1)
    for a, b, d in zip(p1, p2, p3):
        assert a.planted == b.planted
        np.testing.assert_array_equal(a.pixels, b.pixels)
        np.testing.assert_array_equal(a.landmarks, b.landmarks)
        assert not np.array_equal(a.pixels, d.pixels)
    t1, t2 = (scenes.planted_terrain(p1[0], c["dem"], 2.0) for _ in range(2))
    np.testing.assert_array_equal(t1.data, t2.data)
    assert min(t1.data.shape) >= 400  # 12 km at 30 m


@pytest.mark.parametrize("i", [0, 5])
def test_request_pixels_are_fixed_by_the_seed(i):
    c, t = cfg("kuliang1898-dem"), traffic("repl21")
    a = kg.request_pixels(c, t, BIG_SEED, i)
    np.testing.assert_array_equal(a, kg.request_pixels(c, t, BIG_SEED, i))
    assert not np.array_equal(a, kg.request_pixels(c, t, BIG_SEED, i + 1))
    assert a.shape == (t["pixels"], 2)
    w, h = c["image_size"]
    assert (a >= 0).all() and (a[:, 0] <= w).all() and (a[:, 1] <= h).all()


def test_sessions_walk_the_same_requests_for_one_seed(tmp_path):
    t = dict(traffic("engine"), scenes=4)
    s1 = kl.Session(cfg("kuliang1898"), t, 9, "cpu", str(tmp_path / "a"), 24)
    s2 = kl.Session(cfg("kuliang1898"), t, 9, "cpu", str(tmp_path / "b"), 24)
    assert [s1.next_input(i) for i in range(8)] == [s2.next_input(i) for i in range(8)]


@pytest.mark.parametrize("cell,cut", CASES)
def test_the_port_on_the_cpu_is_correct_by_the_reference(cell, cut):
    result = run.run_cell(cell, BIG_SEED, 0.5, False, device="cpu", cut=cut)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell,cut", CASES)
def test_the_control_is_not_correct(cell, cut):
    """The reference in float32 with TF32 products, in the program's place."""
    r = readings.readings(cell, 11, 2 if "dem" not in cell else 4, device="cpu", cut=cut)
    over = {k: n for k, n in r["numbers"].items() if not n["value"] <= n["limit"]}
    assert over and r["failed"] > 0, r


def _answer_altered_localize(monkeypatch):
    from ransac_tpu_torch.pipelines import localize as loc

    real = loc.localize

    def altered(*a, **k):
        res = real(*a, **k)
        res.camera_origin_utm = res.camera_origin_utm + np.array([0.0, 0.0, 0.5])
        return res

    monkeypatch.setattr(loc, "localize", altered)


def _pnp_inliers_altered(flip_to: bool):
    """The PnP inlier mask altered where it is produced: the first outlier
    kept as an inlier (``flip_to`` True), or the first inlier dropped; the
    pose is left as it was."""

    def plant(monkeypatch):
        from ransac_tpu_torch.pipelines import localize as loc

        real = loc.localize

        def altered(*a, **k):
            res = real(*a, **k)
            mask = np.array(res.pnp_inliers, bool)
            mask[int(np.flatnonzero(mask != flip_to)[0])] = flip_to
            res.pnp_inliers = mask
            return res

        monkeypatch.setattr(loc, "localize", altered)

    return plant


def _half_the_candidates_left_out(monkeypatch):
    from ransac_tpu_torch.pipelines import localize as loc

    real = loc.score_candidates

    def half(pixels, pos3d, point_mask, cam_locs, grid_codes, cfg):
        c = cam_locs.shape[0] // 2
        out = real(pixels, pos3d, point_mask, cam_locs[:c], grid_codes[:c], cfg)
        return {k: (torch.cat([v, v]) if v.dim() else v) for k, v in out.items()}

    monkeypatch.setattr(loc, "score_candidates", half)


def _answer_altered_geo(monkeypatch):
    from ransac_tpu_torch.pipelines import raycast

    real = raycast.GeoInverter.pixel_to_geo

    def altered(self, pixels):
        utm, hit = real(self, pixels)
        utm = utm.copy()
        utm[0] += np.array([3.0, 0.0, 0.0])
        return utm, hit

    monkeypatch.setattr(raycast.GeoInverter, "pixel_to_geo", altered)


def _half_the_rays_left_out(monkeypatch):
    from ransac_tpu_torch.pipelines import raycast

    real = raycast.GeoInverter.march

    def half(self, rays):
        n = rays.shape[0] // 2
        pos, hit = real(self, rays[:n])
        rest = self._f32(self.ray_origin).expand(rays.shape[0] - n, 3)
        return torch.cat([pos, rest]), torch.cat([hit, torch.zeros_like(hit[:1]).expand(rays.shape[0] - n)])

    monkeypatch.setattr(raycast.GeoInverter, "march", half)


@pytest.mark.parametrize("cell,cut,fault,number", [
    ("kuliang1898.engine", LOC, _answer_altered_localize, "origin_gap_m"),
    ("kuliang1898.engine", LOC, _pnp_inliers_altered(True), "pnp_mask_gap_px2"),
    ("kuliang1898.engine", LOC, _pnp_inliers_altered(False), "pnp_mask_gap_px2"),
    ("kuliang1898.engine", LOC, _half_the_candidates_left_out, None),
    ("kuliang1898-dem.repl21", GEO, _answer_altered_geo, None),
    ("kuliang1898-dem.repl21", GEO, _half_the_rays_left_out, None),
], ids=["answer", "pnp_outlier_kept", "pnp_inlier_dropped", "half_candidates",
        "geo_answer", "half_rays"])
def test_a_run_with_the_timed_path_broken_is_not_correct(cell, cut, fault, number, monkeypatch):
    """The harness's run past its look for a card, with a fault planted
    under the timed path: an answer altered where it is produced, or half
    of the batch (candidates, rays) left out."""
    fault(monkeypatch)
    result = run.run_cell(cell, 21, 0.5, False, device="cpu", cut=cut)
    assert not result["correct"] and result["failed"] > 0, result["checks"]
    if number:  # the number that holds what the fault breaks catches it
        assert not result["checks"][number]["value"] <= result["checks"][number]["limit"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ransac_tpu_torch_fake.sub", object())
    assert "ransac_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ransac_tpu.sub", object())
    assert "ransac_tpu" in run.forbidden_modules()


def test_a_cells_set_up_loads_no_jax(tmp_path):
    code = ("import json, sys; sys.path[:0] = ['benchmark', 'benchmark/lib']; "
            "import run, kind_pixel_to_geo as kg; "
            "c = run.load('configs', 'kuliang1898-dem'); t = run.load('traffic', 'repl21'); "
            f"s = kg.Session(c, t, 3, 'cpu', {str(tmp_path)!r}, 24); "
            "s.request(s.next_input(0)); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "ransac_tpu_torch" in top and "torch" in top
    assert not top & set(run.FORBIDDEN), top & set(run.FORBIDDEN)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for c, _ in CASES])
def test_the_control_at_the_cells_size_on_the_card(cell):
    """On the card, at the cell's own size, the control's readings fail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = readings.readings(cell, 31, None)
    assert any(not n["value"] <= n["limit"] for n in r["numbers"].values()), r
