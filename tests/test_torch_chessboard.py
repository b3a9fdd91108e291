"""The chessboard front end of the port (``features.chessboard``,
``io.synthetic``'s board renderer, ``cli calibrate``) against the JAX
package on the CPU.

Boards are rendered by ``io.synthetic.write_boards`` (the counterpart of
the JAX package's ``render_checkerboard`` test helper): 4 seeded views of
a board of 6 x 4 inner corners at 320 x 240, read from their PNGs as both
``cli calibrate`` commands read them (8-bit gray values as float32).  The
JAX side runs once, in a module fixture: its detector on every board, then
its ``cli calibrate`` on the PNGs (given those detections rather than
detecting again).  Tolerances: the saddle response within 1e-5 of its
largest value (``conv2d`` and XLA's convolution sum in other orders);
corners within 0.05 px of JAX's in either labelling of the board's
180-degree symmetry (which of the two the grid ordering picks is a
near-tie: a defect of the reference, not asserted), with the same found /
not-found decision; ``calibrate``'s K within 0.1% of JAX's, with the
same .npz keys and dtypes.
"""

import glob
import inspect
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu import cli as jcli
from ransac_tpu.features import chessboard as jcb
from ransac_tpu_torch import cli as tcli
from ransac_tpu_torch.features import chessboard as tcb
from ransac_tpu_torch.io.synthetic import render_checkerboard, write_boards
from torch_threads import one_torch_thread  # noqa: F401

COLS, ROWS, SHAPE, VIEWS = 6, 4, (240, 320), 4
CORNER_PX = 0.05


@pytest.fixture(scope="module")
def boards(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("boards")
    paths, K, corners = write_boards(d, VIEWS, COLS, ROWS, seed=0, shape=SHAPE,
                                     formats=("npy", "png"), device="cpu")
    imgs = [np.asarray(Image.open(p).convert("L"), np.float32)
            for p in paths if p.endswith(".png")]
    jax_found = [jcb.find_chessboard_corners(img, COLS, ROWS) for img in imgs]
    detect = jcb.find_chessboard_corners

    def detected(img, cols, rows, **kw):
        for known, found in zip(imgs, jax_found):
            if np.array_equal(img, known) and (cols, rows) == (COLS, ROWS):
                return found
        return detect(img, cols, rows, **kw)

    out = str(d / "jax.npz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcb, "find_chessboard_corners", detected)
        rc = jcli.main(["calibrate", "--images", str(d / "board*.png"), "--cols", str(COLS),
                        "--rows", str(ROWS), "--out", out])
    assert rc in (0, None)
    return d, imgs, K, corners, jax_found, out


def test_saddle_response_matches_jax(boards):
    img = boards[1][0]
    r_t = tcb.saddle_response(torch.from_numpy(img)).numpy()
    r_j = np.asarray(jcb.saddle_response(jnp.asarray(img)))
    np.testing.assert_allclose(r_t, r_j, rtol=0, atol=1e-5 * np.abs(r_j).max())


@pytest.mark.parametrize("view", range(VIEWS))
def test_corners_match_jax(boards, view):
    """Found on both sides, within CORNER_PX of JAX's corners and within
    0.5 px of the rendered truth, each in either labelling of the board's
    180-degree symmetry (ROADMAP, defects of the reference)."""
    _, imgs, _, corners, jax_found, _ = boards
    found_t, c_t = tcb.find_chessboard_corners(imgs[view], COLS, ROWS, device="cpu")
    found_j, c_j = jax_found[view]
    assert found_t and found_j
    assert c_t.shape == (COLS * ROWS, 2) and c_t.dtype == np.float64
    d = min(np.abs(c_t - c_j).max(), np.abs(c_t - c_j[::-1]).max())
    assert d <= CORNER_PX, d
    truth = corners[view]
    err = min(np.abs(c_t - truth).max(), np.abs(c_t - truth[::-1]).max())
    assert err < 0.5, err


def test_not_found_decisions_match_jax(boards):
    """A board half covered by paper, and a blank image: not found on both
    sides."""
    img = boards[1][0].copy()
    img[:, : SHAPE[1] // 2] = 242.0
    assert jcb.find_chessboard_corners(img, COLS, ROWS)[0] is False
    assert tcb.find_chessboard_corners(img, COLS, ROWS, device="cpu") == (False, None)
    blank = np.full(SHAPE, 128.0, np.float32)
    assert tcb.find_chessboard_corners(blank, COLS, ROWS, device="cpu") == (False, None)
    assert jcb.find_chessboard_corners(blank, COLS, ROWS)[0] is False


def test_rendered_board_corners_are_the_homography_images():
    """The renderer's inner corners are H applied to the inner grid, and its
    image holds the two shades inside and paper outside the board."""
    H = np.array([[38.0, 3.0, 120.0], [-2.0, 40.0, 60.0], [1e-4, 5e-5, 1.0]])
    img, c = render_checkerboard(H, cols=9, rows=6, device="cpu")
    assert img.shape == (480, 640) and img.dtype == torch.float32
    g = np.array([1.0, 1.0, 1.0])
    p = H @ g
    np.testing.assert_allclose(c[0], p[:2] / p[2], rtol=1e-12)
    assert c.shape == (40, 2)
    assert float(img[0, 0]) == pytest.approx(0.95) and float(img.min()) == pytest.approx(0.05)


def test_board_entry_points_default_to_the_card():
    """The detector and the board renderers run on the card unless the
    caller asks for the CPU; where there is no CUDA the default fails."""
    for fn in (tcb.find_chessboard_corners, render_checkerboard, write_boards):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tcb.find_chessboard_corners(np.zeros(SHAPE, np.float32), COLS, ROWS)


def test_cli_calibrate_png_matches_jax(boards, tmp_path, capsys):
    """``cli calibrate`` on the boards' PNGs (8-bit, read through PIL as the
    JAX command reads them): the .npz holds JAX's keys and dtypes, K within
    0.1% of JAX's; the .npy boards give the same calibration; and each
    package's ``localize --calibration`` reads the other's .npz."""
    d, _, K_true, _, _, jax_npz = boards
    out = str(tmp_path / "port.npz")
    assert tcli.main(["calibrate", "--images", str(d / "board*.png"), "--cols", str(COLS),
                      "--rows", str(ROWS), "--out", out, "--device", "cpu"]) == 0
    t, j = np.load(out), np.load(jax_npz)
    assert set(t.files) == set(j.files)
    for k in t.files:
        assert t[k].dtype.kind == j[k].dtype.kind, k
    np.testing.assert_allclose(t["K"], j["K"], rtol=1e-3, atol=0)
    assert [str(v) for v in t["views"]] == sorted(glob.glob(str(d / "board*.png")))
    assert (int(t["height"]), int(t["width"])) == SHAPE
    assert abs(t["K"][0, 0] - K_true[0, 0]) / K_true[0, 0] < 0.03 and float(t["rms"]) < 1.0
    out_npy = str(tmp_path / "npy.npz")
    assert tcli.main(["calibrate", "--images", str(d / "board*.npy"), "--cols", str(COLS),
                      "--rows", str(ROWS), "--out", out_npy, "--device", "cpu"]) == 0
    np.testing.assert_allclose(np.load(out_npy)["K"], t["K"], rtol=1e-3)
    assert "corners found" in capsys.readouterr().out
    # Each package's --calibration reads the other's file: the same pixels
    # as the file's own package gives.
    pix = np.random.default_rng(0).uniform([10, 10], [310, 230], size=(12, 2))
    for path in (out, jax_npz):
        f_t, f_j = SimpleNamespace(pixels=pix.copy()), SimpleNamespace(pixels=pix.copy())
        np.testing.assert_array_equal(tcli._apply_calibration(f_t, path, "cpu"),
                                      jcli._apply_calibration(f_j, path))
        np.testing.assert_allclose(f_t.pixels, f_j.pixels, rtol=0, atol=2e-3)
        assert not np.allclose(f_t.pixels, pix)
