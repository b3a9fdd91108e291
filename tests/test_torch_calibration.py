"""The calibration slice of the port (``ops.linalg.solve_spd_gj``, the LM
above 16 parameters, ``ops.projection``'s lens model,
``models.calibration``, the calibration file) against the JAX
package on the CPU, on the same numpy-seeded inputs.

The JAX calibration runs once, in a module fixture, on views made as in
its own cv2 test (``tests/test_calibration_analytics.py``: seeded poses of
a 9 x 6 board, k1 = 0.05, k2 = -0.02, 0.1 px of noise), 4 of them: the
fewest on which both calibrations meet that test's truth bounds (3 views
miss k2).  ``localize --calibration`` is held in
``test_torch_intrinsics.py``.  Tolerances:
``solve_spd_gj`` rtol 1e-5; ``distort`` / ``undistort_normalized`` atol
1e-6; the closed-form intrinsics and extrinsics rtol 1e-4 (K's skew, a
small difference of large products, within 1e-4 of K's largest entry);
the joint LM: K
within 0.1% of JAX's, dist[:2] within 1e-3, RMS within 1%;
``optimal_new_camera_matrix`` and its roi rtol 1e-4; ``undistort_image``
atol 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ransac_tpu import cli as jcli
from ransac_tpu.io import tables as jt
from ransac_tpu.models import calibration as jc
from ransac_tpu.ops import linalg as jl
from ransac_tpu.ops import lm as jlm
from ransac_tpu.ops import projection as jproj
from ransac_tpu_torch import cli as tcli
from ransac_tpu_torch.io import tables as tt
from ransac_tpu_torch.io.synthetic import (LENS_DIST, film_K, write_planted_calibration,
                                           write_planted_scene)
from ransac_tpu_torch.models import calibration as tc
from ransac_tpu_torch.ops import homography as th
from ransac_tpu_torch.ops import linalg as tl
from ransac_tpu_torch.ops import lm as tlm
from ransac_tpu_torch.ops import projection as tproj
from ransac_tpu_torch.ops.rotation import exp_so3
from torch_threads import one_torch_thread  # noqa: F401

K_TRUE = np.array([[820.0, 0, 400.0], [0, 810.0, 300.0], [0, 0, 1.0]])
DIST_TRUE = np.array([0.05, -0.02, 0.0, 0.0, 0.0])


def synth_views(n_views=4, cols=9, rows=6, noise=0.1, seed=0):
    """The views of the JAX package's cv2 test: seeded board poses, the
    distorted projection, 0.1 px of noise."""
    rng = np.random.default_rng(seed)
    obj = tc.checkerboard_object_points(cols, rows, square=0.03)
    views = []
    for _ in range(n_views):
        rvec = rng.normal(size=3) * np.array([0.3, 0.3, 0.15])
        t = np.array([-0.12, -0.09, 0.5]) + rng.normal(size=3) * 0.05
        R = exp_so3(torch.tensor(rvec)).numpy()
        pix, z = tproj.project_points(torch.tensor(obj), torch.tensor(R), torch.tensor(t),
                                      torch.tensor(K_TRUE), torch.tensor(DIST_TRUE))
        assert (z > 0).all()
        views.append(pix.numpy() + rng.normal(scale=noise, size=(obj.shape[0], 2)))
    return obj.astype(np.float32), np.stack(views).astype(np.float32)


@pytest.fixture(scope="module")
def calibrated():
    obj, views = synth_views()
    res_j = jc.calibrate_camera(jnp.asarray(obj), jnp.asarray(views))
    tlm.reset_counts()
    res_t = tc.calibrate_camera(torch.from_numpy(obj), torch.from_numpy(views))
    return obj, views, res_j, res_t, dict(tlm.COUNTS)


# ------------------------------------------------------------ linalg / LM
@pytest.mark.parametrize("n", [17, 27, 33])
def test_solve_spd_gj_matches_jax(n):
    """Damped SPD systems (J^T J + lam diag), batched on the port's side."""
    rng = np.random.default_rng(n)
    J = rng.normal(size=(2, 2 * n, n)).astype(np.float32)
    H = np.einsum("bmi,bmj->bij", J, J)
    A = (H + 1e-3 * np.eye(n) * np.diagonal(H, axis1=1, axis2=2)[:, None, :]).astype(np.float32)
    b = rng.normal(size=(2, n)).astype(np.float32)
    x_t = tl.solve_spd_gj(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    for k in range(2):
        x_j = np.asarray(jl.solve_spd_gj(jnp.asarray(A[k]), jnp.asarray(b[k])))
        np.testing.assert_allclose(x_t[k], x_j, rtol=1e-5, atol=1e-6)
        # One item alone gives what it gives in the batch.
        one = tl.solve_spd_gj(torch.from_numpy(A[k]), torch.from_numpy(b[k])).numpy()
        np.testing.assert_array_equal(one, x_t[k])
    np.testing.assert_allclose(x_t, np.linalg.solve(A.astype(np.float64), b[..., None])[..., 0],
                               rtol=1e-3, atol=1e-4)


def test_lm_above_16_parameters_matches_jax():
    """A 20-parameter problem (the SPD Gauss-Jordan step) against the JAX
    LM: the same minimum, iterations and convergence flag; where the parent
    port raised NotImplementedError."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(40, 20)).astype(np.float32)
    b = rng.normal(size=40).astype(np.float32)
    x0 = np.zeros(20, np.float32)

    def r_t(x, A, b):
        return torch.tanh((A @ x[..., None])[..., 0]) - b * 0.5

    res_t = tlm.levenberg_marquardt(r_t, torch.from_numpy(x0)[None],
                                    (torch.from_numpy(A)[None], torch.from_numpy(b)[None]))
    res_j = jlm.levenberg_marquardt(lambda x: jnp.tanh(jnp.asarray(A) @ x) - jnp.asarray(b) * 0.5,
                                    jnp.asarray(x0))
    np.testing.assert_allclose(res_t.x[0].numpy(), np.asarray(res_j.x), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(res_t.cost[0]), float(res_j.cost), rtol=1e-3)
    assert bool(res_t.converged[0]) == bool(res_j.converged)


# ------------------------------------------------------------ projection
def test_distort_and_undistort_match_jax():
    rng = np.random.default_rng(1)
    xy = rng.uniform(-0.6, 0.6, size=(2, 500)).astype(np.float32)
    dist = np.array([0.08, -0.03, 1e-3, -2e-3, 0.005], np.float32)
    xt, yt = tproj.distort(torch.from_numpy(xy[0]), torch.from_numpy(xy[1]), torch.from_numpy(dist))
    xj, yj = jproj.distort(jnp.asarray(xy[0]), jnp.asarray(xy[1]), jnp.asarray(dist))
    np.testing.assert_allclose(xt.numpy(), xj, atol=1e-6)
    np.testing.assert_allclose(yt.numpy(), yj, atol=1e-6)
    ut, vt = tproj.undistort_normalized(xt, yt, torch.from_numpy(dist))
    uj, vj = jproj.undistort_normalized(xj, yj, jnp.asarray(dist))
    np.testing.assert_allclose(ut.numpy(), uj, atol=1e-6)
    np.testing.assert_allclose(vt.numpy(), vj, atol=1e-6)
    np.testing.assert_allclose(ut.numpy(), xy[0], atol=1e-4)  # inverts distort


def test_project_points_with_distortion_matches_jax():
    obj, views = synth_views(n_views=1)
    R = exp_so3(torch.tensor([0.1, -0.2, 0.05])).numpy()
    t = np.array([-0.1, -0.08, 0.5], np.float32)
    args = (obj, R, t, K_TRUE.astype(np.float32), DIST_TRUE.astype(np.float32))
    pt, zt = tproj.project_points(*(torch.from_numpy(np.asarray(a, np.float32)) for a in args))
    pj, zj = jproj.project_points(*(jnp.asarray(a, jnp.float32) for a in args))
    np.testing.assert_allclose(pt.numpy(), pj, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(zt.numpy(), zj, rtol=1e-6)


# ------------------------------------------------------------ Zhang
def test_closed_form_intrinsics_and_extrinsics_match_jax(calibrated):
    """On the same homographies (the port's DLT of the views)."""
    obj, views, _, _, _ = calibrated
    Hs = th.dlt_homography(torch.from_numpy(obj[:, :2]).expand(len(views), -1, -1),
                           torch.from_numpy(views)).numpy()
    K_j = np.asarray(jc.intrinsics_from_homographies(jnp.asarray(Hs)))
    K_t = tc.intrinsics_from_homographies(torch.from_numpy(Hs)).numpy()
    # rtol 1e-4, and for the skew (~0.5, a difference of products of ~800)
    # 1e-4 of the largest entry.
    np.testing.assert_allclose(K_t, K_j, rtol=1e-4, atol=1e-4 * np.abs(K_j).max())
    R_t, t_t = tc.extrinsics_from_homography(torch.from_numpy(K_j), torch.from_numpy(Hs))
    R_j, t_j = jax.jit(jax.vmap(jc.extrinsics_from_homography, (None, 0)))(
        jnp.asarray(K_j), jnp.asarray(Hs))
    np.testing.assert_allclose(R_t.numpy(), R_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), t_j, rtol=1e-4, atol=1e-6)


def test_calibrate_camera_matches_jax(calibrated):
    """K within 0.1% of JAX's, dist[:2] within 1e-3, RMS within 1%, and
    both within the truth bounds of the JAX package's cv2 test; the joint
    LM (9 + 6 x 4 = 33 parameters) stops early on its done read."""
    _, _, res_j, res_t, counts = calibrated
    K_t, K_j = res_t.K.numpy(), np.asarray(res_j.K)
    np.testing.assert_allclose(K_t, K_j, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(res_t.dist.numpy()[:2], np.asarray(res_j.dist)[:2], atol=1e-3)
    np.testing.assert_allclose(float(res_t.rms), float(res_j.rms), rtol=1e-2)
    for K, d, rms in ((K_t, res_t.dist.numpy(), float(res_t.rms)),
                      (K_j, np.asarray(res_j.dist), float(res_j.rms))):
        assert abs(K[0, 0] - K_TRUE[0, 0]) / K_TRUE[0, 0] < 0.01
        assert abs(K[1, 1] - K_TRUE[1, 1]) / K_TRUE[1, 1] < 0.01
        assert abs(K[0, 2] - K_TRUE[0, 2]) < 8.0 and abs(K[1, 2] - K_TRUE[1, 2]) < 8.0
        assert abs(d[0] - DIST_TRUE[0]) < 0.02 and abs(d[1] - DIST_TRUE[1]) < 0.05
        assert rms < 0.5
    assert res_t.rvecs.shape == res_t.tvecs.shape == (4, 3)
    # float32: no item can finish before pass 11, so the reads start at 12.
    assert counts["passes"] < 40
    assert counts["reads"] == (counts["passes"] - 12) // tlm.CHECK_EVERY + 1


def test_calibration_lm_early_exit_equals_fixed_passes(calibrated):
    """The joint LM with its done read every CHECK_EVERY passes gives the
    40 fixed passes' result (the reads off) bit for bit."""
    obj, views, _, res_t, _ = calibrated
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlm, "CHECK_EVERY", 0)
        fixed = tc.calibrate_camera(torch.from_numpy(obj), torch.from_numpy(views))
    for a, b in zip(res_t, fixed):
        assert torch.equal(a, b)


def test_calibration_result_numpy_round_trip(calibrated):
    _, _, res_j, res_t, _ = calibrated
    back = tc.calibration_from_numpy(tc.calibration_to_numpy(res_t), device="cpu")
    for a, b in zip(back, res_t):
        assert torch.equal(a, b)
    from_j = tc.calibration_from_numpy(res_j, device="cpu")
    for a, b in zip(from_j, res_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------ undistortion
@pytest.mark.parametrize("alpha", [0.0, 0.4, 1.0])
def test_optimal_new_camera_matrix_matches_jax(alpha):
    K = K_TRUE.astype(np.float32)
    dist = np.array([-0.12, 0.03, 1e-3, -5e-4, 0.0], np.float32)
    newK_t, roi_t = tc.optimal_new_camera_matrix(torch.from_numpy(K), torch.from_numpy(dist),
                                                 (800, 600), alpha=alpha)
    newK_j, roi_j = jc.optimal_new_camera_matrix(jnp.asarray(K), jnp.asarray(dist),
                                                 (800, 600), alpha=alpha)
    np.testing.assert_allclose(newK_t.numpy(), newK_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(roi_t, roi_j, rtol=1e-4, atol=1e-3)


def test_undistort_points_and_image_match_jax():
    rng = np.random.default_rng(2)
    K = np.array([[90.0, 0, 40.0], [0, 88.0, 30.0], [0, 0, 1.0]], np.float32)
    dist = np.array([0.08, -0.03, 1e-3, -2e-3, 0.005], np.float32)
    pix = rng.uniform([0, 0], [80, 60], size=(50, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tc.undistort_points(*(torch.from_numpy(a) for a in (pix, K, dist))).numpy(),
        jc.undistort_points(*(jnp.asarray(a) for a in (pix, K, dist))), rtol=1e-5, atol=1e-4)
    for img in (rng.random((60, 80)).astype(np.float32),
                rng.random((60, 80, 3)).astype(np.float32)):
        newK = np.array([[80.0, 0, 41.0], [0, 79.0, 29.0], [0, 0, 1.0]], np.float32)
        for nk in (None, newK):
            out_t = tc.undistort_image(torch.from_numpy(img), torch.from_numpy(K),
                                       torch.from_numpy(dist),
                                       None if nk is None else torch.from_numpy(nk))
            out_j = jc.undistort_image(jnp.asarray(img), jnp.asarray(K), jnp.asarray(dist),
                                       None if nk is None else jnp.asarray(nk))
            np.testing.assert_allclose(out_t.numpy(), out_j, atol=1e-4)


# ------------------------------------------------------------ localize --calibration
@pytest.fixture(scope="module")
def distorted(tmp_path_factory):
    d = tmp_path_factory.mktemp("distorted")
    ps = write_planted_scene(d, seed=0, dist=LENS_DIST)
    return ps, write_planted_calibration(os.path.join(d, "cal.npz"), ps)


def test_planted_calibration_file_has_the_cli_keys(distorted, tmp_path):
    """The planted calibration file holds the keys and dtypes that both
    packages' ``calibrate`` write, and the distortion moves the pixels."""
    ps, cal = distorted
    d = np.load(cal, allow_pickle=True)
    assert set(d.files) == {"K", "dist", "rms", "height", "width", "views"}
    assert d["K"].dtype == d["dist"].dtype == np.float64
    np.testing.assert_array_equal(d["K"], film_K(ps.image_size))
    plain = write_planted_scene(tmp_path, seed=0)
    f_d = tt.read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y)
    f_p = tt.read_points_data(plain.features_csv, plain.pixel_x, plain.pixel_y)
    shift = np.abs(f_d.pixels - f_p.pixels).max()
    assert 5.0 < shift < 100.0, shift


def test_apply_calibration_matches_jax(distorted, tmp_path):
    """Both packages' ``--calibration`` on the port's planted calibration
    file: the same K and the same undistorted pixels (float32 rounding of
    the 8 fixed-point trips).  The files of the two ``calibrate`` commands
    cross over in ``test_torch_chessboard.py``."""
    ps, cal = distorted
    f_t = tt.read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y)
    f_j = jt.read_points_data(ps.features_csv, ps.pixel_x, ps.pixel_y, use_native="never")
    K_t = tcli._apply_calibration(f_t, cal, "cpu")
    K_j = jcli._apply_calibration(f_j, cal)
    np.testing.assert_array_equal(K_t, K_j)
    np.testing.assert_allclose(f_t.pixels, f_j.pixels, rtol=0, atol=2e-3)
    # Undistortion takes the pixels back to the undistorted planted scene's.
    plain = write_planted_scene(tmp_path / "plain", seed=0)
    f_p = tt.read_points_data(plain.features_csv, plain.pixel_x, plain.pixel_y)
    ok = np.ones(len(f_p.pixels), bool)
    ok[ps.outliers] = False  # the outliers' shift is applied after the lens
    np.testing.assert_allclose(f_t.pixels[ok], f_p.pixels[ok], atol=0.05)
