"""Camera calibration: Zhang's method on checkerboard homographies (port of
``ransac_tpu.models.calibration``).

The counterpart of ``cv2.calibrateCamera`` / ``getOptimalNewCameraMatrix``
/ ``undistort`` (``testpro.py:251-287, 952-956``): per-view DLT
homographies, the closed-form intrinsics from the image of the absolute
conic, per-view extrinsics, then one joint Levenberg-Marquardt over K, the
distortion and every view's pose (9 + 6V parameters, so the LM takes the
SPD Gauss-Jordan step of ``ops.linalg.solve_spd_gj``).  Every function
works on the device of its tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ransac_tpu_torch.ops import homography as hops
from ransac_tpu_torch.ops import projection as proj
from ransac_tpu_torch.ops.lm import levenberg_marquardt
from ransac_tpu_torch.ops.rotation import exp_so3, log_so3, project_to_so3


class CalibrationResult(NamedTuple):
    K: torch.Tensor       # [3, 3]
    dist: torch.Tensor    # [5] (k1, k2, p1, p2, k3)
    rvecs: torch.Tensor   # [V, 3]
    tvecs: torch.Tensor   # [V, 3]
    rms: torch.Tensor     # 0-d reprojection RMS (px)


def calibration_to_numpy(res: CalibrationResult) -> CalibrationResult:
    """The result with numpy fields (float32, as computed)."""
    return CalibrationResult(*(np.asarray(v.detach().cpu().numpy()) for v in res))


def calibration_from_numpy(res, device="cuda") -> CalibrationResult:
    """The state carried across: the fields of a calibration result with
    numpy (or JAX) arrays, read by attribute, as float32 tensors on
    ``device``."""
    return CalibrationResult(*(
        torch.as_tensor(np.asarray(getattr(res, f), np.float32), device=device)
        for f in CalibrationResult._fields))


def checkerboard_object_points(cols: int, rows: int,
                               square: float = 1.0) -> np.ndarray:
    """Planar (z = 0) grid like cv2's objp (testpro.py:256-258), row-major
    over ``cols`` x ``rows`` (float64)."""
    g = np.mgrid[0:cols, 0:rows].T.reshape(-1, 2).astype(np.float64)
    return np.concatenate([g * square, np.zeros((g.shape[0], 1))], axis=1)


def _vij(H, i, j):
    """Zhang's v_ij rows of homographies H [..., 3, 3] -> [..., 6]."""
    return torch.stack([
        H[..., 0, i] * H[..., 0, j],
        H[..., 0, i] * H[..., 1, j] + H[..., 1, i] * H[..., 0, j],
        H[..., 1, i] * H[..., 1, j],
        H[..., 2, i] * H[..., 0, j] + H[..., 0, i] * H[..., 2, j],
        H[..., 2, i] * H[..., 1, j] + H[..., 1, i] * H[..., 2, j],
        H[..., 2, i] * H[..., 2, j],
    ], -1)


def intrinsics_from_homographies(Hs: torch.Tensor) -> torch.Tensor:
    """Closed-form Zhang from V >= 3 view homographies [V, 3, 3]: the null
    vector of the [2V, 6] v_ij stack is the image of the absolute conic,
    from which K follows.  Its sign does not matter: every formula below is
    invariant to b -> -b."""
    V = torch.stack([_vij(Hs, 0, 1), _vij(Hs, 0, 0) - _vij(Hs, 1, 1)],
                    1).reshape(-1, 6)
    _, _, Vt = torch.linalg.svd(V, full_matrices=True)
    B11, B12, B22, B13, B23, B33 = Vt[-1].unbind()
    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 * B12)
    lam = B33 - (B13 * B13 + v0 * (B12 * B13 - B11 * B23)) / B11
    alpha = torch.sqrt(torch.abs(lam / B11))
    beta = torch.sqrt(torch.abs(lam * B11 / (B11 * B22 - B12 * B12)))
    gamma = -B12 * alpha * alpha * beta / lam
    u0 = gamma * v0 / beta - B13 * alpha * alpha / lam
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    return torch.stack([torch.stack([alpha, gamma, u0]),
                        torch.stack([zero, beta, v0]),
                        torch.stack([zero, zero, one])])


def extrinsics_from_homography(K: torch.Tensor, H: torch.Tensor):
    """Per-view (R, t) from H = K [r1 r2 t] (the plane z = 0), batched over
    H's leading dimensions; t_z > 0 (the board in front of the camera)."""
    A = torch.linalg.solve_ex(K.expand_as(H), H)[0]
    lam = 1.0 / torch.clamp(torch.linalg.vector_norm(A[..., :, 0], dim=-1), min=1e-12)
    lam = lam * torch.where(A[..., 2, 2] < 0, -1.0, 1.0)
    r1 = A[..., :, 0] * lam[..., None]
    r2 = A[..., :, 1] * lam[..., None]
    r3 = torch.linalg.cross(r1, r2)
    R = project_to_so3(torch.stack([r1, r2, r3], -1))
    return R, A[..., :, 2] * lam[..., None]


def _unpack(x, n_views):
    """x [B, 9 + 6V] -> (K [B, 3, 3], dist [B, 5], rvecs, tvecs [B, V, 3])."""
    fx, fy, cx, cy = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    K = torch.stack([torch.stack([fx, zero, cx], -1),
                     torch.stack([zero, fy, cy], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    rv = x[:, 9:9 + 3 * n_views].reshape(-1, n_views, 3)
    tv = x[:, 9 + 3 * n_views:].reshape(-1, n_views, 3)
    return K, x[:, 4:9], rv, tv


def _reprojection_residuals(x, object_points, image_points):
    n_views = image_points.shape[1]
    K, dist, rv, tv = _unpack(x, n_views)
    pix, _ = proj.project_points(object_points[:, None], exp_so3(rv), tv,
                                 K[:, None], dist[:, None])
    return (pix - image_points).flatten(1)


def calibrate_camera(object_points: torch.Tensor, image_points: torch.Tensor,
                     refine_iters: int = 40) -> CalibrationResult:
    """Zhang's pipeline (``cv2.calibrateCamera``): object_points [P, 3] on
    the plane z = 0, image_points [V, P, 2] -> per-view DLT homography,
    closed-form K, per-view extrinsics, then one joint LM over [fx, fy, cx,
    cy, k1, k2, p1, p2, k3, rvecs (3V), tvecs (3V)] on the reprojection
    error, run as a batch of one."""
    n_views = image_points.shape[0]
    board2d = object_points[:, :2]
    Hs = hops.dlt_homography(board2d.expand(n_views, -1, -1), image_points)
    K0 = intrinsics_from_homographies(Hs)
    Rs, ts = extrinsics_from_homography(K0, Hs)
    x0 = torch.cat([torch.stack([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]]),
                    torch.zeros(5, dtype=K0.dtype, device=K0.device),
                    log_so3(Rs).reshape(-1), ts.reshape(-1)])[None]
    args = (object_points[None], image_points[None])
    res = levenberg_marquardt(_reprojection_residuals, x0, args,
                              max_iters=refine_iters)
    K, dist, rv, tv = _unpack(res.x, n_views)
    r = _reprojection_residuals(res.x, *args)
    n_pts = image_points.numel() / 2
    rms = torch.sqrt((r * r).sum() / n_pts)
    return CalibrationResult(K=K[0], dist=dist[0], rvecs=rv[0], tvecs=tv[0], rms=rms)


def optimal_new_camera_matrix(K: torch.Tensor, dist: torch.Tensor,
                              image_size: tuple, alpha: float = 1.0,
                              grid_n: int = 9):
    """``cv2.getOptimalNewCameraMatrix``: undistort a grid_n x grid_n grid
    over the image, take the outer (every source pixel kept, alpha = 1) and
    inner (no invalid pixel, alpha = 0) rectangles, and map their
    alpha-blend onto the whole image.  Returns (newK [3, 3], roi = (x, y,
    w, h) as floats)."""
    W, H = image_size
    dt, dev = K.dtype, K.device
    us = torch.linspace(0.0, W - 1.0, grid_n, dtype=dt, device=dev)
    vs = torch.linspace(0.0, H - 1.0, grid_n, dtype=dt, device=dev)
    VV, UU = torch.meshgrid(vs, us, indexing="ij")
    pix = torch.stack([UU.reshape(-1), VV.reshape(-1)], -1)
    und = undistort_points(pix, K, dist).reshape(grid_n, grid_n, 2)
    outer_x0, outer_x1 = und[..., 0].min(), und[..., 0].max()
    outer_y0, outer_y1 = und[..., 1].min(), und[..., 1].max()
    inner_x0, inner_x1 = und[:, 0, 0].max(), und[:, -1, 0].min()
    inner_y0, inner_y1 = und[0, :, 1].max(), und[-1, :, 1].min()
    a = min(max(float(alpha), 0.0), 1.0)
    x0 = inner_x0 * (1 - a) + outer_x0 * a
    x1 = inner_x1 * (1 - a) + outer_x1 * a
    y0 = inner_y0 * (1 - a) + outer_y0 * a
    y1 = inner_y1 * (1 - a) + outer_y1 * a
    sx = W / torch.clamp(x1 - x0, min=1e-9)
    sy = H / torch.clamp(y1 - y0, min=1e-9)
    zero, one = torch.zeros_like(sx), torch.ones_like(sx)
    newK = torch.stack([torch.stack([K[0, 0] * sx, zero, (K[0, 2] - x0) * sx]),
                        torch.stack([zero, K[1, 1] * sy, (K[1, 2] - y0) * sy]),
                        torch.stack([zero, zero, one])])
    rx0, ry0 = (inner_x0 - x0) * sx, (inner_y0 - y0) * sy
    rx1, ry1 = (inner_x1 - x0) * sx, (inner_y1 - y0) * sy
    roi = (float(rx0.clamp(0, W - 1)), float(ry0.clamp(0, H - 1)),
           float((rx1 - rx0).clamp(0, W)), float((ry1 - ry0).clamp(0, H)))
    return newK, roi


def undistort_points(pixels: torch.Tensor, K: torch.Tensor,
                     dist: torch.Tensor) -> torch.Tensor:
    """``cv2.undistortPoints`` (pixel coordinates under K): pixels
    [..., N, 2]."""
    xn = proj.normalize_pixels(pixels, K)
    xu, yu = proj.undistort_normalized(xn[..., 0], xn[..., 1], dist)
    return torch.stack([K[0, 0] * xu + K[0, 2], K[1, 1] * yu + K[1, 2]], -1)


def undistort_image_map(width: int, height: int, K: torch.Tensor,
                        dist: torch.Tensor, new_K: torch.Tensor | None = None):
    """Sampling map of ``cv2.initUndistortRectifyMap``: for each output
    pixel (under ``new_K``, default K) the distorted source pixel, as
    (map_x, map_y) [height, width]."""
    if new_K is None:
        new_K = K
    v, u = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=K.device),
        torch.arange(width, dtype=torch.float32, device=K.device), indexing="ij")
    xn = (u - new_K[0, 2]) / new_K[0, 0]
    yn = (v - new_K[1, 2]) / new_K[1, 1]
    xd, yd = proj.distort(xn, yn, dist)
    return K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]


def undistort_image(img: torch.Tensor, K: torch.Tensor, dist: torch.Tensor,
                    new_K: torch.Tensor | None = None) -> torch.Tensor:
    """``cv2.undistort``: bilinear remap of a [H, W] (or [H, W, C]) image
    through the undistortion map; outside the source, 0."""
    H, W = img.shape[:2]
    mx, my = undistort_image_map(W, H, K, dist, new_K)
    x0 = torch.floor(mx).to(torch.int64).clamp(0, W - 2)
    y0 = torch.floor(my).to(torch.int64).clamp(0, H - 2)
    fx = torch.clamp(mx - x0, 0.0, 1.0)
    fy = torch.clamp(my - y0, 0.0, 1.0)
    inside = (mx >= 0) & (mx <= W - 1) & (my >= 0) & (my <= H - 1)
    if img.dim() == 3:
        fx, fy, inside = fx[..., None], fy[..., None], inside[..., None]
    out = (img[y0, x0] * (1 - fy) * (1 - fx)
           + img[y0 + 1, x0] * fy * (1 - fx)
           + img[y0, x0 + 1] * (1 - fy) * fx
           + img[y0 + 1, x0 + 1] * fy * fx)
    return torch.where(inside, out, 0.0)
