"""A planted localization scene in the reference's CSV schema.

The candidate grid is the real one of the 1898 photograph (458 cameras,
``tests/fixtures/1898_location_golden.csv``: ``Z`` = easting, ``X`` =
northing, ``Y`` = z including the +2 m observer height).  Landmarks are
made from a seed: ``n`` points 1.5-4 km east of the planted candidate,
+-600 m north and -50..+250 m in z, projected through the reference's film
camera (``CameraIntrinsicsConfig`` at 2142 x 1620 px) looking along
+easting, with 0.3 px noise and ``n_outliers`` points shifted by
(+260, -210) px.  Both files are written as the reference's ``kuliang``
CSVs (WGS84 lon/lat), so the scene goes through the real ingest path.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ransac_tpu_torch.ops.geodesy import utm_to_wgs84
from ransac_tpu_torch.utils.config import CameraIntrinsicsConfig

GRID_CSV = (Path(__file__).resolve().parents[2]
            / "tests" / "fixtures" / "1898_location_golden.csv")
IMAGE_SIZE = (2142, 1620)
PIXEL_X = "Pixel_x_planted.jpg"
PIXEL_Y = "Pixel_y_planted.jpg"
OBSERVER_HEIGHT_M = 2.0
# World (E, N, z) -> camera: optical axis +easting, image x = -north,
# image y = -up.
R_EAST = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])


@dataclass(frozen=True)
class PlantedScene:
    features_csv: str
    cameras_csv: str
    pixel_x: str
    pixel_y: str
    image_size: tuple[int, int]
    planted: int              # index of the true camera in the grid
    origin_utm: np.ndarray    # [3] its (E, N, z) with observer height
    outliers: np.ndarray      # indices of the shifted landmarks


def write_planted_scene(directory, seed: int = 0, planted: int = 200,
                        n: int = 13, n_outliers: int = 2) -> PlantedScene:
    """Write ``features.csv`` and ``cameras.csv`` into ``directory``."""
    with open(GRID_CSV, encoding="utf-8") as f:
        grid = list(csv.DictReader(f))
    east = np.array([float(r["Z"]) for r in grid])
    north = np.array([float(r["X"]) for r in grid])
    up = np.array([float(r["Y"]) for r in grid])
    origin = np.array([east[planted], north[planted], up[planted]])

    rng = np.random.default_rng(seed)
    X = origin + np.stack([rng.uniform(1500.0, 4000.0, n),
                           rng.uniform(-600.0, 600.0, n),
                           rng.uniform(-50.0, 250.0, n)], axis=1)
    ic = CameraIntrinsicsConfig()
    width, height = IMAGE_SIZE
    fx = ic.focal_length_mm / ic.sensor_width_mm * width
    fy = ic.focal_length_mm / ic.sensor_height_mm * height
    Xc = (X - origin) @ R_EAST.T
    pix = np.stack([fx * Xc[:, 0] / Xc[:, 2] + ic.cx,
                    fy * Xc[:, 1] / Xc[:, 2] + ic.cy], axis=1)
    pix += rng.normal(scale=0.3, size=pix.shape)
    outliers = np.sort(rng.choice(n, n_outliers, replace=False))
    pix[outliers] += np.array([260.0, -210.0])

    os.makedirs(directory, exist_ok=True)
    features_csv = os.path.join(directory, "features.csv")
    lon, lat = utm_to_wgs84(X[:, 0], X[:, 1])
    with open(features_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["FID", "Symbol", "Name", "Height", "Longitude", "Latitude",
                    "Elevation", PIXEL_X, PIXEL_Y])
        for i in range(n):
            w.writerow([i + 1, f"L{i}", f"landmark {i}", 0.0, lon[i], lat[i],
                        X[i, 2], pix[i, 0], pix[i, 1]])
    cameras_csv = os.path.join(directory, "cameras.csv")
    lon, lat = utm_to_wgs84(east, north)
    with open(cameras_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["FID", "grid_code", "Longitude", "Latitude", "Elevation"])
        for i, r in enumerate(grid):
            w.writerow([i + 1, r["grid_code"], lon[i], lat[i],
                        up[i] - OBSERVER_HEIGHT_M])
    return PlantedScene(features_csv=features_csv, cameras_csv=cameras_csv,
                        pixel_x=PIXEL_X, pixel_y=PIXEL_Y,
                        image_size=IMAGE_SIZE, planted=planted,
                        origin_utm=origin, outliers=outliers)


# ------------------------------------------------------------ large pools
def planted_homography_pool(n: int = 1024, outlier_frac: float = 0.3,
                            seed: int = 0, noise: float = 1.0):
    """A homography pool at matching scale: ``n`` points in [-1.5, 1.5]^2
    mapped by a fixed homography to pixels, 1 px of noise, and the last
    ``outlier_frac`` of them shifted by 300 px (the planted problem of the
    JAX package's sweep tests, at pool size n).  Returns (src [n, 2],
    dst [n, 2] float32, n_inliers)."""
    rng = np.random.default_rng(seed)
    H = np.array([[900.0, 40.0, 500.0], [-15.0, 850.0, 400.0],
                  [1e-3, 2e-3, 1.0]])
    src = rng.uniform(-1.5, 1.5, size=(n, 2))
    p = np.concatenate([src, np.ones((n, 1))], 1) @ H.T
    dst = p[:, :2] / p[:, 2:] + rng.normal(scale=noise, size=(n, 2))
    n_in = n - int(round(outlier_frac * n))
    dst[n_in:] += 300.0
    return src.astype(np.float32), dst.astype(np.float32), n_in


def _rotation(rvec) -> np.ndarray:
    rvec = np.asarray(rvec, np.float64)
    th = np.linalg.norm(rvec)
    k = rvec / max(th, 1e-300)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def planted_pnp_pool(n: int = 512, outlier_frac: float = 0.3, seed: int = 0,
                     f: float = 900.0, noise: float = 0.5):
    """A PnP pool at SfM-registration scale: ``n`` world points in a 4 x 4
    x 2 box seen by a camera (f px, 800 x 600 image) at a fixed pose,
    0.5 px of noise, the last ``outlier_frac`` shifted by 120-400 px.
    Returns (X [n, 3], pixels [n, 2], K [3, 3] float32, R_true, t_true,
    n_inliers)."""
    rng = np.random.default_rng(seed)
    R = _rotation([0.12, -0.18, 0.06])
    t = np.array([0.25, -0.15, 6.5])
    X = rng.uniform(-2, 2, (n, 3)) * np.array([1, 1, 0.5])
    K = np.array([[f, 0, 400.0], [0, f, 300.0], [0, 0, 1.0]])
    Xc = X @ R.T + t
    pix = (Xc[:, :2] / Xc[:, 2:]) * f + K[:2, 2]
    pix += rng.normal(scale=noise, size=pix.shape)
    n_in = n - int(round(outlier_frac * n))
    pix[n_in:] += rng.uniform(120, 400, size=(n - n_in, 2))
    return (X.astype(np.float32), pix.astype(np.float32), K.astype(np.float32),
            R, t, n_in)


# ------------------------------------------------------------ two views
def render_dots(points3d, R, t, K, shape, seed: int = 0) -> np.ndarray:
    """Render each visible projected point as its own constellation of 4
    Gaussian blobs (a central one, three at seeded offsets, radii and
    signs), so that normalized patch descriptors can tell points apart.
    Each blob is drawn only over its +-4 sigma patch.  Returns an [H, W]
    float32 image in [0, 1]."""
    H, W = shape
    Xc = np.asarray(points3d, np.float64) @ np.asarray(R).T + np.asarray(t)
    z = Xc[:, 2]
    pix = (Xc[:, :2] / np.where(z > 0, z, 1.0)[:, None]) @ np.asarray(K)[:2, :2].T \
        + np.asarray(K)[:2, 2]
    rng = np.random.default_rng(seed)
    n = len(Xc)
    offs = rng.uniform(-5, 5, size=(n, 4, 2))
    offs[:, 0] = 0.0
    radii = rng.uniform(1.0, 2.5, size=(n, 4))
    amps = rng.uniform(0.4, 1.0, size=(n, 4)) * rng.choice(
        [1.0, 1.0, 1.0, -0.6], size=(n, 4))
    amps[:, 0] = 1.0
    img = np.zeros(shape)
    for i in np.where(z > 0)[0]:
        u, v = pix[i]
        if not (0 <= u < W and 0 <= v < H):
            continue
        for b in range(4):
            ub, vb = u + offs[i, b, 0], v + offs[i, b, 1]
            rad = int(np.ceil(4 * radii[i, b]))
            x0, x1 = max(int(ub) - rad, 0), min(int(ub) + rad + 1, W)
            y0, y1 = max(int(vb) - rad, 0), min(int(vb) + rad + 1, H)
            if x0 >= x1 or y0 >= y1:
                continue
            yy, xx = np.mgrid[y0:y1, x0:x1]
            img[y0:y1, x0:x1] += amps[i, b] * np.exp(
                -((xx - ub) ** 2 + (yy - vb) ** 2) / (2 * radii[i, b] ** 2))
    lo, hi = img.min(), img.max()
    return ((img - lo) / max(hi - lo, 1e-9)).astype(np.float32)


def two_view_pair(shape=(1024, 1024), n_points: int = 700, seed: int = 1,
                  f: float = None):
    """A rendered two-view pair: ``n_points`` landmarks in front of the
    first camera, the second camera rotated by a small seeded rotation and
    moved mostly sideways.  Returns (img1, img2, K, R_true, t_true unit)."""
    H, W = shape
    f = 0.9375 * W if f is None else f
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n_points, 3)) * np.array([2.0, 2.0, 0.8]) + [0, 0, 6]
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    R2 = _rotation([0.02, -0.06, 0.01])
    t2 = np.array([0.6, 0.05, 0.02])
    img1 = render_dots(X, np.eye(3), np.zeros(3), K, shape)
    img2 = render_dots(X, R2, t2, K, shape)
    return img1, img2, K, R2, t2 / np.linalg.norm(t2)
