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
