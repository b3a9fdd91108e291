"""The benchmark's inputs, made from a seed: planted photographs on the
real 1898 candidate grid, and seeded terrain for the DEM deployment.

Frozen copies of ``ransac_tpu_torch/io/synthetic.py``'s generators
(``write_planted_scene``, ``planted_dem``, ``write_geotiff``), so that the
traffic does not move when the program does.  Two changes: the scene is
returned as float64 arrays beside the CSVs it writes (the reference reads
the arrays, the program the CSVs), and the terrain covers a fixed square
around the camera instead of the landmarks' bounding box.

The candidate grid is ``benchmark/data/1898_location_golden.csv``, a copy
of the repository's ``tests/fixtures/1898_location_golden.csv`` (458
cameras of ``potential_camera_locations.csv`` in
``Mendel0408/Code-Reproduction-RANSAC``; ``Z`` = easting, ``X`` =
northing, ``Y`` = z including the +2 m observer height, UTM zone 50N).
"""

from __future__ import annotations

import csv
import os
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from geodesy import utm_to_wgs84, wgs84_to_utm

GRID_CSV = Path(__file__).resolve().parents[1] / "data" / "1898_location_golden.csv"
PIXEL_X = "Pixel_x_planted.jpg"
PIXEL_Y = "Pixel_y_planted.jpg"
# World (E, N, z) -> camera: optical axis +easting, image x = -north,
# image y = -up.
R_EAST = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])


def film_K(cfg: dict) -> np.ndarray:
    """The configuration's film camera (main_v1.py:869-883), float64:
    fx = f / sensor_w * W, fy = f / sensor_h * H."""
    w, h = cfg["image_size"]
    cam = cfg["camera"]
    return np.array([[cam["focal_length_mm"] / cam["sensor_width_mm"] * w, 0.0, cam["cx"]],
                     [0.0, cam["focal_length_mm"] / cam["sensor_height_mm"] * h, cam["cy"]],
                     [0.0, 0.0, 1.0]])


@dataclass(frozen=True)
class Grid:
    east: np.ndarray        # [C]
    north: np.ndarray       # [C]
    up: np.ndarray          # [C] with the observer height
    grid_codes: np.ndarray  # [C] int

    @property
    def utm(self) -> np.ndarray:
        return np.stack([self.east, self.north, self.up], 1)


def read_grid(n_candidates: int | None = None) -> Grid:
    """The candidate grid, its first ``n_candidates`` rows where given (the
    CPU tests' cut)."""
    with open(GRID_CSV, encoding="utf-8") as f:
        rows = list(csv.DictReader(f))[:n_candidates]
    col = lambda k: np.array([float(r[k]) for r in rows])  # noqa: E731
    return Grid(col("Z"), col("X"), col("Y"), col("grid_code").astype(np.int64))


@dataclass(frozen=True)
class Photo:
    """One planted photograph: its landmarks and annotations."""

    planted: int             # index of the true camera in the grid
    origin_utm: np.ndarray   # [3] the true camera (E, N, z)
    landmarks: np.ndarray    # [N, 3] UTM (E, N, z)
    pixels: np.ndarray       # [N, 2] annotated pixels
    outliers: np.ndarray     # indices of the shifted annotations


def planted_photo(grid: Grid, cfg: dict, rng: np.random.Generator,
                  planted: int) -> Photo:
    """``write_planted_scene``'s photograph: landmarks 1.5-4 km east of the
    planted camera, +-600 m north, -50..+250 m in z, projected through the
    film camera looking along +easting, with ``noise_px`` of noise and
    ``n_outliers`` annotations moved by ``outlier_shift_px``."""
    p = cfg["planted"]
    n = cfg["landmarks"]
    origin = grid.utm[planted]
    X = origin + np.stack([rng.uniform(*p["east_m"], n),
                           rng.uniform(*p["north_m"], n),
                           rng.uniform(*p["up_m"], n)], axis=1)
    K = film_K(cfg)
    Xc = (X - origin) @ R_EAST.T
    pix = np.stack([K[0, 0] * Xc[:, 0] / Xc[:, 2] + K[0, 2],
                    K[1, 1] * Xc[:, 1] / Xc[:, 2] + K[1, 2]], axis=1)
    pix += rng.normal(scale=p["noise_px"], size=pix.shape)
    outliers = np.sort(rng.choice(n, p["n_outliers"], replace=False))
    pix[outliers] += np.array(p["outlier_shift_px"])
    return Photo(planted=planted, origin_utm=origin, landmarks=X, pixels=pix,
                 outliers=outliers)


def write_scene_csvs(directory, grid: Grid, photo: Photo, observer_height_m: float):
    """The photograph's ``features.csv`` and the grid's ``cameras.csv`` in
    the reference's ``kuliang`` schema (WGS84 lon/lat), as users hand them
    to ``localize``.  Returns their paths."""
    os.makedirs(directory, exist_ok=True)
    features_csv = os.path.join(directory, "features.csv")
    X, pix = photo.landmarks, photo.pixels
    lon, lat = utm_to_wgs84(X[:, 0], X[:, 1])
    with open(features_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["FID", "Symbol", "Name", "Height", "Longitude", "Latitude",
                    "Elevation", PIXEL_X, PIXEL_Y])
        for i in range(len(X)):
            w.writerow([i + 1, f"L{i}", f"landmark {i}", 0.0, lon[i], lat[i],
                        X[i, 2], pix[i, 0], pix[i, 1]])
    cameras_csv = os.path.join(directory, "cameras.csv")
    lon, lat = utm_to_wgs84(grid.east, grid.north)
    with open(cameras_csv, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["FID", "grid_code", "Longitude", "Latitude", "Elevation"])
        for i in range(len(grid.east)):
            w.writerow([i + 1, int(grid.grid_codes[i]), lon[i], lat[i],
                        grid.up[i] - observer_height_m])
    return features_csv, cameras_csv


# ------------------------------------------------------------ terrain
@dataclass(frozen=True)
class Terrain:
    data: np.ndarray   # [H, W] float32, row 0 the north edge
    lon: np.ndarray    # [W] ascending
    lat: np.ndarray    # [H] descending


def planted_terrain(photo: Photo, t: dict, observer_height_m: float) -> Terrain:
    """``planted_dem`` on a square of ``extent_m`` centred on the camera at
    about ``spacing_m``: ground at the camera's feet within ``plateau_m``,
    falling by ``grade`` beyond; a flat-topped mesa of ``mesa_radius_m`` at
    each landmark's (E, N) and height; where the sight line from the camera
    to another landmark crosses a mesa lower than 5 m above its top, a
    notch of ``notch_m`` each side is cut."""
    o, L = photo.origin_utm, photo.landmarks
    half = 0.5 * t["extent_m"]
    lon_c, lat_c = utm_to_wgs84(np.array([o[0] - half, o[0] + half] * 2),
                                np.array([o[1] - half] * 2 + [o[1] + half] * 2))
    lat_mid = np.radians(lat_c.mean())
    dlon = t["spacing_m"] / (111320.0 * np.cos(lat_mid))
    dlat = t["spacing_m"] / 110574.0
    lon = np.arange(lon_c.min(), lon_c.max() + dlon, dlon)
    lat = np.arange(lat_c.max(), lat_c.min() - dlat, -dlat)
    LON, LAT = np.meshgrid(lon, lat)
    E, N = wgs84_to_utm(LON.ravel(), LAT.ravel())
    E, N = E.reshape(LON.shape), N.reshape(LON.shape)
    r = np.hypot(E - o[0], N - o[1])
    z = (o[2] - observer_height_m) - t["grade"] * np.maximum(r - t["plateau_m"], 0.0)
    de, dn = E - o[0], N - o[1]
    for j, (le, ln, lz) in enumerate(L):
        mesa = np.hypot(E - le, N - ln) <= t["mesa_radius_m"]
        for i, (ie, iN, iz) in enumerate(L):
            length = np.hypot(ie - o[0], iN - o[1])
            ue, un = (ie - o[0]) / length, (iN - o[1]) / length
            along = de * ue + dn * un
            ray_z = o[2] + (iz - o[2]) * along / length
            mesa &= ~((i != j) & (np.abs(de * un - dn * ue) <= t["notch_m"])
                      & (along > 0) & (along < length) & (ray_z <= lz + 5.0))
        z = np.where(mesa, np.maximum(z, lz), z)
    return Terrain(z.astype(np.float32), lon, lat)


def write_geotiff(path, terrain: Terrain) -> None:
    """A minimal uncompressed float32 GeoTIFF (one strip a row), tagged
    with ModelPixelScale and ModelTiepoint (the north-west corner)."""
    data, lon, lat = terrain.data, terrain.lon, terrain.lat
    h, w = data.shape
    scale = (float(lon[1] - lon[0]), float(lat[0] - lat[1]), 0.0)
    tie = (0.0, 0.0, 0.0, float(lon[0]), float(lat[0]), 0.0)
    strips = [np.ascontiguousarray(row).astype("<f4").tobytes() for row in data]
    body = bytearray(struct.pack("<2sHI", b"II", 42, 0))
    offsets = []
    for strip in strips:
        offsets.append(len(body))
        body += strip
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [32]), (259, 3, [1]),
               (262, 3, [1]), (273, 4, offsets), (277, 3, [1]), (278, 4, [1]),
               (279, 4, [len(sx) for sx in strips]), (339, 3, [3]),
               (33550, 12, list(scale)), (33922, 12, list(tie))]
    fmt = {3: "H", 4: "I", 12: "d"}
    packed = []
    for tag, typ, values in sorted(entries):
        raw = b"".join(struct.pack("<" + fmt[typ], v) for v in values)
        packed.append((tag, typ, len(values), raw))
    out_of_line = {}
    for tag, _, _, raw in packed:
        if len(raw) > 4:
            body += b"\0" * (len(body) % 2)
            out_of_line[tag] = len(body)
            body += raw
    body += b"\0" * (len(body) % 2)
    ifd = len(body)
    body += struct.pack("<H", len(packed))
    for tag, typ, count, raw in packed:
        body += struct.pack("<HHI", tag, typ, count)
        body += (struct.pack("<I", out_of_line[tag]) if len(raw) > 4
                 else raw.ljust(4, b"\0"))
    body += struct.pack("<I", 0)
    struct.pack_into("<I", body, 4, ifd)
    with open(path, "wb") as f:
        f.write(body)


def tiff_lonlat(terrain: Terrain):
    """The (lon, lat) axes as a reader rebuilds them from the GeoTIFF's
    tie point and pixel scale: what both sides' surfaces are defined on."""
    h, w = terrain.data.shape
    lon0, lat0 = float(terrain.lon[0]), float(terrain.lat[0])
    dlon = float(terrain.lon[1] - terrain.lon[0])
    dlat = -float(terrain.lat[0] - terrain.lat[1])
    return lon0 + np.arange(w) * dlon, lat0 + np.arange(h) * dlat
