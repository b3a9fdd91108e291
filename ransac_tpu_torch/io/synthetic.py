"""A planted localization scene in the reference's CSV schema.

The candidate grid is the real one of the 1898 photograph (458 cameras,
``tests/fixtures/1898_location_golden.csv``: ``Z`` = easting, ``X`` =
northing, ``Y`` = z including the +2 m observer height).  Landmarks are
made from a seed: ``n`` points 1.5-4 km east of the planted candidate,
+-600 m north and -50..+250 m in z, projected through the reference's film
camera (``CameraIntrinsicsConfig`` at 2142 x 1620 px) looking along
+easting, with 0.3 px noise and ``n_outliers`` points shifted by
(+260, -210) px.  Both files are written as the reference's ``kuliang``
CSVs (WGS84 lon/lat), so the scene goes through the real ingest path;
``n_unannotated`` more landmarks may follow with pixel (0, 0), as the
reference's table has rows that no one annotated.  With ``dist`` the
pixels go through OpenCV's (k1, k2, p1, p2, k3) lens model, and
``write_planted_calibration`` writes the matching calibration file for
``localize --calibration``.

For calibration, ``render_checkerboard`` renders a board seen through a
homography (on any torch device) and ``write_boards`` writes a seeded set
of board views as .npy (and .png where PIL imports).

For ``localize --dem`` the scene gets terrain of its own: ``planted_dem``
(mesas at the landmarks' heights on ground that falls away from the
camera), written by ``write_geotiff`` as a float32 GeoTIFF, and an ISAT
boundary JSON (``write_boundary_json``); ``write_planted_dem`` writes both.

For ``cli sfm``, ``write_sfm_tracks`` writes the JAX package's planted SfM
scene (``sfm_tracks``) as a track table and K; ``se3_loop_graph`` and
``sim3_drift_graph`` build the JAX loop-closure tests' drifted circuits as
pose graphs.
"""

from __future__ import annotations

import csv
import json
import os
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ransac_tpu_torch.ops.geodesy import utm_to_wgs84, wgs84_to_utm
from ransac_tpu_torch.ops.homography import apply_h
from ransac_tpu_torch.ops.projection import distort, intrinsics_from_physical, project_points
from ransac_tpu_torch.ops.rotation import exp_so3
from ransac_tpu_torch.utils.config import CameraIntrinsicsConfig

GRID_CSV = (Path(__file__).resolve().parents[2]
            / "tests" / "fixtures" / "1898_location_golden.csv")
IMAGE_SIZE = (2142, 1620)
PIXEL_X = "Pixel_x_planted.jpg"
PIXEL_Y = "Pixel_y_planted.jpg"
OBSERVER_HEIGHT_M = 2.0
#: A lens for ``write_planted_scene(dist=...)``: (k1, k2, p1, p2, k3), which
#: moves the planted pixels by up to ~6 px.
LENS_DIST = (-0.06, 0.02, 1e-3, -5e-4, 0.0)
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
    landmarks_utm: np.ndarray = None  # [n + n_unannotated, 3] (E, N, z)
    dist: np.ndarray = None   # [5] the lens distortion of the pixels, if any


def write_planted_scene(directory, seed: int = 0, planted: int = 200,
                        n: int = 13, n_outliers: int = 2,
                        n_unannotated: int = 0, dist=None) -> PlantedScene:
    """Write ``features.csv`` and ``cameras.csv`` into ``directory``.
    ``n_unannotated`` landmarks (drawn from a stream of their own, so the
    first ``n`` rows do not move) follow with pixel (0, 0).  ``dist`` [5]
    distorts the landmarks' pixels before the noise."""
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
    if dist is None:
        pix = np.stack([fx * Xc[:, 0] / Xc[:, 2] + ic.cx,
                        fy * Xc[:, 1] / Xc[:, 2] + ic.cy], axis=1)
    else:
        dist = np.asarray(dist, np.float64)
        xd, yd = (v.numpy() for v in distort(torch.from_numpy(Xc[:, 0] / Xc[:, 2]),
                                             torch.from_numpy(Xc[:, 1] / Xc[:, 2]),
                                             torch.from_numpy(dist)))
        pix = np.stack([fx * xd + ic.cx, fy * yd + ic.cy], axis=1)
    pix += rng.normal(scale=0.3, size=pix.shape)
    outliers = np.sort(rng.choice(n, n_outliers, replace=False))
    pix[outliers] += np.array([260.0, -210.0])
    if n_unannotated:
        rng_u = np.random.default_rng([seed, 1])
        X = np.concatenate([X, origin + np.stack(
            [rng_u.uniform(1500.0, 4000.0, n_unannotated),
             rng_u.uniform(-600.0, 600.0, n_unannotated),
             rng_u.uniform(-50.0, 250.0, n_unannotated)], axis=1)])
        pix = np.concatenate([pix, np.zeros((n_unannotated, 2))])

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
        for i in range(n, n + n_unannotated):
            w.writerow([i + 1, f"U{i - n}", f"unannotated {i - n}", 0.0, lon[i],
                        lat[i], X[i, 2], 0.0, 0.0])
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
                        origin_utm=origin, outliers=outliers, landmarks_utm=X,
                        dist=dist)


def film_K(image_size=IMAGE_SIZE) -> np.ndarray:
    """The planted scenes' camera: the reference's film intrinsics
    (``CameraIntrinsicsConfig``) at ``image_size``, float64."""
    ic = CameraIntrinsicsConfig()
    width, height = image_size
    return np.array([[ic.focal_length_mm / ic.sensor_width_mm * width, 0.0, ic.cx],
                     [0.0, ic.focal_length_mm / ic.sensor_height_mm * height, ic.cy],
                     [0.0, 0.0, 1.0]])


def write_planted_calibration(path, ps: PlantedScene) -> str:
    """The calibration file of a distorted planted scene, with the keys and
    dtypes that ``cli calibrate`` writes (K and dist float64, rms, the
    image's height and width, the views used: none here)."""
    width, height = ps.image_size
    np.savez(path, K=film_K(ps.image_size), dist=np.asarray(ps.dist, np.float64),
             rms=0.0, height=height, width=width, views=np.array([], dtype=str))
    return path


# ------------------------------------------------------------ terrain
MESA_RADIUS_M = 30.0   # flat tops at each landmark's height
NOTCH_M = 15.0         # half-width of a notch cut for another landmark's ray
PLATEAU_M = 30.0       # flat ground around the camera
GRADE = 0.2            # the ground's fall beyond the plateau, m per m


def planted_dem(ps: PlantedScene, spacing_m: float = 10.0):
    """Terrain for a planted scene on a regular lon/lat grid of about
    ``spacing_m``: ground at the camera's feet (its z less the observer
    height) within PLATEAU_M, falling by GRADE beyond, so every landmark
    ray passes above it; a flat-topped mesa of MESA_RADIUS_M at each
    landmark's (E, N) and height, so its ray ends at or beside it.  Where
    the sight line from the camera to another landmark crosses a mesa
    lower than 5 m above its top, a notch of NOTCH_M each side is cut, so
    no mesa hides another landmark.
    Returns (data [H, W] float32, lon [W] ascending, lat [H] descending):
    row 0 is the north edge, as a GeoTIFF stores it."""
    o = ps.origin_utm
    L = ps.landmarks_utm
    e0, e1 = min(o[0], L[:, 0].min()) - 300.0, max(o[0], L[:, 0].max()) + 300.0
    n0, n1 = min(o[1], L[:, 1].min()) - 300.0, max(o[1], L[:, 1].max()) + 300.0
    lon_c, lat_c = utm_to_wgs84(np.array([e0, e1, e0, e1]),
                                np.array([n0, n0, n1, n1]))
    lat_mid = np.radians(lat_c.mean())
    dlon = spacing_m / (111320.0 * np.cos(lat_mid))
    dlat = spacing_m / 110574.0
    lon = np.arange(lon_c.min(), lon_c.max() + dlon, dlon)
    lat = np.arange(lat_c.max(), lat_c.min() - dlat, -dlat)
    LON, LAT = np.meshgrid(lon, lat)
    E, N = wgs84_to_utm(LON.ravel(), LAT.ravel())
    E, N = E.reshape(LON.shape), N.reshape(LON.shape)
    r = np.hypot(E - o[0], N - o[1])
    z = (o[2] - OBSERVER_HEIGHT_M) - GRADE * np.maximum(r - PLATEAU_M, 0.0)
    de, dn = E - o[0], N - o[1]
    for j, (le, ln, lz) in enumerate(L):
        mesa = np.hypot(E - le, N - ln) <= MESA_RADIUS_M
        for i, (ie, iN, iz) in enumerate(L):
            length = np.hypot(ie - o[0], iN - o[1])
            ue, un = (ie - o[0]) / length, (iN - o[1]) / length
            along = de * ue + dn * un
            ray_z = o[2] + (iz - o[2]) * along / length
            mesa &= ~((i != j) & (np.abs(de * un - dn * ue) <= NOTCH_M)
                      & (along > 0) & (along < length) & (ray_z <= lz + 5.0))
        z = np.where(mesa, np.maximum(z, lz), z)
    return z.astype(np.float32), lon, lat


def write_geotiff(path, data, lon, lat, nodata=None) -> None:
    """A minimal uncompressed float32 GeoTIFF (one strip a row): ``data``
    [H, W] at (lon[j], lat[i]) on a regular grid, tagged with
    ModelPixelScale and ModelTiepoint (the north-west corner) and, where
    given, GDAL_NODATA.  Rows are written north first."""
    data = np.asarray(data, np.float32)
    lon, lat = np.asarray(lon, np.float64), np.asarray(lat, np.float64)
    if lat[0] < lat[-1]:
        data, lat = data[::-1], lat[::-1]
    if lon[0] > lon[-1]:
        data, lon = data[:, ::-1], lon[::-1]
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
    if nodata is not None:
        entries.append((42113, 2, str(nodata).encode() + b"\0"))
    fmt = {3: "H", 4: "I", 12: "d"}
    packed = []
    for tag, typ, values in sorted(entries):
        raw = bytes(values) if typ == 2 else b"".join(
            struct.pack("<" + fmt[typ], v) for v in values)
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


def boundary_polygon(image_size=IMAGE_SIZE, n_vertices: int = 21) -> np.ndarray:
    """[n_vertices, 2] pixels of an ellipse below the horizon of the planted
    camera (whose optical axis is level, so the horizon is near row cy)."""
    width, height = image_size
    a = np.linspace(0.0, 2.0 * np.pi, n_vertices, endpoint=False)
    return np.round(np.stack([0.5 * width + 0.2 * width * np.cos(a),
                              0.62 * height + 0.085 * height * np.sin(a)], 1), 1)


def write_boundary_json(path, image_size=IMAGE_SIZE, name: str = "planted.jpg"):
    """An ISAT segmentation JSON as the reference's ``1898.json`` holds it:
    image info and one ``__background__`` object, a 21-vertex polygon."""
    poly = boundary_polygon(image_size)
    width, height = image_size
    doc = {"info": {"description": "ISAT", "folder": "", "name": name,
                    "width": width, "height": height, "depth": 3, "note": ""},
           "objects": [{"category": "__background__", "group": 1,
                        "segmentation": poly.tolist(), "area": 0.0, "layer": 1.0,
                        "bbox": [float(poly[:, 0].min()), float(poly[:, 1].min()),
                                 float(poly[:, 0].max()), float(poly[:, 1].max())],
                        "iscrowd": False, "note": ""}]}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)


def write_planted_dem(directory, ps: PlantedScene, spacing_m: float = 10.0):
    """Write ``dem.tif`` (``planted_dem``) and ``boundary.json`` into
    ``directory``; returns their paths."""
    os.makedirs(directory, exist_ok=True)
    tif = os.path.join(directory, "dem.tif")
    write_geotiff(tif, *planted_dem(ps, spacing_m))
    js = os.path.join(directory, "boundary.json")
    write_boundary_json(js, ps.image_size)
    return tif, js


# ------------------------------------------------------------ boards
BOARD_SHAPE = (480, 640)   # (H, W) of ``write_boards``' default views


def board_K(shape=BOARD_SHAPE) -> np.ndarray:
    """The board views' camera: fx 500, fy 510, cx 320, cy 240 at 640 x 480
    (the JAX package's rendered-board tests), scaled with the width."""
    s = shape[1] / 640.0
    return np.array([[500.0 * s, 0.0, 320.0 * s], [0.0, 510.0 * s, 240.0 * s],
                     [0.0, 0.0, 1.0]])


def render_checkerboard(H, cols: int = 9, rows: int = 6, shape=BOARD_SHAPE,
                        supersample: int = 3, device="cuda"):
    """A checkerboard of ``cols`` x ``rows`` squares seen through the
    homography H (board units of squares -> pixels), on ``device``: dark
    squares 0.05, paper 0.95, area-averaged over supersample^2 samples a
    pixel.  The border corners are L-junctions, so only the (cols - 1) x
    (rows - 1) inner corners are saddles.  Returns (image [H, W] float32,
    the inner corners' pixels [(rows - 1) (cols - 1), 2] row-major,
    float64 numpy)."""
    Hh, Ww = shape
    ss = supersample
    Hm = torch.as_tensor(np.asarray(H, np.float64), device=device)
    yy, xx = torch.meshgrid(
        torch.arange(Hh * ss, dtype=torch.float64, device=device) / ss,
        torch.arange(Ww * ss, dtype=torch.float64, device=device) / ss, indexing="ij")
    board = apply_h(torch.linalg.inv(Hm), torch.stack([xx.reshape(-1), yy.reshape(-1)], -1))
    bx, by = board[:, 0], board[:, 1]
    on_board = (bx >= 0) & (bx < cols) & (by >= 0) & (by < rows)
    black = (torch.floor(bx) + torch.floor(by)) % 2 == 0
    img = torch.where(on_board & black, 0.05, 0.95).reshape(Hh, ss, Ww, ss).mean((1, 3))
    grid = np.stack(np.meshgrid(np.arange(1, cols - 0.5), np.arange(1, rows - 0.5)),
                    -1).reshape(-1, 2)
    corners = apply_h(Hm.cpu(), torch.as_tensor(grid)).numpy()
    return img.to(torch.float32), corners


def board_homographies(n_views: int, K, seed: int = 0, cols: int = 9, rows: int = 6):
    """``n_views`` seeded board poses as homographies K [r1 r2 t] (board
    units of squares), each with the whole board in front of the camera:
    rotations of about 0.25 rad, the board ~12 squares away."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n_views:
        R = _rotation(rng.normal(size=3) * np.array([0.25, 0.25, 0.2]))
        t = np.array([-4.0, -3.0, 12.0]) + rng.normal(size=3) * 0.8
        Hm = np.asarray(K) @ np.stack([R[:, 0], R[:, 1], t], axis=1)
        if abs(Hm[2, 2]) > 1e-9:
            out.append(Hm / Hm[2, 2])
    return out


def write_boards(directory, n_views: int = 5, cols: int = 8, rows: int = 5,
                 seed: int = 0, shape=BOARD_SHAPE, formats=("npy",), device="cuda"):
    """Render ``n_views`` views of a board of ``cols`` x ``rows`` INNER
    corners (``board_homographies``, ``render_checkerboard`` on ``device``)
    and write each as ``board{i}.npy`` (float32 in [0, 1]) and, with "png"
    in ``formats``, ``board{i}.png`` (8-bit, through PIL).  Returns (paths,
    the true K, the true inner corners [n_views, rows * cols, 2])."""
    os.makedirs(directory, exist_ok=True)
    K = board_K(shape)
    paths, corners = [], []
    for i, Hm in enumerate(board_homographies(n_views, K, seed, cols + 1, rows + 1)):
        img, c = render_checkerboard(Hm, cols + 1, rows + 1, shape, device=device)
        img = img.cpu().numpy()
        corners.append(c)
        if "npy" in formats:
            paths.append(os.path.join(directory, f"board{i}.npy"))
            np.save(paths[-1], img)
        if "png" in formats:
            from PIL import Image

            paths.append(os.path.join(directory, f"board{i}.png"))
            Image.fromarray(np.clip(img * 255.0, 0, 255).astype(np.uint8)).save(paths[-1])
    return paths, K, np.stack(corners)


def planted_focal_case(seed: int = 0):
    """The JAX package's planted intrinsics-search case: 14 points in
    front of a camera of f = 180 mm on 127 x 178 mm film at 800 x 600,
    with 0.3 px of noise.  Returns (X [14, 3], pixels [14, 2], the camera's
    origin [3], (W, H), f_mm, sensor_mm), float64."""
    W, H, f_mm, sensor = 800, 600, 180.0, (127, 178)
    rng = np.random.default_rng(seed)
    K = intrinsics_from_physical(f_mm, *sensor, W, H, W / 2, H / 2, dtype=torch.float64)
    R = exp_so3(torch.tensor([0.1, -0.2, 0.05], dtype=torch.float64))
    t = torch.tensor([0.5, -0.3, 30.0], dtype=torch.float64)
    X = rng.uniform(-15, 15, size=(14, 3)) + [0, 0, 10]
    pix = project_points(torch.from_numpy(X), R, t, K)[0].numpy()
    pix = pix + rng.normal(scale=0.3, size=(14, 2))
    return X, pix, -R.numpy().T @ t.numpy(), (W, H), f_mm, sensor


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


# ------------------------------------------------------------ SfM tracks
class SfmTracks(NamedTuple):
    tracks_npz: str        # frame [M], track [M], uv [M, 2]: `cli sfm --tracks`
    intrinsics_txt: str    # 3 x 3 K as text: `cli sfm --intrinsics`
    poses: np.ndarray      # [F, 6] true (rvec, tvec), world -> camera
    points: np.ndarray     # [n_pts, 3] true points


def sfm_tracks(n_frames: int = 6, n_pts: int = 80, seed: int = 2, noise: float = 0.3):
    """The planted scene of the JAX package's SfM test (``synth_tracks`` of
    ``tests/test_sfm_twoview.py``): ``n_pts`` points in an 8 x 6 x 3 box 10
    units ahead, frames 0.7 apart along x with small seeded rotations and
    jitter, every point in front of a camera observed (there is no image
    bound) with ``noise`` px.  The projection is float64 here (float32 in
    the JAX test).  Returns (tracks {(frame, track): uv}, K, poses [F, 6],
    X [n_pts, 3])."""
    rng = np.random.default_rng(seed)
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]])
    X = rng.uniform(-1, 1, size=(n_pts, 3)) * np.array([4, 3, 1.5]) + [0, 0, 10]
    poses, tracks = [], {}
    for f in range(n_frames):
        rvec = rng.normal(size=3) * 0.03
        t = np.array([f * 0.7 - 2.0, rng.normal() * 0.05, rng.normal() * 0.05])
        poses.append(np.concatenate([rvec, t]))
        Xc = X @ _rotation(rvec).T + t
        pix = Xc[:, :2] / Xc[:, 2:] @ K[:2, :2].T + K[:2, 2]
        pix = pix + rng.normal(scale=noise, size=(n_pts, 2))
        for i in np.where(Xc[:, 2] > 0)[0]:
            tracks[(f, int(i))] = pix[i]
    return tracks, K, np.array(poses), X


def write_sfm_tracks(directory, n_frames: int = 6, n_pts: int = 80, seed: int = 2,
                     noise: float = 0.3) -> SfmTracks:
    """``sfm_tracks`` written as the inputs of ``cli sfm``: ``tracks.npz``
    (frame, track, uv) and ``K.txt``."""
    os.makedirs(directory, exist_ok=True)
    tracks, K, poses, X = sfm_tracks(n_frames, n_pts, seed, noise)
    keys = sorted(tracks)
    npz = os.path.join(directory, "tracks.npz")
    np.savez(npz, frame=np.array([f for f, _ in keys], np.int64),
             track=np.array([t for _, t in keys], np.int64),
             uv=np.stack([tracks[k] for k in keys]))
    k_txt = os.path.join(directory, "K.txt")
    np.savetxt(k_txt, K)
    return SfmTracks(npz, k_txt, poses, X)


# ------------------------------------------------------------ pose graphs
def circle_poses(V: int = 32, radius: float = 1.0) -> np.ndarray:
    """World -> camera poses [V, 6] on a closed circuit (identity rotation,
    centers on a circle), the JAX loop-closure tests' ground truth."""
    th = 2 * np.pi * np.arange(V) / V
    centers = np.stack([radius * np.cos(th), radius * np.sin(th), np.zeros(V)], 1)
    return np.concatenate([np.zeros((V, 3)), -centers], 1)


def _graph_arrays(ei, ej, ez, ew):
    return (np.array(ei, np.int32), np.array(ej, np.int32),
            np.stack(ez).astype(np.float32), np.array(ew, np.float32))


def se3_loop_graph(V: int = 32, drift: float = 0.004, n_loop: int = 3, seed: int = 0):
    """The JAX loop-closure test's SE(3) graph: odometry integrated with a
    seeded translation bias (``drift`` a step), odometry edges from the
    drifted chain, up to 3 loop closures measured from the truth (weight
    2).  Returns (PoseGraph of float32 / int32 arrays, truth, drifted)."""
    from ransac_tpu_torch.ba.posegraph import PoseGraph, compose, relative

    def f(a):
        return torch.tensor(a, dtype=torch.float64)

    gt = circle_poses(V)
    rng = np.random.default_rng(seed)
    drifted = [gt[0].copy()]
    for k in range(1, V):
        z = relative(f(gt[k - 1]), f(gt[k])).numpy().copy()
        z[3:] += drift * (1.0 + 0.3 * rng.standard_normal(3))
        drifted.append(compose(f(z), f(drifted[-1])).numpy())
    drifted = np.stack(drifted)
    ei, ej, ez, ew = [], [], [], []
    for k in range(V - 1):
        ei.append(k), ej.append(k + 1), ew.append(1.0)
        ez.append(relative(f(drifted[k]), f(drifted[k + 1])).numpy())
    for a, b in [(0, V - 1), (1, V - 2), (2, V // 2)][:n_loop]:
        ei.append(a), ej.append(b), ew.append(2.0)
        ez.append(relative(f(gt[a]), f(gt[b])).numpy())
    return PoseGraph(drifted.astype(np.float32), *_graph_arrays(ei, ej, ez, ew)), gt, drifted


def sim3_drift_graph(V: int = 24, n_loop: int = 3, rate: float = 1.03):
    """The JAX loop-closure test's Sim(3) graph: a circuit whose odometry
    translation grows by ``rate`` a step (monocular scale drift), odometry
    edges from the drifted chain at scale 1 (``edge_sw`` 0), up to 3 loop
    closures carrying the relative scale the chain implies at their ends
    (``edge_sw`` 1, weight 2).  Returns (PoseGraphSim3 of float32 / int32
    arrays, truth [V, 6], drifted [V, 6])."""
    from ransac_tpu_torch.ba.posegraph import (PoseGraphSim3, compose, relative,
                                               relative_sim3)

    def f(a):
        return torch.tensor(a, dtype=torch.float64)

    gt = circle_poses(V)
    drifted = [gt[0].copy()]
    for k in range(1, V):
        z = relative(f(gt[k - 1]), f(gt[k])).numpy().copy()
        z[3:] *= rate ** k
        drifted.append(compose(f(z), f(drifted[-1])).numpy())
    drifted = np.stack(drifted)
    p7 = np.concatenate([drifted, np.zeros((V, 1))], 1)
    gt7 = np.concatenate([gt, np.zeros((V, 1))], 1)
    ei, ej, ez, ew = [], [], [], []
    for k in range(V - 1):
        ei.append(k), ej.append(k + 1), ew.append(1.0)
        ez.append(relative_sim3(f(p7[k]), f(p7[k + 1])).numpy())
    loops = [(0, V - 1), (1, V - 2), (2, V // 2)][:n_loop]
    for a, b in loops:
        z = relative_sim3(f(gt7[a]), f(gt7[b])).numpy().copy()
        s_a, s_b = rate ** a, rate ** b
        z[3:6] *= s_b
        z[6] = np.log(s_b / s_a)
        ei.append(a), ej.append(b), ew.append(2.0)
        ez.append(z)
    sw = np.array([0.0] * (V - 1) + [1.0] * len(loops), np.float32)
    return (PoseGraphSim3(p7.astype(np.float32), *_graph_arrays(ei, ej, ez, ew), sw),
            gt, drifted)


def centered_ate(est, gt) -> float:
    """RMS camera-center error of world -> camera poses [V, 6] with
    identity rotations, the means removed (the JAX loop-closure tests'
    ``_ate``)."""
    ce = -np.asarray(est)[:, 3:6]
    cg = -np.asarray(gt)[:, 3:6]
    ce = ce - ce.mean(0)
    cg = cg - cg.mean(0)
    return float(np.sqrt(((ce - cg) ** 2).sum(1).mean()))
