"""Host-side CSV ingest: feature landmarks and candidate camera grids.

Port of ``ransac_tpu.io.tables`` for the ``kuliang`` schema through the
Python CSV path (main_v1.py:689-762): header-addressed ``Pixel_x_<image>``
columns, WGS84 lon/lat -> UTM, rows whose pixel is (0,0) skipped, empty
numeric cells read as 0.0.  Absolute UTM stays float64 on the host; the
``Scene`` holds scene-centred float32 tensors on one device.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass

import numpy as np
import torch

from ransac_tpu_torch.ops.geodesy import GeoTransformer, SceneFrame


def _f(cell: str) -> float:
    cell = (cell or "").strip()
    if not cell:
        return 0.0
    return float(cell)


@dataclass
class FeatureTable:
    symbols: list[str]
    names: list[str]
    pixels: np.ndarray        # [N,2] f64 (annotated pixel, already /scale)
    pos3d_utm: np.ndarray     # [N,3] f64 (easting, northing, z)
    lonlat: np.ndarray        # [N,2] f64 (lon, lat)
    heights: np.ndarray       # [N] f64 raw Height column
    elevations: np.ndarray    # [N] f64 raw Elevation column

    def __len__(self) -> int:
        return len(self.symbols)

    @property
    def point_mask(self) -> np.ndarray:
        """Annotated-pixel mask (main_v1.py:307): pixel != (0,0)."""
        return (np.abs(self.pixels) > 0).any(axis=1)


@dataclass
class CameraTable:
    grid_codes: np.ndarray    # [C] int
    pos3d_utm: np.ndarray     # [C,3] f64 (easting, northing, z+observer)
    lonlat: np.ndarray        # [C,2] f64

    def __len__(self) -> int:
        return len(self.grid_codes)


def read_points_data(
    filename: str,
    pixel_x: str,
    pixel_y: str,
    scale: float = 1.0,
    z_mode: str = "elevation",
    zone: int = 50,
    keep_unannotated: bool = False,
) -> FeatureTable:
    """Parse the features CSV (columns: id, symbol, name, Height, lon, lat,
    Elevation, ..., ``pixel_x``, ``pixel_y``).  ``z_mode``: 'elevation'
    (main_v1.py:718) or 'height_plus_elevation' (test_pro.py:725)."""
    tr = GeoTransformer(zone=zone)
    symbols, names = [], []
    pixels, pos3d, lonlat, heights, elevations = [], [], [], [], []
    with open(filename, encoding="utf-8-sig") as f:
        rows = list(csv.reader(f))
    ix = rows[0].index(pixel_x)
    iy = rows[0].index(pixel_y)
    for row in rows[1:]:
        if not row or not row[0].strip():
            continue
        pix = np.array([_f(row[ix]), _f(row[iy])]) / scale
        if not keep_unannotated and pix[0] == 0 and pix[1] == 0:
            continue
        lon, lat = _f(row[4]), _f(row[5])
        elev = _f(row[6])
        hgt = _f(row[3])
        easting, northing = tr.wgs84_to_utm(lon, lat)
        z = elev if z_mode == "elevation" else hgt + elev
        symbols.append(row[1])
        names.append(row[2])
        pixels.append(pix)
        pos3d.append(np.array([easting, northing, z]))
        lonlat.append(np.array([lon, lat]))
        heights.append(hgt)
        elevations.append(elev)
    return FeatureTable(
        symbols=symbols, names=names,
        pixels=np.array(pixels, dtype=np.float64).reshape(-1, 2),
        pos3d_utm=np.array(pos3d, dtype=np.float64).reshape(-1, 3),
        lonlat=np.array(lonlat, dtype=np.float64).reshape(-1, 2),
        heights=np.array(heights, dtype=np.float64),
        elevations=np.array(elevations, dtype=np.float64),
    )


def read_camera_locations(
    filename: str,
    observer_height: float = 2.0,
    zone: int = 50,
) -> CameraTable:
    """Parse the candidate-camera CSV (main_v1.py:734-762): grid_code col 1,
    lon col 2, lat col 3, elevation col 4, +observer_height meters."""
    tr = GeoTransformer(zone=zone)
    grid_codes, pos3d, lonlat = [], [], []
    with open(filename, encoding="utf-8-sig") as f:
        rows = list(csv.reader(f))
    for row in rows[1:]:
        if not row or not row[0].strip():
            continue
        lon, lat = _f(row[2]), _f(row[3])
        easting, northing = tr.wgs84_to_utm(lon, lat)
        grid_codes.append(int(_f(row[1])))
        pos3d.append(np.array([easting, northing, _f(row[4]) + observer_height]))
        lonlat.append(np.array([lon, lat]))
    return CameraTable(
        grid_codes=np.array(grid_codes, dtype=np.int32),
        pos3d_utm=np.array(pos3d, dtype=np.float64).reshape(-1, 3),
        lonlat=np.array(lonlat, dtype=np.float64).reshape(-1, 2),
    )


@dataclass
class Scene:
    """Device view of one localization problem: scene-centred float32
    tensors on one device, with the float64 host tables and frame."""

    features: FeatureTable
    cameras: CameraTable
    frame: SceneFrame
    pixels: torch.Tensor      # [N,2] f32
    pos3d: torch.Tensor       # [N,3] f32 centred
    point_mask: torch.Tensor  # [N] f32
    cam_locs: torch.Tensor    # [C,3] f32 centred
    grid_codes: torch.Tensor  # [C] i32

    @property
    def device(self) -> torch.device:
        return self.pixels.device

    def to(self, device) -> "Scene":
        return Scene(
            features=self.features, cameras=self.cameras, frame=self.frame,
            pixels=self.pixels.to(device), pos3d=self.pos3d.to(device),
            point_mask=self.point_mask.to(device),
            cam_locs=self.cam_locs.to(device),
            grid_codes=self.grid_codes.to(device))


def build_scene(features: FeatureTable, cameras: CameraTable,
                zone: int = 50, device="cuda") -> Scene:
    anchor_src = np.concatenate([features.pos3d_utm, cameras.pos3d_utm], 0)
    frame = SceneFrame.from_points(anchor_src, zone=zone)
    return _scene(features, cameras, frame,
                  pixels=features.pixels.astype(np.float32),
                  pos3d=frame.center(features.pos3d_utm),
                  point_mask=features.point_mask.astype(np.float32),
                  cam_locs=frame.center(cameras.pos3d_utm),
                  grid_codes=cameras.grid_codes, device=device)


def scene_from_numpy(scene, device="cuda") -> Scene:
    """The state carried across: take the numpy fields of a JAX
    ``ransac_tpu.io.tables.Scene`` (read by attribute, so JAX is never
    imported here) and return the port's ``Scene`` on ``device``."""
    feats, cams, fr = scene.features, scene.cameras, scene.frame
    features = FeatureTable(
        symbols=list(feats.symbols), names=list(feats.names),
        pixels=np.asarray(feats.pixels), pos3d_utm=np.asarray(feats.pos3d_utm),
        lonlat=np.asarray(feats.lonlat), heights=np.asarray(feats.heights),
        elevations=np.asarray(feats.elevations))
    cameras = CameraTable(
        grid_codes=np.asarray(cams.grid_codes),
        pos3d_utm=np.asarray(cams.pos3d_utm), lonlat=np.asarray(cams.lonlat))
    frame = SceneFrame(anchor=np.asarray(fr.anchor, np.float64),
                       zone=fr.zone, northern=fr.northern)
    return _scene(features, cameras, frame, pixels=scene.pixels,
                  pos3d=scene.pos3d, point_mask=scene.point_mask,
                  cam_locs=scene.cam_locs, grid_codes=scene.grid_codes,
                  device=device)


def _scene(features, cameras, frame, *, pixels, pos3d, point_mask, cam_locs,
           grid_codes, device) -> Scene:
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Scene(
        features=features, cameras=cameras, frame=frame,
        pixels=f32(pixels), pos3d=f32(pos3d), point_mask=f32(point_mask),
        cam_locs=f32(cam_locs),
        grid_codes=torch.as_tensor(np.asarray(grid_codes, np.int32),
                                   device=device))
