"""Host-side CSV ingest: feature landmarks and candidate camera grids
(port of ``ransac_tpu.io.tables``).

Two schemas:

- ``kuliang`` (main_v1.py:689-762): header-addressed ``Pixel_x_<image>``
  columns, WGS84 lon/lat -> UTM, rows whose pixel is (0,0) skipped, empty
  numeric cells read as 0.0;
- ``planar`` (process.py:297-348): symbol at column 6, coordinates already
  planar (no geodesy), z = column 5 + column 2; cameras' grid code at
  column 2, position [x, y, z] from columns 3, 4 and 5 + the observer
  height.

The ``kuliang`` schema reads through the native parser
(``io.native``, compiled at first use) where it can: ``use_native``
"auto" takes it when it builds and the Python ``csv`` path otherwise,
"always" raises without it, "never" takes the Python path.  Absolute UTM
stays float64 on the host; the ``Scene`` holds scene-centred float32
tensors on one device.
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


def _native_ok(use_native: str) -> bool:
    """Whether to read through ``io.native``: "never" no, "auto" where it
    builds, "always" yes or raise."""
    if use_native not in ("auto", "always", "never"):
        raise ValueError(f"use_native={use_native!r}: 'auto', 'always' or 'never'")
    if use_native == "never":
        return False
    from ransac_tpu_torch.io import native

    ok = native.available()
    if use_native == "always" and not ok:
        raise RuntimeError(f"use_native='always' but the native reader cannot be built: "
                           f"{native.error()}")
    return ok


def read_points_data(
    filename: str,
    pixel_x: str,
    pixel_y: str,
    scale: float = 1.0,
    z_mode: str = "elevation",
    schema: str = "kuliang",
    zone: int = 50,
    keep_unannotated: bool = False,
    use_native: str = "auto",
) -> FeatureTable:
    """Parse the features CSV (``kuliang`` columns: id, symbol, name,
    Height, lon, lat, Elevation, ..., ``pixel_x``, ``pixel_y``; ``planar``:
    id, name, Height, x, y, Elevation, symbol, ...).  ``z_mode``:
    'elevation' (main_v1.py:718) or 'height_plus_elevation'
    (test_pro.py:725), ``kuliang`` only.  ``keep_unannotated=True`` keeps
    the (0,0)-pixel rows."""
    tr = GeoTransformer(zone=zone)
    symbols, names = [], []
    pixels, pos3d, lonlat, heights, elevations = [], [], [], [], []
    with open(filename, encoding="utf-8-sig") as f:
        header = next(csv.reader(f))
    ix = header.index(pixel_x)
    iy = header.index(pixel_y)
    if schema == "kuliang" and _native_ok(use_native):
        from ransac_tpu_torch.io import native

        num = native.read_numeric(filename, [3, 4, 5, 6, ix, iy])
        syms = native.read_strings(filename, 1)
        nams = native.read_strings(filename, 2)
        for i in range(num.shape[0]):
            hgt, lon, lat, elev, px, py = num[i]
            pix = np.array([px, py]) / scale
            if not keep_unannotated and pix[0] == 0 and pix[1] == 0:
                continue
            easting, northing = tr.wgs84_to_utm(lon, lat)
            symbols.append(syms[i])
            names.append(nams[i])
            pixels.append(pix)
            pos3d.append(np.array([easting, northing,
                                   elev if z_mode == "elevation" else hgt + elev]))
            lonlat.append(np.array([lon, lat]))
            heights.append(hgt)
            elevations.append(elev)
        return _feature_table(symbols, names, pixels, pos3d, lonlat, heights, elevations)
    with open(filename, encoding="utf-8-sig") as f:
        rows = list(csv.reader(f))
    for row in rows[1:]:
        if not row or not row[0].strip():
            continue
        pix = np.array([_f(row[ix]), _f(row[iy])]) / scale
        if schema == "planar":
            sym, name = row[6], row[1]
            hgt, elev = _f(row[2]), _f(row[5])
            p3 = np.array([_f(row[3]), _f(row[4]), elev + hgt])
            ll = np.zeros(2)
        else:
            sym, name = row[1], row[2]
            lon, lat = _f(row[4]), _f(row[5])
            elev = _f(row[6])
            hgt = _f(row[3])
            easting, northing = tr.wgs84_to_utm(lon, lat)
            p3 = np.array([easting, northing, elev if z_mode == "elevation" else hgt + elev])
            ll = np.array([lon, lat])
        if not keep_unannotated and pix[0] == 0 and pix[1] == 0:
            continue
        symbols.append(sym)
        names.append(name)
        pixels.append(pix)
        pos3d.append(p3)
        lonlat.append(ll)
        heights.append(hgt)
        elevations.append(elev)
    return _feature_table(symbols, names, pixels, pos3d, lonlat, heights, elevations)


def _feature_table(symbols, names, pixels, pos3d, lonlat, heights, elevations):
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
    schema: str = "kuliang",
    zone: int = 50,
    use_native: str = "auto",
) -> CameraTable:
    """Parse the candidate-camera CSV (``kuliang``, main_v1.py:734-762:
    grid_code col 1, lon col 2, lat col 3, elevation col 4; ``planar``,
    process.py:341-343: grid code col 2, x col 3, y col 4, elevation col
    5), + ``observer_height`` meters."""
    tr = GeoTransformer(zone=zone)
    if schema == "kuliang" and _native_ok(use_native):
        from ransac_tpu_torch.io import native

        num = native.read_numeric(filename, [1, 2, 3, 4])
        easting, northing = tr.wgs84_to_utm(num[:, 1], num[:, 2])
        return CameraTable(
            grid_codes=num[:, 0].astype(np.int32),
            pos3d_utm=np.stack([easting, northing, num[:, 3] + observer_height], axis=1),
            lonlat=num[:, 1:3].copy())
    grid_codes, pos3d, lonlat = [], [], []
    with open(filename, encoding="utf-8-sig") as f:
        rows = list(csv.reader(f))
    for row in rows[1:]:
        if not row or not row[0].strip():
            continue
        if schema == "planar":
            grid_codes.append(int(_f(row[2])))
            pos3d.append(np.array([_f(row[3]), _f(row[4]), _f(row[5]) + observer_height]))
            lonlat.append(np.zeros(2))
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
