"""DEM raster ingest and sampling grids (port of ``ransac_tpu.io.dem``).

Replaces the reference's GDAL + scipy ``RegularGridInterpolator`` stack
(``main_v1.py:425-465``).  Two representations:

- ``DemLonLat``: the raster as shipped, a regular grid in lon/lat from the
  GeoTIFF geotransform.  Matches the reference's interpolator (bilinear
  over (lat, lon)).
- ``DemUtm``: the same surface resampled once at load onto a regular,
  scene-centred UTM grid, so the march needs only a bilinear gather and
  no geodesy in its loop (the reference calls PROJ at every 1 m step,
  main_v1.py:642).

The ingest (``load_geotiff``, ``from_arrays``, ``resample_to_utm``) is
float64 numpy on the host.  The samplers are torch code on the device of
their inputs; ``DemUtm.device_arrays`` puts the grid and its origin and
spacing there as float32 tensors.  The samplers divide by those 0-d
tensors: PyTorch turns a division by a Python float into a multiply by
its reciprocal, which can move a query into the next cell.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ransac_tpu_torch.ops.geodesy import SceneFrame, utm_to_wgs84, wgs84_to_utm


@dataclass
class DemLonLat:
    data: np.ndarray      # [H, W] f32 elevations
    lon: np.ndarray       # [W] ascending
    lat: np.ndarray       # [H] ascending
    utm_x_range: tuple    # corner-derived UTM easting range (main_v1.py:435-452)
    utm_y_range: tuple

    @property
    def lon_range(self):
        return float(self.lon.min()), float(self.lon.max())

    @property
    def lat_range(self):
        return float(self.lat.min()), float(self.lat.max())

    def interpolate(self, lat, lon):
        """Bilinear elevation lookup, reference interpolator semantics
        ((lat, lon) order, main_v1.py:454)."""
        return _bilinear_np(self.data, self.lat, self.lon, lat, lon)


@dataclass
class DemUtm:
    """Regular scene-centred UTM elevation grid."""

    data: np.ndarray      # [H, W] f32; rows index northing ascending
    x0: float             # centred easting of col 0
    y0: float             # centred northing of row 0
    dx: float
    dy: float
    frame: SceneFrame

    def device_arrays(self, device="cuda"):
        """(data [H, W], x0, y0, dx, dy) on ``device``, all float32; the four
        scalars are 0-d tensors (JAX's ``device_arrays`` gives float32
        scalars)."""
        return (torch.as_tensor(np.asarray(self.data, np.float32), device=device),
                *(torch.full((), v, dtype=torch.float32, device=device)
                  for v in (self.x0, self.y0, self.dx, self.dy)))


def dem_from_numpy(dem) -> DemUtm:
    """The state carried across: the numpy fields of a JAX
    ``ransac_tpu.io.dem.DemUtm`` (read by attribute, so JAX is never
    imported here) as the port's ``DemUtm``."""
    fr = dem.frame
    return DemUtm(data=np.asarray(dem.data, np.float32), x0=float(dem.x0),
                  y0=float(dem.y0), dx=float(dem.dx), dy=float(dem.dy),
                  frame=SceneFrame(anchor=np.asarray(fr.anchor, np.float64),
                                   zone=fr.zone, northern=fr.northern))


def _bilinear_np(grid, rows_coord, cols_coord, r, c):
    r = np.asarray(r, np.float64)
    c = np.asarray(c, np.float64)
    ri = np.interp(r, rows_coord, np.arange(len(rows_coord)))
    ci = np.interp(c, cols_coord, np.arange(len(cols_coord)))
    r0 = np.clip(np.floor(ri).astype(int), 0, grid.shape[0] - 2)
    c0 = np.clip(np.floor(ci).astype(int), 0, grid.shape[1] - 2)
    fr = ri - r0
    fc = ci - c0
    g = grid
    return ((g[r0, c0] * (1 - fr) * (1 - fc))
            + g[r0 + 1, c0] * fr * (1 - fc)
            + g[r0, c0 + 1] * (1 - fr) * fc
            + g[r0 + 1, c0 + 1] * fr * fc)


def device_scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor on ``like``'s device: ``v`` itself, or a number
    filled in on the device (no host-to-device copy)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def _cell(x, y, x0, y0, dx, dy, h, w):
    """(r0, c0 int32 cells clamped to [0, h-2] x [0, w-2], fr, fc) of
    centred (x, y): true divisions by the 0-d spacings, then floor."""
    ci = (x - device_scalar(x0, x)) / device_scalar(dx, x)
    ri = (y - device_scalar(y0, y)) / device_scalar(dy, y)
    r0 = torch.floor(ri).to(torch.int32).clamp(0, h - 2)
    c0 = torch.floor(ci).to(torch.int32).clamp(0, w - 2)
    fr = torch.clamp(ri - r0, 0.0, 1.0)
    fc = torch.clamp(ci - c0, 0.0, 1.0)
    return r0, c0, fr, fc


def _blend(v00, v10, v01, v11, fr, fc):
    return (v00 * (1 - fr) * (1 - fc) + v10 * fr * (1 - fc)
            + v01 * (1 - fr) * fc + v11 * fr * fc)


def bilinear_sample(data: torch.Tensor, x0, y0, dx, dy,
                    x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear gather on a regular grid: elevation at centred-UTM (x, y).
    Out-of-range queries clamp to the border (callers bound-check
    separately, mirroring main_v1.py:921-929)."""
    h, w = data.shape
    r0, c0, fr, fc = _cell(x, y, x0, y0, dx, dy, h, w)
    flat = data.reshape(-1)
    i00 = r0.long() * w + c0.long()
    return _blend(flat[i00], flat[i00 + w], flat[i00 + 1], flat[i00 + w + 1],
                  fr, fc)


def pack_bilinear(data, device=None) -> torch.Tensor:
    """Quad-pack a [H, W] grid for one-gather bilinear sampling: every 2x2
    neighbourhood any (r0, c0) needs is one 16-byte row of a [4 Hp Wp, 4]
    array, in 4 parity planes indexed by (r0 & 1, c0 & 1), so
    :func:`bilinear_sample_packed` fetches all four corners in one row
    gather.  Memory: 4x the grid.  Built on the host (numpy), returned on
    ``device`` (default: ``data``'s, or the CPU for an array)."""
    if isinstance(data, torch.Tensor):
        device = data.device if device is None else device
        data = data.cpu().numpy()
    d = np.asarray(data, np.float32)
    h, w = d.shape
    hp, wp = (h + 1) // 2, (w + 1) // 2
    d = np.pad(d, ((0, 2 * hp + 2 - h), (0, 2 * wp + 2 - w)), mode="edge")
    planes = []
    for pr in (0, 1):
        for pc in (0, 1):
            q = np.stack(
                [d[pr:pr + 2 * hp:2, pc:pc + 2 * wp:2],
                 d[pr:pr + 2 * hp:2, pc + 1:pc + 1 + 2 * wp:2],
                 d[pr + 1:pr + 1 + 2 * hp:2, pc:pc + 2 * wp:2],
                 d[pr + 1:pr + 1 + 2 * hp:2, pc + 1:pc + 1 + 2 * wp:2]],
                axis=-1)
            planes.append(q.reshape(-1, 4))
    return torch.as_tensor(np.concatenate(planes),
                           device="cpu" if device is None else device)


def bilinear_sample_packed(pack: torch.Tensor, h: int, w: int, x0, y0,
                           dx, dy, x: torch.Tensor, y: torch.Tensor):
    """:func:`bilinear_sample` through the quad-packed grid (one row gather
    a query).  ``h, w`` are the original grid's."""
    hp, wp = (h + 1) // 2, (w + 1) // 2
    r0, c0, fr, fc = _cell(x, y, x0, y0, dx, dy, h, w)
    plane = (r0 & 1) * 2 + (c0 & 1)
    g = pack[(plane * (hp * wp) + (r0 >> 1) * wp + (c0 >> 1)).long()]
    return _blend(g[..., 0], g[..., 2], g[..., 1], g[..., 3], fr, fc)


def in_bounds(dem: DemUtm, x, y, margin: float = 0.0):
    xmax = dem.x0 + dem.dx * (dem.data.shape[1] - 1)
    ymax = dem.y0 + dem.dy * (dem.data.shape[0] - 1)
    return ((x >= dem.x0 + margin) & (x <= xmax - margin)
            & (y >= dem.y0 + margin) & (y <= ymax - margin))


def load_geotiff(path: str, zone: int = 50,
                 nodata_fill: float = float("nan")) -> DemLonLat:
    """GeoTIFF -> DemLonLat through the dependency-free reader in
    :mod:`ransac_tpu_torch.io.tiff` (tiled and strip layouts, Deflate/LZW/
    PackBits, predictors 2/3, BigTIFF, GDAL_NODATA, full
    ModelTransformation).  TIFF variants outside that set (e.g. JPEG
    compression) fall back to PIL, imported only then.

    Nodata cells become ``nodata_fill`` (default NaN: bilinear samples
    touching them are NaN, so a ray never "hits" a nodata hole and the
    bounds checks mirroring main_v1.py:921-929 reject queries there).
    """
    from ransac_tpu_torch.io import tiff as tifflib

    try:
        raw, tags = tifflib.read_tiff(path)
        gt = tifflib.geotransform(tags)
        nodata = tifflib.nodata_value(tags)
    except ValueError:
        raise
    except Exception:  # non-TIFF container / exotic codec: try PIL
        raw, gt, nodata = _read_with_pil(path)
    data = np.asarray(raw, dtype=np.float32)
    if nodata is not None:
        data = np.where(
            np.isclose(data, np.float32(nodata), rtol=1e-6, atol=0.0),
            np.float32(nodata_fill), data)
    lon0, dlon, _, lat0, _, dlat = gt
    h, w = data.shape[:2]
    lon = lon0 + np.arange(w) * dlon
    lat = lat0 + np.arange(h) * dlat
    return from_arrays(data, lon, lat, zone=zone)


def _read_with_pil(path: str):
    """(raster, geotransform, nodata) of a TIFF through PIL's tag parser."""
    from PIL import Image

    im = Image.open(path)
    raw = np.asarray(im)
    t = im.tag_v2
    scale, tiepoint = t.get(33550), t.get(33922)
    if scale is None or tiepoint is None:
        m = t.get(34264)
        if m is None:
            raise ValueError(f"{path}: no geotransform tags")
        if abs(m[1]) > 1e-12 or abs(m[4]) > 1e-12:
            # As the native reader: a rotated/sheared raster has no
            # axis-aligned (lon, lat) grid to interpolate on.
            raise ValueError(f"{path}: rotated rasters unsupported")
        gt = (m[3], m[0], m[1], m[7], m[4], m[5])
    else:
        gt = (tiepoint[3], scale[0], 0.0, tiepoint[4], 0.0, -scale[1])
    nodata = None
    nd = t.get(42113)
    if nd is not None:
        try:
            nodata = float(str(nd).strip())
        except ValueError:
            pass
    return raw, gt, nodata


def from_arrays(data: np.ndarray, lon: np.ndarray, lat: np.ndarray,
                zone: int = 50) -> DemLonLat:
    data = np.asarray(data, np.float32)
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    if lat[0] > lat[-1]:  # store ascending (north-up rasters)
        lat = lat[::-1]
        data = data[::-1]
    if lon.size > 1 and lon[0] > lon[-1]:  # west-east-flipped rasters
        lon = lon[::-1]
        data = data[:, ::-1]
    corners = [(lon.min(), lat.min()), (lon.min(), lat.max()),
               (lon.max(), lat.min()), (lon.max(), lat.max())]
    es, ns = zip(*[wgs84_to_utm(lo, la, zone) for lo, la in corners])
    return DemLonLat(
        data=data, lon=lon, lat=lat,
        utm_x_range=(min(es), max(es)), utm_y_range=(min(ns), max(ns)))


def resample_to_utm(dem: DemLonLat, frame: SceneFrame,
                    spacing_m: float = 10.0) -> DemUtm:
    """One-time warp onto a regular scene-centred UTM grid (host float64
    geodesy, bilinear resample)."""
    x_min = dem.utm_x_range[0] - frame.anchor[0]
    x_max = dem.utm_x_range[1] - frame.anchor[0]
    y_min = dem.utm_y_range[0] - frame.anchor[1]
    y_max = dem.utm_y_range[1] - frame.anchor[1]
    xs = np.arange(x_min, x_max + spacing_m, spacing_m)
    ys = np.arange(y_min, y_max + spacing_m, spacing_m)
    XX, YY = np.meshgrid(xs, ys)
    lon, lat = utm_to_wgs84(
        XX.ravel() + frame.anchor[0], YY.ravel() + frame.anchor[1],
        frame.zone, frame.northern)
    # Clamp to the raster footprint (the UTM bbox of a lon/lat rectangle
    # overhangs it).
    lat = np.clip(lat, dem.lat.min(), dem.lat.max())
    lon = np.clip(lon, dem.lon.min(), dem.lon.max())
    z = dem.interpolate(lat, lon).reshape(YY.shape).astype(np.float32)
    return DemUtm(data=z, x0=float(xs[0]), y0=float(ys[0]),
                  dx=spacing_m, dy=spacing_m, frame=frame)


def center_elevations(dem: DemUtm) -> DemUtm:
    """The grid with its elevations relative to the frame's anchor z, as
    the scene's centred coordinates are.  ``resample_to_utm`` keeps
    absolute elevations (as the JAX package's does); a camera snapped onto
    such a grid and control points centred by the scene frame then differ
    in z by the anchor's z."""
    z = np.asarray(dem.data, np.float64) - dem.frame.anchor[2]
    return DemUtm(data=z.astype(np.float32), x0=dem.x0, y0=dem.y0, dx=dem.dx,
                  dy=dem.dy, frame=dem.frame)


def polygon_interior_elevations(dem: DemUtm, polygon_xy: np.ndarray,
                                spacing_m: float | None = None):
    """DEM elevations on a grid of points inside a polygon (the
    ``3D-1.py:44-121`` capability: polygon interior -> elevation samples
    for the terrain mesh), on the host.  polygon_xy is [V, 2] centred UTM;
    returns [M, 3] (x, y, z) interior samples."""
    poly = np.asarray(polygon_xy, np.float64)
    if spacing_m is None:
        spacing_m = max(dem.dx, dem.dy)
    x0, y0 = poly.min(0)
    x1, y1 = poly.max(0)
    xs = np.arange(x0, x1 + spacing_m, spacing_m)
    ys = np.arange(y0, y1 + spacing_m, spacing_m)
    XX, YY = np.meshgrid(xs, ys)
    pts = np.stack([XX.ravel(), YY.ravel()], 1)

    # Even-odd rule point-in-polygon (vectorized).
    inside = np.zeros(len(pts), bool)
    n = len(poly)
    for i in range(n):
        x1p, y1p = poly[i]
        x2p, y2p = poly[(i + 1) % n]
        cond = ((y1p > pts[:, 1]) != (y2p > pts[:, 1]))
        denom = np.where(y2p == y1p, 1e-30, y2p - y1p)
        x_int = x1p + (pts[:, 1] - y1p) * (x2p - x1p) / denom
        inside ^= cond & (pts[:, 0] < x_int)
    pts = pts[inside]
    if len(pts) == 0:
        return np.zeros((0, 3))
    z = bilinear_sample(*dem.device_arrays("cpu"),
                        torch.as_tensor(pts[:, 0], dtype=torch.float32),
                        torch.as_tensor(pts[:, 1], dtype=torch.float32))
    return np.concatenate([pts, z.numpy()[:, None]], axis=1)


def synthetic_dem(frame: SceneFrame, extent_m: float = 4000.0,
                  spacing_m: float = 10.0, base_z: float = 0.0,
                  terrain_fn=None) -> DemUtm:
    """Analytic terrain for tests and demos; defaults to a gentle
    paraboloid."""
    xs = np.arange(-extent_m, extent_m + spacing_m, spacing_m)
    ys = np.arange(-extent_m, extent_m + spacing_m, spacing_m)
    XX, YY = np.meshgrid(xs, ys)
    if terrain_fn is None:
        z = base_z + 100.0 * np.exp(-((XX / 1500.0) ** 2 + (YY / 1500.0) ** 2))
    else:
        z = terrain_fn(XX, YY)
    return DemUtm(data=z.astype(np.float32), x0=float(xs[0]), y0=float(ys[0]),
                  dx=spacing_m, dy=spacing_m, frame=frame)
