"""CSV / GeoJSON / ESRI-shapefile export layer (copy of
``ransac_tpu.io.export``, host-only, numpy and the standard library).

Replaces the reference's scattered csv.writer blocks
(``main_v1.py:286-292`` location scores, ``:384-397`` accuracies +
correlations, ``:788-801`` boundary points) and its geopandas shapefile
writer (``main_v1.py:804-831``) — the shapefile writer here is pure Python
(no GEOS/GDAL dependency).
"""

from __future__ import annotations

import csv
import json
import os
import struct
from typing import Iterable, Sequence

import numpy as np

# Header exactly as the reference writes it (main_v1.py:290) — the names
# 'min_score'/'max_score' are historical: the columns hold (err1, err2) and
# Z,X,Y hold easting, northing, elevation.
LOCATION_HEADER = ["location_id", "min_score", "max_score", "grid_code",
                   "Z", "X", "Y"]


def write_location_csv(path: str, rows: Iterable[Sequence]) -> None:
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(LOCATION_HEADER)
        for r in rows:
            w.writerow(r)


def write_rows_csv(path: str, rows: Iterable[Sequence],
                   encoding: str = "utf-8") -> None:
    """Raw row dump (accuracies/correlations layout: header row included by
    caller, matching main_v1.py:384-397)."""
    with open(path, "w", newline="", encoding=encoding) as f:
        w = csv.writer(f)
        for r in rows:
            w.writerow(r)


BOUNDARY_HEADER = ["category", "group", "pixel_x", "pixel_y",
                   "geo_x", "geo_y", "geo_z"]


def write_boundary_csv(path: str, boundary_geo: dict, boundary_pix: dict) -> None:
    """boundary_points_geo.csv layout (main_v1.py:788-801): keys are
    (group, category) tuples."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(BOUNDARY_HEADER)
        for (group, category), coords in boundary_geo.items():
            pix = boundary_pix[(group, category)]
            for (px, py), c in zip(pix, coords):
                w.writerow([category, group, px, py, c[0], c[1], c[2]])


def write_geojson(path: str, polygons: dict, crs_epsg: int = 32650,
                  properties: dict | None = None) -> None:
    """polygons: {(group, category): [[x, y, z], ...]}."""
    feats = []
    for (group, category), coords in polygons.items():
        if len(coords) < 3:
            continue
        ring = [[float(c[0]), float(c[1])] for c in coords]
        if ring[0] != ring[-1]:
            ring.append(ring[0])
        props = {"group": group, "category": category}
        if properties:
            props.update(properties)
        feats.append({
            "type": "Feature", "properties": props,
            "geometry": {"type": "Polygon", "coordinates": [ring]},
        })
    doc = {
        "type": "FeatureCollection",
        "crs": {"type": "name",
                "properties": {"name": f"urn:ogc:def:crs:EPSG::{crs_epsg}"}},
        "features": feats,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)


# --------------------------------------------------------------------------
# Pure-Python ESRI shapefile writer (polygon type), replacing
# geopandas/GEOS (main_v1.py:804-831).
# --------------------------------------------------------------------------
def _ring_area(ring: np.ndarray) -> float:
    x, y = ring[:, 0], ring[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _ring_perimeter(ring: np.ndarray) -> float:
    d = np.diff(np.vstack([ring, ring[:1]]), axis=0)
    return float(np.sqrt((d ** 2).sum(1)).sum())


_WGS84_UTM50N_WKT = (
    'PROJCS["WGS 84 / UTM zone 50N",GEOGCS["WGS 84",DATUM["WGS_1984",'
    'SPHEROID["WGS 84",6378137,298.257223563]],PRIMEM["Greenwich",0],'
    'UNIT["degree",0.0174532925199433]],PROJECTION["Transverse_Mercator"],'
    'PARAMETER["latitude_of_origin",0],PARAMETER["central_meridian",117],'
    'PARAMETER["scale_factor",0.9996],PARAMETER["false_easting",500000],'
    'PARAMETER["false_northing",0],UNIT["metre",1]]'
)


def write_polygon_shapefile(
    basepath: str,
    rings: list[np.ndarray],
    attributes: list[dict],
    prj_wkt: str = _WGS84_UTM50N_WKT,
) -> None:
    """Write <basepath>.shp/.shx/.dbf/.prj for a list of single-ring
    polygons with string/float attributes.

    Implements the ESRI shapefile spec directly: main header (100 bytes,
    big-endian lengths), polygon records (shape type 5), fixed-width DBF.
    """
    rings = [np.asarray(r, dtype=np.float64)[:, :2] for r in rings]
    closed = []
    for r in rings:
        # Outer rings must be clockwise and closed per spec.
        if _ring_area(r) > 0:
            r = r[::-1]
        if not np.array_equal(r[0], r[-1]):
            r = np.vstack([r, r[:1]])
        closed.append(r)
    rings = closed

    records = []
    for r in rings:
        n = len(r)
        content = struct.pack("<i", 5)  # polygon
        xs, ys = r[:, 0], r[:, 1]
        content += struct.pack("<4d", xs.min(), ys.min(), xs.max(), ys.max())
        content += struct.pack("<ii", 1, n)      # numparts, numpoints
        content += struct.pack("<i", 0)          # part start index
        for x, y in r:
            content += struct.pack("<2d", x, y)
        records.append(content)

    all_pts = np.vstack(rings)
    bbox = (all_pts[:, 0].min(), all_pts[:, 1].min(),
            all_pts[:, 0].max(), all_pts[:, 1].max())

    def main_header(file_len_words: int) -> bytes:
        h = struct.pack(">i5i", 9994, 0, 0, 0, 0, 0)
        h += struct.pack(">i", file_len_words)
        h += struct.pack("<ii", 1000, 5)
        h += struct.pack("<4d", *bbox)
        h += struct.pack("<4d", 0, 0, 0, 0)  # z/m ranges
        return h

    shp_len = 100 + sum(8 + len(c) for c in records)
    with open(basepath + ".shp", "wb") as f:
        f.write(main_header(shp_len // 2))
        for i, c in enumerate(records):
            f.write(struct.pack(">ii", i + 1, len(c) // 2))
            f.write(c)

    shx_len = 100 + 8 * len(records)
    with open(basepath + ".shx", "wb") as f:
        f.write(main_header(shx_len // 2))
        offset = 50
        for c in records:
            f.write(struct.pack(">ii", offset, len(c) // 2))
            offset += 4 + len(c) // 2

    # DBF: derive field schema from the first attribute dict.
    fields = []
    if attributes:
        for k, v in attributes[0].items():
            if isinstance(v, (int, float, np.floating, np.integer)):
                fields.append((k[:10], "N", 24, 8))
            else:
                fields.append((k[:10], "C", 64, 0))
    rec_len = 1 + sum(f[2] for f in fields)
    with open(basepath + ".dbf", "wb") as f:
        import datetime

        now = datetime.date.today()
        f.write(struct.pack("<BBBBIHH20x", 3, now.year - 1900, now.month,
                            now.day, len(attributes),
                            32 + 32 * len(fields) + 1, rec_len))
        for name, ftype, flen, fdec in fields:
            f.write(struct.pack("<11sc4xBB14x", name.encode("ascii", "replace"),
                                ftype.encode(), flen, fdec))
        f.write(b"\r")
        for attr in attributes:
            f.write(b" ")
            for name, ftype, flen, fdec in fields:
                v = attr.get(name, attr.get(name[:10], ""))
                if ftype == "N":
                    s = f"{float(v):{flen}.{fdec}f}"[:flen].rjust(flen)
                else:
                    s = str(v)[:flen].ljust(flen)
                f.write(s.encode("utf-8", "replace")[:flen].ljust(flen))
        f.write(b"\x1a")

    with open(basepath + ".prj", "w", encoding="ascii") as f:
        f.write(prj_wkt)


def save_boundary_shapefiles(
    boundary_geo: dict, output_dir: str, name: str = "",
) -> list[str]:
    """Per-(group,category) polygon shapefiles with area/perimeter
    attributes — main_v1.py:804-831 parity (skips <3-vertex groups)."""
    import re

    os.makedirs(output_dir, exist_ok=True)
    written = []
    for (group, category), coords in boundary_geo.items():
        if len(coords) < 3:
            continue
        ring = np.asarray(coords, dtype=np.float64)[:, :2]
        attrs = [{
            "group": group, "name": name, "category": category,
            "area": abs(_ring_area(ring)),
            "perimeter": _ring_perimeter(ring),
        }]
        sanitized = re.sub(r"[^a-zA-Z0-9]", "", str(category))
        base = os.path.join(output_dir, f"{sanitized}_{group}_boundary")
        write_polygon_shapefile(base, [ring], attrs)
        written.append(base + ".shp")
    return written
