"""Feature analytics: pairwise distances, bearings, depth-weighted metrics
(copy of ``ransac_tpu.analytics``, numpy only).

Vectorized replacement for the reference's O(N^2) Python loops
(``correlate_features`` ``/root/reference/main_v1.py:162-224``,
``calc_bearing`` ``main_v1.py:230-249``) producing the same
``*_correlations.csv`` row layout.
"""

from __future__ import annotations

import math

import numpy as np

CORRELATION_HEADER = [
    "id", "sym_s", "x_s", "y_s", "pixel_x_s", "pixel_y_s",
    "calc_pixel_x_s", "calc_pixel_y_s",
    "sym_t", "x_t", "y_t", "pixel_x_t", "pixel_y_t", "calc_pixel_x_t",
    "calc_pixel_y_t",
    "dis_m_x", "dis_m_y", "dis_m", "dis_pix_x", "dis_pix_y", "dis_pix",
    "dis_c_pix_x", "dis_c_pix_y", "dis_c_pix", "bear_pix", "dis_depth_pix",
    "bear_c_pix", "dis_depth_c_pix",
]


def calc_bearing(x1, y1, x2, y2):
    """Reference bearing semantics (main_v1.py:230-249): compass angle with
    the quadrant remap; returns 0 if ANY coordinate is exactly 0 (their
    missing-data sentinel).  Vectorized over arrays."""
    x1, y1, x2, y2 = (np.asarray(v, np.float64) for v in (x1, y1, x2, y2))
    deg = np.degrees(np.arctan2(x2 - x1, y2 - y1))
    deg = np.where(deg < 0, 360.0 + deg, deg)
    deg = np.where(deg < 180.0, 180.0 - deg, 360.0 + 180.0 - deg)
    zero = (x1 == 0) | (x2 == 0) | (y1 == 0) | (y2 == 0)
    return np.where(zero, 0.0, deg)


def _depth_weighted(bear, dis, depth_val):
    lo = (bear != 0) & (bear <= 180)
    hi = bear > 180
    out = np.zeros_like(dis)
    out = np.where(lo, (np.abs(bear - 90.0) / 90.0 + depth_val) * dis, out)
    out = np.where(hi, (np.abs(bear - 270.0) / 90.0 + depth_val) * dis, out)
    return out


def correlate_features(
    symbols: list[str],
    pos_xy: np.ndarray,        # [N,2] metric coords (x, y)
    pixels: np.ndarray,        # [N,2] annotated pixels (0 = missing)
    calc_pixels: np.ndarray,   # [N,2] model-projected pixels
    depth_val: float = 1.0,
) -> list[list]:
    """All distinct-symbol pairs (i < j after alphabetical sort, matching
    the reference's sorted traversal) -> correlation rows."""
    order = np.argsort(np.asarray(symbols, dtype=object))
    symbols = [symbols[i] for i in order]
    pos_xy = np.asarray(pos_xy, np.float64)[order]
    pixels = np.asarray(pixels, np.float64)[order]
    calc_pixels = np.asarray(calc_pixels, np.float64)[order]
    n = len(symbols)

    ii, jj = np.triu_indices(n, k=1)
    distinct = np.array([symbols[a] != symbols[b] for a, b in zip(ii, jj)])
    ii, jj = ii[distinct], jj[distinct]

    dm = pos_xy[jj] - pos_xy[ii]
    dis_m = np.hypot(dm[:, 0], dm[:, 1])

    have_pix = (pixels[ii, 0] != 0) & (pixels[jj, 0] != 0)
    dpix = np.where(have_pix[:, None], pixels[jj] - pixels[ii], 0.0)
    dis_pix = np.hypot(dpix[:, 0], dpix[:, 1])

    have_c = (calc_pixels[ii, 0] != 0) & (calc_pixels[jj, 0] != 0)
    dc = np.where(have_c[:, None], calc_pixels[jj] - calc_pixels[ii], 0.0)
    dis_c = np.hypot(dc[:, 0], dc[:, 1])

    bear_pix = calc_bearing(pixels[ii, 0], pixels[ii, 1],
                            pixels[jj, 0], pixels[jj, 1])
    bear_c = calc_bearing(calc_pixels[ii, 0], calc_pixels[ii, 1],
                          calc_pixels[jj, 0], calc_pixels[jj, 1])
    dd_pix = _depth_weighted(bear_pix, dis_pix, depth_val)
    dd_c = _depth_weighted(bear_c, dis_c, depth_val)

    rows = [list(CORRELATION_HEADER)]
    for k, (a, b) in enumerate(zip(ii, jj)):
        rows.append([
            str(k + 1), symbols[a], pos_xy[a, 0], pos_xy[a, 1],
            pixels[a, 0], pixels[a, 1], calc_pixels[a, 0], calc_pixels[a, 1],
            symbols[b], pos_xy[b, 0], pos_xy[b, 1],
            pixels[b, 0], pixels[b, 1], calc_pixels[b, 0], calc_pixels[b, 1],
            dm[k, 0], dm[k, 1], dis_m[k], dpix[k, 0], dpix[k, 1], dis_pix[k],
            dc[k, 0], dc[k, 1], dis_c[k], bear_pix[k], dd_pix[k],
            bear_c[k], dd_c[k],
        ])
    return rows


def nearest_neighbor_distances(points: np.ndarray) -> np.ndarray:
    """Min inter-point distance per point (main_v1.py:403-406)."""
    points = np.asarray(points, np.float64)
    d = np.linalg.norm(points[:, None, :] - points[None, :, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    return d.min(axis=1)


ACCURACY_HEADER = ["id", "symbol", "name", "x", "y", "pixel_x", "pixel_y",
                   "calc_pixel_x", "calc_pixel_y"]


def accuracy_rows(symbols, names, pos_xy, pixels, calc_pixels) -> list[list]:
    """*_accuracies.csv layout (main_v1.py:329, 364)."""
    rows = [list(ACCURACY_HEADER)]
    for i in range(len(symbols)):
        rows.append([
            i, symbols[i], names[i], pos_xy[i, 0], pos_xy[i, 1],
            pixels[i, 0], pixels[i, 1], calc_pixels[i, 0], calc_pixels[i, 1],
        ])
    return rows
