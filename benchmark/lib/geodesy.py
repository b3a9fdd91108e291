"""WGS84 <-> UTM in float64 numpy (Karney/Krüger series, order 6).

A frozen copy of ``ransac_tpu_torch/ops/geodesy.py``'s transverse Mercator
forward and inverse, so that the benchmark's generators and reference do
not move when the program's geodesy does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# WGS84 ellipsoid.
A_WGS84 = 6378137.0
F_WGS84 = 1.0 / 298.257223563
# UTM scale/offsets.
K0_UTM = 0.9996
FALSE_EASTING = 500_000.0
FALSE_NORTHING_SOUTH = 10_000_000.0

_N = F_WGS84 / (2.0 - F_WGS84)  # third flattening
_E2 = F_WGS84 * (2.0 - F_WGS84)  # eccentricity^2
_E = math.sqrt(_E2)

# Rectifying radius A = a/(1+n) * (1 + n^2/4 + n^4/64 + n^6/256).
_A_RECT = A_WGS84 / (1.0 + _N) * (
    1.0 + _N**2 / 4.0 + _N**4 / 64.0 + _N**6 / 256.0
)

# Krüger alpha (forward) / beta (inverse) series coefficients, order 6.
_ALPHA = (
    _N / 2.0 - 2.0 * _N**2 / 3.0 + 5.0 * _N**3 / 16.0 + 41.0 * _N**4 / 180.0
    - 127.0 * _N**5 / 288.0 + 7891.0 * _N**6 / 37800.0,
    13.0 * _N**2 / 48.0 - 3.0 * _N**3 / 5.0 + 557.0 * _N**4 / 1440.0
    + 281.0 * _N**5 / 630.0 - 1983433.0 * _N**6 / 1935360.0,
    61.0 * _N**3 / 240.0 - 103.0 * _N**4 / 140.0 + 15061.0 * _N**5 / 26880.0
    + 167603.0 * _N**6 / 181440.0,
    49561.0 * _N**4 / 161280.0 - 179.0 * _N**5 / 168.0
    + 6601661.0 * _N**6 / 7257600.0,
    34729.0 * _N**5 / 80640.0 - 3418889.0 * _N**6 / 1995840.0,
    212378941.0 * _N**6 / 319334400.0,
)
_BETA = (
    _N / 2.0 - 2.0 * _N**2 / 3.0 + 37.0 * _N**3 / 96.0 - _N**4 / 360.0
    - 81.0 * _N**5 / 512.0 + 96199.0 * _N**6 / 604800.0,
    _N**2 / 48.0 + _N**3 / 15.0 - 437.0 * _N**4 / 1440.0
    + 46.0 * _N**5 / 105.0 - 1118711.0 * _N**6 / 3870720.0,
    17.0 * _N**3 / 480.0 - 37.0 * _N**4 / 840.0 - 209.0 * _N**5 / 4480.0
    + 5569.0 * _N**6 / 90720.0,
    4397.0 * _N**4 / 161280.0 - 11.0 * _N**5 / 504.0
    - 830251.0 * _N**6 / 7257600.0,
    4583.0 * _N**5 / 161280.0 - 108847.0 * _N**6 / 3991680.0,
    20648693.0 * _N**6 / 638668800.0,
)


def utm_zone_lon0_deg(zone: int) -> float:
    """Central meridian of a UTM zone (zone 50 -> 117E, EPSG:32650)."""
    return float(zone) * 6.0 - 183.0


def _hyp(x):
    return np.sqrt(1.0 + x * x)


def _taupf(tau):
    """tau' = conformal-latitude tangent from geodetic tangent tau."""
    tau1 = _hyp(tau)
    sig = np.sinh(_E * np.arctanh(_E * tau / tau1))
    return tau * _hyp(sig) - sig * tau1


def _tauf(taup):
    """Invert _taupf by Newton iteration (5 steps, Karney's update)."""
    e2m = 1.0 - _E2
    tau = taup / e2m  # first guess
    for _ in range(5):
        taupa = _taupf(tau)
        dtau = (
            (taup - taupa) * (1.0 + e2m * tau * tau)
            / (e2m * _hyp(tau) * _hyp(taupa))
        )
        tau = tau + dtau
    return tau


def _tm_forward(lon_deg, lat_deg, lon0_deg):
    """Transverse Mercator forward: (lon, lat) degrees -> unscaled (x, y)
    in meters from the central meridian/equator."""
    lam = np.radians(lon_deg - lon0_deg)
    phi = np.radians(lat_deg)
    tau = np.tan(phi)
    taup = _taupf(tau)
    coslam = np.cos(lam)
    xip = np.arctan2(taup, coslam)
    etap = np.arcsinh(np.sin(lam) / np.sqrt(taup * taup + coslam * coslam))
    xi = xip
    eta = etap
    for j, a in enumerate(_ALPHA, start=1):
        xi = xi + a * np.sin(2.0 * j * xip) * np.cosh(2.0 * j * etap)
        eta = eta + a * np.cos(2.0 * j * xip) * np.sinh(2.0 * j * etap)
    return _A_RECT * eta, _A_RECT * xi


def _tm_inverse(x, y, lon0_deg):
    """Transverse Mercator inverse of ``_tm_forward``."""
    eta = x / _A_RECT
    xi = y / _A_RECT
    xip = xi
    etap = eta
    for j, b in enumerate(_BETA, start=1):
        xip = xip - b * np.sin(2.0 * j * xi) * np.cosh(2.0 * j * eta)
        etap = etap - b * np.cos(2.0 * j * xi) * np.sinh(2.0 * j * eta)
    sinh_etap = np.sinh(etap)
    cos_xip = np.cos(xip)
    lam = np.arctan2(sinh_etap, cos_xip)
    taup = np.sin(xip) / np.sqrt(sinh_etap * sinh_etap + cos_xip * cos_xip)
    tau = _tauf(taup)
    lat = np.degrees(np.arctan(tau))
    lon = lon0_deg + np.degrees(lam)
    return lon, lat


def wgs84_to_utm(lon_deg, lat_deg, zone: int = 50, northern: bool = True):
    """(lon, lat) degrees -> (easting, northing) meters in the given UTM
    zone (EPSG:4326 -> EPSG:32650 with always_xy for zone 50 north)."""
    x, y = _tm_forward(lon_deg, lat_deg, utm_zone_lon0_deg(zone))
    easting = K0_UTM * x + FALSE_EASTING
    northing = K0_UTM * y + (0.0 if northern else FALSE_NORTHING_SOUTH)
    return easting, northing


def utm_to_wgs84(easting, northing, zone: int = 50, northern: bool = True):
    """(easting, northing) meters -> (lon, lat) degrees."""
    x = (easting - FALSE_EASTING) / K0_UTM
    y = (northing - (0.0 if northern else FALSE_NORTHING_SOUTH)) / K0_UTM
    return _tm_inverse(x, y, utm_zone_lon0_deg(zone))


