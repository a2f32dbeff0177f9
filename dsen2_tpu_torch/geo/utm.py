"""WGS84 <-> UTM transverse-Mercator projection, dependency-free.

The reference converts lon/lat ROI corners to tile pixel coordinates
through OSR (testing/s2_tiles_supres.py:141-161). Sentinel-2 products are
always in UTM zones (EPSG 326xx/327xx), whose projection has a compact
closed-form series — so lon/lat ROIs work without GDAL/OSR too.

Implementation: the standard Krueger n-series for the transverse Mercator
(the same formulation every modern GIS uses), with coefficients to n^3 —
sub-millimetre over a UTM zone's extent, far below the 10 m pixel grid
this feeds. Validated in tests/test_utm.py against (a) forward/inverse
round-trips, (b) an independent numerical integration of the meridian
arc, and (c) the first-order expansion near the central meridian.
"""

from __future__ import annotations

import math
from typing import Tuple

__all__ = ["utm_forward", "utm_inverse", "zone_from_epsg"]

_A = 6378137.0  # WGS84 semi-major axis
_F = 1.0 / 298.257223563
_K0 = 0.9996
_E0 = 500000.0  # false easting
_N0_SOUTH = 10000000.0

_N = _F / (2.0 - _F)  # third flattening
_N2, _N3 = _N * _N, _N * _N * _N
# rectifying radius
_ABAR = _A / (1 + _N) * (1 + _N2 / 4 + _N2 * _N2 / 64)
# Krueger series coefficients (to n^3)
_ALPHA = (
    _N / 2 - 2 * _N2 / 3 + 5 * _N3 / 16,
    13 * _N2 / 48 - 3 * _N3 / 5,
    61 * _N3 / 240,
)
_BETA = (
    _N / 2 - 2 * _N2 / 3 + 37 * _N3 / 96,
    _N2 / 48 + _N3 / 15,
    17 * _N3 / 480,
)
_DELTA = (
    2 * _N - 2 * _N2 / 3 - 2 * _N3,
    7 * _N2 / 3 - 8 * _N3 / 5,
    56 * _N3 / 15,
)
_ES = 2 * math.sqrt(_N) / (1 + _N)  # = e for the conformal latitude


def zone_from_epsg(epsg: int) -> Tuple[int, bool]:
    """(zone, is_northern) for a UTM EPSG code (326xx north / 327xx south)."""
    if 32600 < epsg <= 32660:
        return epsg - 32600, True
    if 32700 < epsg <= 32760:
        return epsg - 32700, False
    raise ValueError(f"EPSG {epsg} is not a WGS84 UTM zone")


def _central_meridian(zone: int) -> float:
    if not 1 <= zone <= 60:
        raise ValueError(f"UTM zone must be 1..60, got {zone}")
    return math.radians(zone * 6 - 183)


def utm_forward(lon: float, lat: float, zone: int, north: bool = True
                ) -> Tuple[float, float]:
    """(easting, northing) metres of a WGS84 lon/lat (degrees) in `zone`."""
    lam0 = _central_meridian(zone)
    phi = math.radians(lat)
    lam = math.radians(lon) - lam0

    s = math.sin(phi)
    t = math.sinh(math.atanh(s) - _ES * math.atanh(_ES * s))
    xi_p = math.atan2(t, math.cos(lam))
    eta_p = math.asinh(math.sin(lam) / math.hypot(t, math.cos(lam)))

    xi, eta = xi_p, eta_p
    for j, a in enumerate(_ALPHA, start=1):
        xi += a * math.sin(2 * j * xi_p) * math.cosh(2 * j * eta_p)
        eta += a * math.cos(2 * j * xi_p) * math.sinh(2 * j * eta_p)

    easting = _E0 + _K0 * _ABAR * eta
    northing = _K0 * _ABAR * xi + (0.0 if north else _N0_SOUTH)
    return easting, northing


def utm_inverse(easting: float, northing: float, zone: int, north: bool = True
                ) -> Tuple[float, float]:
    """WGS84 (lon, lat) degrees of UTM metres in `zone`."""
    lam0 = _central_meridian(zone)
    xi = (northing - (0.0 if north else _N0_SOUTH)) / (_K0 * _ABAR)
    eta = (easting - _E0) / (_K0 * _ABAR)

    xi_p, eta_p = xi, eta
    for j, b in enumerate(_BETA, start=1):
        xi_p -= b * math.sin(2 * j * xi) * math.cosh(2 * j * eta)
        eta_p -= b * math.cos(2 * j * xi) * math.sinh(2 * j * eta)

    chi = math.asin(math.sin(xi_p) / math.cosh(eta_p))
    phi = chi
    for j, d in enumerate(_DELTA, start=1):
        phi += d * math.sin(2 * j * chi)
    lam = math.atan2(math.sinh(eta_p), math.cos(xi_p))
    return math.degrees(lam + lam0), math.degrees(phi)
