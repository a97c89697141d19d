"""GPS coordinate transforms: WGS84 ellipsoidal <-> ECEF <-> local ENU.

The port's own copy of dagsfm_tpu/utils/gps.py (COLMAP's GPSTransform:
EllToXYZ, XYZToEll, EllToENU), which the spatial matcher uses for GPS
priors. Host numpy math, line for line the reference's.
"""

from __future__ import annotations

import numpy as np

# WGS84 ellipsoid (ref gps.h kWGS84)
WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
# GRS80 (ref gps.h kGRS80)
GRS80_A = 6378137.0
GRS80_F = 1.0 / 298.257222100882711


def ell_to_xyz(lat_lon_alt: np.ndarray, a: float = WGS84_A,
               f: float = WGS84_F) -> np.ndarray:
    """(N, 3) [lat(deg), lon(deg), alt(m)] -> ECEF (N, 3) meters."""
    lla = np.atleast_2d(np.asarray(lat_lon_alt, float))
    lat = np.radians(lla[:, 0])
    lon = np.radians(lla[:, 1])
    alt = lla[:, 2]
    e2 = f * (2 - f)
    N = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    x = (N + alt) * np.cos(lat) * np.cos(lon)
    y = (N + alt) * np.cos(lat) * np.sin(lon)
    z = (N * (1 - e2) + alt) * np.sin(lat)
    return np.column_stack([x, y, z])


def xyz_to_ell(xyz: np.ndarray, a: float = WGS84_A,
               f: float = WGS84_F) -> np.ndarray:
    """ECEF -> [lat(deg), lon(deg), alt(m)] (iterative, ref XYZToEll)."""
    xyz = np.atleast_2d(np.asarray(xyz, float))
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    e2 = f * (2 - f)
    lon = np.arctan2(y, x)
    p = np.sqrt(x ** 2 + y ** 2)
    lat = np.arctan2(z, p * (1 - e2))
    for _ in range(100):
        N = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
        alt = p / np.cos(lat) - N
        lat_new = np.arctan2(z, p * (1 - e2 * N / (N + alt)))
        if np.abs(lat_new - lat).max() < 1e-14:
            lat = lat_new
            break
        lat = lat_new
    N = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    alt = p / np.cos(lat) - N
    return np.column_stack([np.degrees(lat), np.degrees(lon), alt])


def ell_to_enu(lat_lon_alt: np.ndarray, ref_lat: float | None = None,
               ref_lon: float | None = None) -> np.ndarray:
    """Ellipsoidal -> local East-North-Up about the (first or given)
    reference point (ref EllToENU)."""
    lla = np.atleast_2d(np.asarray(lat_lon_alt, float))
    xyz = ell_to_xyz(lla)
    if ref_lat is None:
        ref_lat, ref_lon = lla[0, 0], lla[0, 1]
    ref_xyz = ell_to_xyz(np.array([[ref_lat, ref_lon, lla[0, 2]]]))[0]
    lat0 = np.radians(ref_lat)
    lon0 = np.radians(ref_lon)
    R = np.array([
        [-np.sin(lon0), np.cos(lon0), 0.0],
        [-np.sin(lat0) * np.cos(lon0), -np.sin(lat0) * np.sin(lon0),
         np.cos(lat0)],
        [np.cos(lat0) * np.cos(lon0), np.cos(lat0) * np.sin(lon0),
         np.sin(lat0)],
    ])
    return (xyz - ref_xyz) @ R.T
