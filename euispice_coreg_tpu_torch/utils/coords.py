"""Host-side (float64 numpy) coordinate helpers built on the WCS core.

These replace the astropy-WCS-based utilities of the reference
(``AlignEUIUtil.extract_EUI_coordinates``, ``PlotFits.build_regular_grid``;
``euispice_coreg/utils/Util.py:282-312, 873-945``).
"""
from __future__ import annotations

import numpy as np

from ..core import wcs
from ..core.header import Header, wcs_params_from_header
from . import units


def pixel_grid(naxis1: int, naxis2: int):
    """(x, y) pixel index grids of shape (naxis2, naxis1), 'xy' indexing —
    matching ``np.meshgrid(np.arange(nx), np.arange(ny))`` in the reference."""
    return np.meshgrid(
        np.arange(naxis1, dtype=np.float64),
        np.arange(naxis2, dtype=np.float64),
    )


def header_world_grid(hdr: Header, wrap: bool | None = None):
    """World (lon, lat) in degrees for every pixel of a 2-D header.

    ``wrap`` applies the ]-180, 180] wrap; defaults to True for TAN
    (helioprojective) frames and False for CAR, mirroring
    ``extract_EUI_coordinates``'s ang2pipi usage (Util.py:291-306).
    """
    params = wcs_params_from_header(hdr)
    if wrap is None:
        wrap = params.kind == "tan"
    naxis1 = int(hdr.get("ZNAXIS1", hdr.get("NAXIS1")))
    naxis2 = int(hdr.get("ZNAXIS2", hdr.get("NAXIS2")))
    x, y = pixel_grid(naxis1, naxis2)
    lon, lat = wcs.pixel_to_world(params.as_dict(), x, y, kind=params.kind, xp=np)
    if wrap:
        lon = units.ang2pipi_deg(lon)
        lat = units.ang2pipi_deg(lat)
    return lon, lat


def world_to_pixel_of_header(hdr: Header, lon_deg, lat_deg):
    """World (deg) -> 0-based pixel coordinates of ``hdr``'s grid."""
    params = wcs_params_from_header(hdr)
    return wcs.world_to_pixel(params.as_dict(), lon_deg, lat_deg,
                              kind=params.kind, xp=np)


def build_regular_grid(longitude_deg, latitude_deg, lonlims_deg=None, latlims_deg=None):
    """Regular lon/lat grid covering (and stepped like) an irregular one.

    Port of ``PlotFits.build_regular_grid`` (Util.py:873-904): the step is the
    euclidean distance between neighboring grid points, the extent is the
    min/max of the inputs, optionally clipped to limits.  Everything in deg.

    Returns (lon_grid, lat_grid, dlon, dlat); grids have shape
    (n_lat, n_lon).
    """
    lon = np.asarray(longitude_deg, dtype=np.float64)
    lat = np.asarray(latitude_deg, dtype=np.float64)
    dlon = float(np.hypot(lon[0, 1] - lon[0, 0], lat[0, 1] - lat[0, 0]))
    dlat = float(np.hypot(lon[1, 0] - lon[0, 0], lat[1, 0] - lat[0, 0]))
    lon1d = np.arange(np.nanmin(lon), np.nanmax(lon), dlon)
    lat1d = np.arange(np.nanmin(lat), np.nanmax(lat), dlat)
    if lonlims_deg is not None:
        lon1d = lon1d[(lon1d > lonlims_deg[0]) & (lon1d < lonlims_deg[1])]
    if latlims_deg is not None:
        lat1d = lat1d[(lat1d > latlims_deg[0]) & (lat1d < latlims_deg[1])]
    lon_grid, lat_grid = np.meshgrid(lon1d, lat1d)
    return lon_grid, lat_grid, dlon, dlat
