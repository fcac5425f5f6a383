"""Plain geometry of the benchmark: the TAN projection with its PC matrix, and
the Carrington sphere seen from an observer, on torch tensors.

Written from the conventions the coalignment follows (Calabretta & Greisen
2002 for TAN, 1-based CRPIX, LONPOLE 180 deg; the upstream euispice_coreg
``rectify.py`` for the spherical transform and the Hortin 2003 differential
rotation), not from the program under test.  Every function computes in the
dtype and on the device of its tensor arguments; header scalars are Python
floats.  Angles are in degrees unless a name says otherwise.
"""
from __future__ import annotations

import math

import torch

RAD = math.pi / 180.0
R_SUN_M = 6.957e8          # IAU 2015 nominal solar radius
CARRINGTON_RATE = 14.18    # deg/day (rectify.py)
DIFF_ROT = {"171": (14.56, -2.65, 0.96), "195": (14.50, -2.14, 0.66),
            "284": (14.60, -0.71, -1.18), "304": (14.51, -3.12, 0.34)}
RATE_BAND = {"171": "171", "193": "195", "211": "195", "131": "171",
             "304": "304", "335": "304", "94": "171", "174": "171"}


# --------------------------------------------------------------------------
# helioprojective TAN
# --------------------------------------------------------------------------

def tan_params(hdr):
    """WCS scalars of a header with CUNIT arcsec, in degrees, plus CROTA."""
    return {"crval1": hdr["CRVAL1"] / 3600.0, "crval2": hdr["CRVAL2"] / 3600.0,
            "crpix1": float(hdr["CRPIX1"]), "crpix2": float(hdr["CRPIX2"]),
            "cdelt1": hdr["CDELT1"] / 3600.0, "cdelt2": hdr["CDELT2"] / 3600.0,
            "pc11": float(hdr["PC1_1"]), "pc12": float(hdr["PC1_2"]),
            "pc21": float(hdr["PC2_1"]), "pc22": float(hdr["PC2_2"]),
            "crota": float(hdr["CROTA"])}


def pc_matrix(crota, cdelt1, cdelt2):
    """PC of a CROTA rotation, lam = CDELT2 / CDELT1 (FITS paper II)."""
    r = crota * RAD
    lam = cdelt2 / cdelt1
    return math.cos(r), -lam * math.sin(r), math.sin(r) / lam, math.cos(r)


def lagged(p, d1, d2, d3, d4, d5):
    """The WCS of one lag (degrees): CRVAL, CDELT and CROTA move by the lag;
    the PC matrix is rebuilt from (CROTA, CDELT) when a CDELT or CROTA lag is
    not zero, and kept as the header has it otherwise."""
    q = dict(p, crval1=p["crval1"] + d1, crval2=p["crval2"] + d2,
             cdelt1=p["cdelt1"] + d3, cdelt2=p["cdelt2"] + d4,
             crota=p["crota"] + d5)
    if d3 != 0.0 or d4 != 0.0 or d5 != 0.0:
        q["pc11"], q["pc12"], q["pc21"], q["pc22"] = pc_matrix(
            q["crota"], q["cdelt1"], q["cdelt2"])
    return q


def tan_pixel_to_world(p, x, y):
    """0-based pixels -> (lon, lat) in degrees."""
    q1 = x + 1.0 - p["crpix1"]
    q2 = y + 1.0 - p["crpix2"]
    u = p["cdelt1"] * (p["pc11"] * q1 + p["pc12"] * q2)
    v = p["cdelt2"] * (p["pc21"] * q1 + p["pc22"] * q2)
    r = torch.hypot(u, v)
    theta = torch.atan2(torch.full_like(r, 1.0 / RAD), r)
    phi = torch.atan2(u, -v)
    a0, d0 = p["crval1"] * RAD, p["crval2"] * RAD
    st, ct = torch.sin(theta), torch.cos(theta)
    dphi = phi - math.pi
    sd = st * math.sin(d0) + ct * math.cos(d0) * torch.cos(dphi)
    lat = torch.asin(torch.clamp(sd, -1.0, 1.0))
    lon = a0 + torch.atan2(-ct * torch.sin(dphi),
                           st * math.cos(d0) - ct * math.sin(d0)
                           * torch.cos(dphi))
    return lon / RAD, lat / RAD


def tan_world_to_pixel(p, lon, lat):
    """(lon, lat) in degrees -> 0-based pixels; NaN behind the horizon."""
    a0, d0 = p["crval1"] * RAD, p["crval2"] * RAD
    d = lat * RAD
    da = lon * RAD - a0
    sin_d, cos_d = torch.sin(d), torch.cos(d)
    cos_da = torch.cos(da)
    st = sin_d * math.sin(d0) + cos_d * math.cos(d0) * cos_da
    ok = st > 0
    den = torch.where(ok, st, torch.ones_like(st))
    u = (cos_d * torch.sin(da)) / den / RAD
    v = (sin_d * math.cos(d0) - cos_d * math.sin(d0) * cos_da) / den / RAD
    u = torch.where(ok, u, torch.full_like(u, math.nan)) / p["cdelt1"]
    v = torch.where(ok, v, torch.full_like(v, math.nan)) / p["cdelt2"]
    det = p["pc11"] * p["pc22"] - p["pc12"] * p["pc21"]
    q1 = (p["pc22"] * u - p["pc12"] * v) / det
    q2 = (-p["pc21"] * u + p["pc11"] * v) / det
    return q1 + p["crpix1"] - 1.0, q2 + p["crpix2"] - 1.0


# --------------------------------------------------------------------------
# the Carrington sphere
# --------------------------------------------------------------------------

def sphere_scalars(hdr, d_solar_r):
    """Observer and detector scalars of a header (CUNIT arcsec)."""
    return {"crval1": float(hdr["CRVAL1"]), "crval2": float(hdr["CRVAL2"]),
            "cdelt1": float(hdr["CDELT1"]), "cdelt2": float(hdr["CDELT2"]),
            "crpix1": float(hdr["CRPIX1"]), "crpix2": float(hdr["CRPIX2"]),
            "roll": float(hdr["CROTA"]),
            "dist": float(hdr["DSUN_OBS"]) / (d_solar_r * R_SUN_M),
            "obs_lon": float(hdr["CRLN_OBS"]), "obs_lat": float(hdr["CRLT_OBS"])}


def diff_rot(lat, dt_days, band):
    """Longitude drift against rigid Carrington rotation over dt_days."""
    a, b, c = DIFF_ROT.get(band, (CARRINGTON_RATE, 0.0, 0.0))
    s2 = torch.sin(lat * RAD) ** 2
    return dt_days * (a + s2 * (b + c * s2) - CARRINGTON_RATE)


def pixel_origin(sc):
    """Detector pixel (0-based) of the Sun-centre direction: CRPIX moved by
    the roll-rotated CRVAL (arcsec)."""
    r = sc["roll"] * RAD
    dx = math.cos(r) * sc["crval1"] + math.sin(r) * sc["crval2"]
    dy = -math.sin(r) * sc["crval1"] + math.cos(r) * sc["crval2"]
    return (sc["crpix1"] - 1.0) - dx / sc["cdelt1"], \
        (sc["crpix2"] - 1.0) - dy / sc["cdelt2"]


def sphere_to_detector(sc, lon, lat):
    """Carrington (lon, lat) on the sphere -> detector pixels of ``sc``;
    NaN on the far side."""
    lo = (lon - sc["obs_lon"]) * RAD
    la = lat * RAD
    x3 = torch.cos(la) * torch.sin(lo)
    y3 = torch.sin(la)
    z3 = torch.cos(la) * torch.cos(lo)
    ob = sc["obs_lat"] * RAD
    zz = z3 * math.cos(ob) + y3 * math.sin(ob)
    yy = y3 * math.cos(ob) - z3 * math.sin(ob)
    r = sc["roll"] * RAD
    y2 = yy * math.cos(r) - x3 * math.sin(r)
    x2 = x3 * math.cos(r) + yy * math.sin(r)
    z2 = sc["dist"] - zz
    x0, y0 = pixel_origin(sc)
    nx = x0 + torch.atan(x2 / z2) / RAD * 3600.0 / sc["cdelt1"]
    ny = y0 + torch.atan(y2 / z2) / RAD * 3600.0 / sc["cdelt2"]
    far = zz < 0
    nan = torch.full_like(nx, math.nan)
    return torch.where(far, nan, nx), torch.where(far, nan, ny)


def detector_to_sphere(sc, px, py):
    """Detector pixels -> Carrington (lon, lat) on the near side; NaN where
    the line of sight misses the sphere."""
    x0, y0 = pixel_origin(sc)
    a = torch.tan((px - x0) * sc["cdelt1"] / 3600.0 * RAD)
    b = torch.tan((py - y0) * sc["cdelt2"] / 3600.0 * RAD)
    dist = sc["dist"]
    aa = a * a + b * b + 1.0
    disc = 4.0 * dist * dist - 4.0 * aa * (dist * dist - 1.0)
    ok = disc >= 0
    z2 = (2.0 * dist - torch.sqrt(torch.where(ok, disc, torch.zeros_like(disc)))) / (2.0 * aa)
    z2 = torch.where(ok, z2, torch.full_like(z2, math.nan))
    x2, y2, zz = a * z2, b * z2, dist - z2
    r = sc["roll"] * RAD
    x3 = x2 * math.cos(r) - y2 * math.sin(r)
    yy = x2 * math.sin(r) + y2 * math.cos(r)
    ob = sc["obs_lat"] * RAD
    y3 = yy * math.cos(ob) + zz * math.sin(ob)
    z3 = zz * math.cos(ob) - yy * math.sin(ob)
    lat = torch.asin(torch.clamp(y3, -1.0, 1.0)) / RAD
    lon = torch.atan2(x3, z3) / RAD + sc["obs_lon"]
    return lon, lat


def carrington_grid(lonlims, latlims, shape, dtype, device):
    """(lon, lat) of the regular grid, inclusive limits, shape (ny, nx) with
    ``shape`` = (nx, ny)."""
    nx, ny = shape
    j = torch.arange(nx, dtype=dtype, device=device)
    i = torch.arange(ny, dtype=dtype, device=device)
    lon = lonlims[0] + j * ((lonlims[1] - lonlims[0]) / (nx - 1))
    lat = latlims[0] + i * ((latlims[1] - latlims[0]) / (ny - 1))
    return lon.expand(ny, nx), lat[:, None].expand(ny, nx)
