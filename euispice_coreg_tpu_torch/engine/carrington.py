"""Carrington-frame reprojection engine (torch).

Counterpart of ``euispice_coreg_tpu/engine/carrington.py``, the math of the
reference's transform framework (``euispice_coreg/utils/rectify.py``):

* the differential rotation of Carrington longitudes to a reference date
  (``DifferentialRotationTransform``, rectify.py:282-311);
* the projection of (lon, lat) on a sphere of radius ``d_solar_r * R_sun``
  into observer-frame detector pixels, with observer lon/lat, roll and
  far-side clipping (``SphericalTransform``, rectify.py:314-374), from FITS
  header scalars (``CarringtonTransform``, rectify.py:377-423);
* sampling an image on a regular lon/lat grid (``Rectifier``,
  rectify.py:842-888).

The geometry functions keep the JAX package's ``xp`` argument: ``xp=np`` is
the host float64 form, ``xp=torch`` the device form, which takes tensors for
every argument.  :func:`evaluate_lag_grid_carrington` scores the lag
hypercube on the Carrington grid and picks the path:

* ``"auto"``/``"fast"``: the per-combo FFT path on the pre-warped grid
  (:func:`_carrington_block_fast`, ``fast_corr``) when the conjugated CRVAL
  displacement is constant enough; else the quadratic-conjugation select
  path (:func:`_carrington_select`) scored by kernel K2
  (:mod:`.quad_score`); else the per-lag gather.  On a card, ``"auto"``
  tries the tile-FFT evaluator and its hybrid before K2, each plan only
  where the card's cost model promises that it beats K2;
* ``"pallas"``: the select path with K2 directly;
* ``"tile_fft"``: the select path on tile-FFT surfaces (:mod:`.tile_fft`)
  over the whole lag set, else the per-lag hybrid (tile-FFT on the lags
  that pass its gate), with K2 for every lag left;
* ``"exact"``: the per-lag gather engine.

Not ported: the XLA select evaluator with its residual buckets and caps
(the TPU's gather-free sampler; K2's plain version is its exact counterpart
here, and it takes the remainder that the JAX package's ``"tile_fft"``
sends there), the gather-free pre-warp sampler and the probe-fit and hybrid
caches.  ``mesh`` (a sequence of devices, :mod:`..utils.mesh`) is passed on
to every evaluator: K2 and the gather split the lags, tile-FFT the tiles,
the FFT path the surface planes; the pre-warp runs on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import resample, score, wcs
from ..core.header import get_crota
from ..utils import mesh as mesh_mod
from ..utils import timeutils, units
from ..utils.obs import Progress, logger, stage, timed
from ..utils.torchcfg import resolve_device, resolve_dtype, to_tensor
from . import fast_corr, lag_search, quad_score, tile_fft

R_SUN_M = 6.957e8  # IAU 2015 nominal solar radius, meters (astropy R_sun)
CARRINGTON_RATE = 14.18  # deg/day, rectify.py:292

# Hortin (2003) differential-rotation coefficients, deg/day
# (rectify.py:293-302)
DIFF_ROT_COEFFS = {
    "171": (14.56, -2.65, 0.96),
    "195": (14.50, -2.14, 0.66),
    "284": (14.60, -0.71, -1.18),
    "304": (14.51, -3.12, 0.34),
}

# wavelength -> rate band map (alignment.py:107-108)
RAT_WAVE = {"171": "171", "193": "195", "211": "195", "131": "171",
            "304": "304", "335": "304", "94": "171", "174": "171"}

# sidereal rotation rate of the Carrington frame, deg/day
SIDEREAL_CARRINGTON_RATE = 14.1844

# surface rotation models (A + B sin^2(lat) + C sin^4(lat), deg/day,
# sidereal) as used by sunpy's ``propagate_with_solar_surface`` (default
# 'howard', Howard et al. 1990), for the native equivalent of the
# reference's sunpy reprojection branch (alignment.py:939-985)
SURFACE_ROT_MODELS = {
    "howard": (14.713, -2.396, -1.787),
    "snodgrass": (14.71, -2.39, -1.78),
    "allen": (14.44, -3.0, 0.0),
    "rigid": (SIDEREAL_CARRINGTON_RATE, 0.0, 0.0),
}


def surface_rotation_drift_deg(lat_deg, delta_t_days, model="howard"):
    """Carrington-longitude drift of a solar-surface feature over
    ``delta_t_days`` (positive eastward), relative to the Carrington frame."""
    a, b, c = SURFACE_ROT_MODELS[model]
    siny2 = np.sin(np.radians(lat_deg)) ** 2
    rate = a + siny2 * (b + c * siny2)
    return (rate - SIDEREAL_CARRINGTON_RATE) * delta_t_days


def reproject_solar_surface(data, hdr_src, hdr_dst, *, d_solar_r=1.0,
                            order=2, rot_model="howard", device,
                            compute_dtype="float32"):
    """Reproject ``data`` (WCS ``hdr_src``) onto ``hdr_dst``'s pixel grid,
    assuming emission corotates with the differentially-rotating solar
    surface between the two observation times; float64 numpy out.

    Native equivalent of the reference's ``Map.reproject_to(wcs, ...)``
    under sunpy's ``propagate_with_solar_surface`` (alignment.py:939-985):
    each destination pixel's line of sight is intersected with the sphere of
    radius ``d_solar_r * R_sun``, the Carrington longitude is drifted by the
    surface rotation model over (t_src - t_dst), and the point is projected
    through the source observer's geometry.  The coordinates are host
    float64; the sampling runs on ``device``.  Off-sphere destination pixels
    are NaN.
    """
    sc_s = header_spherical_scalars(hdr_src, d_solar_r)
    sc_d = header_spherical_scalars(hdr_dst, d_solar_r)
    nx1 = int(hdr_dst.get("ZNAXIS1", hdr_dst.get("NAXIS1")))
    nx2 = int(hdr_dst.get("ZNAXIS2", hdr_dst.get("NAXIS2")))
    px, py = np.meshgrid(np.arange(nx1, dtype=np.float64),
                         np.arange(nx2, dtype=np.float64))
    lon_d, lat_d = spherical_unproject(px, py, sc_d)
    dt_days = timeutils.time_diff_days(str(hdr_src["DATE-OBS"]),
                                       str(hdr_dst["DATE-OBS"]))
    lon_s = lon_d + surface_rotation_drift_deg(lat_d, dt_days, rot_model)
    x3, yy, zz = observer_geometry(lon_s, lat_d, sc_s["obs_lon"],
                                   sc_s["obs_lat"])
    x0, y0 = _pixel_origin(sc_s["crval1_arcsec"], sc_s["crval2_arcsec"],
                           sc_s["crpix1"], sc_s["crpix2"], sc_s["roll"],
                           sc_s["cdelt1_arcsec"], sc_s["cdelt2_arcsec"], xp=np)
    sx, sy = spherical_project(x3, yy, zz, sc_s["dist"], sc_s["roll"], x0, y0,
                               sc_s["cdelt1_arcsec"], sc_s["cdelt2_arcsec"],
                               xp=np)
    return lag_search.resample_to_grid(data, sx, sy, order, device=device,
                                       compute_dtype=compute_dtype)


def diff_rot_shift_deg(lat_deg, delta_t_days, rate_wave: str | None, xp=np):
    """Longitude shift (deg) accumulated over ``delta_t_days`` relative to
    rigid Carrington rotation (rectify.py:304-311)."""
    coeffs = DIFF_ROT_COEFFS.get(rate_wave, (CARRINGTON_RATE, 0.0, 0.0))
    siny2 = xp.sin(lat_deg * wcs.RAD_PER_DEG) ** 2
    return delta_t_days * (
        coeffs[0] + siny2 * (coeffs[1] + coeffs[2] * siny2) - CARRINGTON_RATE
    )


def carrington_grid(lonlims, latlims, shape):
    """Regular lon/lat grid, inclusive endpoints (Rectifier, rectify.py:875-878).

    Returns (lon, lat) arrays of shape (shape[1], shape[0]): x varies along
    the last axis, matching meshgrid(indexing='xy')."""
    lon1d = np.linspace(lonlims[0], lonlims[1], shape[0], dtype=np.float64)
    lat1d = np.linspace(latlims[0], latlims[1], shape[1], dtype=np.float64)
    return np.meshgrid(lon1d, lat1d)


def observer_geometry(lon_rot_deg, lat_deg, obs_lon_deg, obs_lat_deg, xp=np):
    """Lag-independent part of SphericalTransform.forward (rectify.py:340-351).

    Returns (x3, yy, zz): unit-sphere coordinates in the observer frame
    before roll; ``zz`` is the line-of-sight depth used for z-clipping.
    """
    lon = (lon_rot_deg - obs_lon_deg) * wcs.RAD_PER_DEG
    lat = lat_deg * wcs.RAD_PER_DEG
    x3 = xp.cos(lat) * xp.sin(lon)
    y3 = xp.sin(lat)
    z3 = xp.cos(lat) * xp.cos(lon)
    obs_lat = obs_lat_deg * wcs.RAD_PER_DEG
    zz = z3 * xp.cos(obs_lat) + y3 * xp.sin(obs_lat)
    yy = y3 * xp.cos(obs_lat) - z3 * xp.sin(obs_lat)
    return x3, yy, zz


def spherical_project(x3, yy, zz, dist, roll_deg, x0, y0, cdelt1_arcsec,
                      cdelt2_arcsec, zclip=0.0, xp=torch):
    """Per-lag tail of SphericalTransform.forward (rectify.py:352-374).

    ``dist`` is DSUN_OBS / (radius_correction * R_sun).  Far-side points
    (zz < zclip) map to NaN, reproducing the reference's gd mask.
    """
    roll = roll_deg * wcs.RAD_PER_DEG
    cos_r, sin_r = xp.cos(roll), xp.sin(roll)
    y2 = yy * cos_r - x3 * sin_r
    x2 = x3 * cos_r + yy * sin_r
    z2 = dist - zz
    nx = x0 + xp.arctan(x2 / z2) * wcs.DEG_PER_RAD * 3600.0 / cdelt1_arcsec
    ny = y0 + xp.arctan(y2 / z2) * wcs.DEG_PER_RAD * 3600.0 / cdelt2_arcsec
    good = zz >= zclip
    return xp.where(good, nx, np.nan), xp.where(good, ny, np.nan)


def header_spherical_scalars(hdr, d_solar_r=1.0):
    """CarringtonTransform's header-derived scalars (rectify.py:387-415).

    CRVAL/CDELT are converted to arcsec from CUNIT.  Returns a dict of plain
    floats; the per-lag engine perturbs crval/cdelt/roll on the device.
    """
    cunit1 = hdr.get("CUNIT1", "arcsec")
    cunit2 = hdr.get("CUNIT2", "arcsec")
    return {
        "crval1_arcsec": units.convert(float(hdr["CRVAL1"]), cunit1, "arcsec"),
        "crval2_arcsec": units.convert(float(hdr["CRVAL2"]), cunit2, "arcsec"),
        "cdelt1_arcsec": units.convert(float(hdr["CDELT1"]), cunit1, "arcsec"),
        "cdelt2_arcsec": units.convert(float(hdr["CDELT2"]), cunit2, "arcsec"),
        "crpix1": float(hdr["CRPIX1"]),
        "crpix2": float(hdr["CRPIX2"]),
        "roll": get_crota(hdr),
        "dist": float(hdr["DSUN_OBS"]) / (d_solar_r * R_SUN_M),
        "obs_lon": float(hdr["CRLN_OBS"]),
        "obs_lat": float(hdr["CRLT_OBS"]),
    }


def _pixel_origin(crval1, crval2, crpix1, crpix2, roll_deg, cdelt1, cdelt2,
                  xp=torch):
    """x0/y0 of SphericalTransform: CRPIX shifted by the roll-rotated CRVAL
    (rectify.py:396-404).  All linear quantities in arcsec."""
    roll = roll_deg * wcs.RAD_PER_DEG
    cos_r, sin_r = xp.cos(roll), xp.sin(roll)
    dx = cos_r * crval1 + sin_r * crval2
    dy = -sin_r * crval1 + cos_r * crval2
    return (crpix1 - 1.0) - dx / cdelt1, (crpix2 - 1.0) - dy / cdelt2


def spherical_unproject(px, py, sc: dict):
    """Inverse of the spherical projection: detector pixels -> Carrington
    (lon, lat) in degrees on the near side of the sphere (host float64).

    Not present in the reference (rectify.py's SphericalTransform implements
    only the forward direction); used for synthetic-scene generation, the
    solar-surface reprojection and sanity checks.  ``sc`` comes from
    :func:`header_spherical_scalars`.  Pixels whose ray misses the sphere
    return NaN.
    """
    x0, y0 = _pixel_origin(sc["crval1_arcsec"], sc["crval2_arcsec"],
                           sc["crpix1"], sc["crpix2"], sc["roll"],
                           sc["cdelt1_arcsec"], sc["cdelt2_arcsec"], xp=np)
    ax = np.radians((np.asarray(px, dtype=np.float64) - x0) * sc["cdelt1_arcsec"] / 3600.0)
    ay = np.radians((np.asarray(py, dtype=np.float64) - y0) * sc["cdelt2_arcsec"] / 3600.0)
    a = np.tan(ax)
    b = np.tan(ay)
    dist = sc["dist"]
    # ray: (x2, y2, zz) = (a z2, b z2, dist - z2) on the unit sphere
    A = a * a + b * b + 1.0
    B = -2.0 * dist
    C = dist * dist - 1.0
    disc = B * B - 4 * A * C
    ok = disc >= 0
    z2 = np.where(ok, (-B - np.sqrt(np.where(ok, disc, 0.0))) / (2 * A), np.nan)
    x2, y2, zz = a * z2, b * z2, dist - z2
    roll = np.radians(sc["roll"])
    cos_r, sin_r = np.cos(roll), np.sin(roll)
    x3 = x2 * cos_r - y2 * sin_r
    yy = x2 * sin_r + y2 * cos_r
    obs_lat = np.radians(sc["obs_lat"])
    y3 = yy * np.cos(obs_lat) + zz * np.sin(obs_lat)
    z3 = zz * np.cos(obs_lat) - yy * np.sin(obs_lat)
    lat = np.degrees(np.arcsin(np.clip(y3, -1.0, 1.0)))
    lon = np.degrees(np.arctan2(x3, z3)) + sc["obs_lon"]
    return lon, lat


def reproject_to_carrington(data, hdr, lonlims, latlims, shape, *,
                            d_solar_r=1.0, reference_date=None,
                            rate_wave=None, order=2, device,
                            compute_dtype="float32", as_numpy=True):
    """One-shot Carrington reprojection of an image (the reference-image leg,
    ``alignment.py:889-901``: CarringtonTransform + Rectifier, fill -> NaN).

    Returns a host float64 copy, or with ``as_numpy=False`` the tensor on
    ``device`` (the lag search consumes the grid there)."""
    sc = header_spherical_scalars(hdr, d_solar_r)
    delta_t = 0.0
    if reference_date is not None:
        delta_t = timeutils.time_diff_days(str(hdr["DATE-OBS"]),
                                           str(reference_date))
    out = warp_to_grid(
        to_tensor(data, device=resolve_device(device),
                  dtype=resolve_dtype(compute_dtype)),
        sc, lonlims, latlims, shape, delta_t, rate_wave, order)
    if not as_numpy:
        return out
    return out.to(torch.float64).cpu().numpy()


def warp_to_grid(small_d, combo, lonlims, latlims, shape, delta_t,
                 rate_wave, order):
    """Warp the detector image ``small_d`` (a tensor) onto the Carrington
    grid for one (cdelt, crota) combo, on its device and in its dtype: the
    grid from ``torch.arange``, the differential rotation, the observer
    geometry, the spherical projection and ``sample_image``, with no
    coordinate field computed on the host.  (The JAX ``_grid_coords_jit``
    and ``_warp_to_grid_jit``; the combo scalars are cast to the image's
    dtype as there.)"""
    dt, dev = small_d.dtype, small_d.device
    x0, y0 = _pixel_origin(combo["crval1_arcsec"], combo["crval2_arcsec"],
                           combo["crpix1"], combo["crpix2"], combo["roll"],
                           combo["cdelt1_arcsec"], combo["cdelt2_arcsec"],
                           xp=np)

    def s(v):
        return torch.tensor(float(v), dtype=dt, device=dev)

    h, w = shape[1], shape[0]
    j = torch.arange(w, dtype=dt, device=dev).expand(h, w)
    i = torch.arange(h, dtype=dt, device=dev)[:, None].expand(h, w)
    lon = s(lonlims[0]) + j * s((lonlims[1] - lonlims[0]) / (shape[0] - 1))
    lat = s(latlims[0]) + i * s((latlims[1] - latlims[0]) / (shape[1] - 1))
    lon_rot = lon - diff_rot_shift_deg(lat, s(delta_t), rate_wave, xp=torch)
    x3, yy, zz = observer_geometry(lon_rot, lat, s(combo["obs_lon"]),
                                   s(combo["obs_lat"]), xp=torch)
    nx, ny = spherical_project(x3, yy, zz, s(combo["dist"]), s(combo["roll"]),
                               s(x0), s(y0), s(combo["cdelt1_arcsec"]),
                               s(combo["cdelt2_arcsec"]))
    return resample.sample_image(small_d, nx, ny, order=order)


def _combo(sc, d3, d4, d5):
    """Header scalars of one (cdelt1, cdelt2, crota) lag combo (degrees)."""
    combo = dict(sc)
    combo["cdelt1_arcsec"] = sc["cdelt1_arcsec"] + d3 * 3600.0
    combo["cdelt2_arcsec"] = sc["cdelt2_arcsec"] + d4 * 3600.0
    combo["roll"] = sc["roll"] + d5
    return combo


def _probe_projection(combo, lon_p, lat_p, delta_t, rate_wave):
    """Exact float64 host projection at probe points only (feeds the
    conjugation fits; the full-grid version runs in :func:`warp_to_grid`)."""
    lon_rot_p = lon_p - diff_rot_shift_deg(lat_p, delta_t, rate_wave)
    x3p, yyp, zzp = observer_geometry(lon_rot_p, lat_p, combo["obs_lon"],
                                      combo["obs_lat"])
    x0, y0 = _pixel_origin(combo["crval1_arcsec"], combo["crval2_arcsec"],
                           combo["crpix1"], combo["crpix2"], combo["roll"],
                           combo["cdelt1_arcsec"], combo["cdelt2_arcsec"],
                           xp=np)
    return spherical_project(x3p, yyp, zzp, combo["dist"], combo["roll"],
                             x0, y0, combo["cdelt1_arcsec"],
                             combo["cdelt2_arcsec"], xp=np)


def _probe_fit(nx0p, ny0p, csx, csy, scal, delta_t, pinv, design, pxf, pyf,
               rate_wave):
    """Per-lag probe conjugation + quadratic fit for all lags at once, in
    the tensors' dtype and on their device (float64 here).

    Mirrors the host pipeline unproject -> differential rotation -> grid
    mapping -> least-squares fit (see :func:`spherical_unproject`).  The
    absolute Carrington longitude (~120 deg) is never formed:
    ``scal["lon_shift"]`` carries ``obs_lon - lonlims[0]``, reduced on the
    host, so the arctan2 output stays a small angle.

    Returns (coeffs (L, 6, 2), fit_err (), ok ()) as tensors."""
    px = nx0p[None, :] + csx[:, None]                        # (L, P)
    py = ny0p[None, :] + csy[:, None]
    ok = torch.isfinite(px).all() & torch.isfinite(py).all()

    ax = (px - scal["x0"]) * scal["ax_scale"]                # radians
    ay = (py - scal["y0"]) * scal["ay_scale"]
    a = torch.tan(ax)
    b = torch.tan(ay)
    dist = scal["dist"]
    # ray-sphere intersection in a cancellation-stable form: the naive
    # B^2 - 4AC differences two ~4*dist^2 values.  Algebraically
    # disc/4 = 1 - r^2 (dist^2 - 1) with r^2 = a^2 + b^2, and zz = dist - z2
    # is computed directly as (dist r^2 + sqrt(disc/4)) / A; dist^2 - 1
    # arrives reduced from the host (scal["dist2m1"]).
    r2 = a * a + b * b
    A = r2 + 1.0
    disc4 = 1.0 - r2 * scal["dist2m1"]
    okd = disc4 >= 0
    s = torch.sqrt(torch.where(okd, disc4, 0.0))
    z2 = torch.where(okd, (dist - s) / A, np.nan)
    zz = torch.where(okd, (dist * r2 + s) / A, np.nan)
    x2, y2 = a * z2, b * z2
    x3 = x2 * scal["cos_r"] - y2 * scal["sin_r"]
    yy = x2 * scal["sin_r"] + y2 * scal["cos_r"]
    y3 = yy * scal["cos_obslat"] + zz * scal["sin_obslat"]
    z3 = zz * scal["cos_obslat"] - yy * scal["sin_obslat"]
    lat = torch.rad2deg(torch.arcsin(torch.clamp(y3, -1.0, 1.0)))
    lon_rel = torch.rad2deg(torch.atan2(x3, z3)) + scal["lon_shift"]
    lon_rel = lon_rel + diff_rot_shift_deg(lat, delta_t, rate_wave, xp=torch)
    gx = lon_rel * scal["inv_dlon"]
    gy = (lat - scal["lat0"]) * scal["inv_dlat"]
    c_exact = torch.stack([gx - pxf[None, :], gy - pyf[None, :]],
                          dim=-1)                            # (L, P, 2)
    ok = ok & torch.isfinite(c_exact).all()

    coeffs = torch.einsum("pq,lqk->lpk", pinv, c_exact)      # (L, 6, 2)
    fit = torch.einsum("qp,lpk->lqk", design, coeffs)
    fit_err = torch.max(torch.abs(fit - c_exact))
    return coeffs, fit_err, ok


def _probe_scale_det_per_grid(nx0p, ny0p, pxf, pyf, probe_shape):
    """Max |d(detector px)/d(grid px)| from the probe projection: converts
    grid-pixel fit residuals into detector-pixel sampling error (the grid
    typically oversamples the detector, so grid-pixel deviations overstate
    the error).

    ``probe_shape`` is (n_rows, n_cols) of the probe grid, not necessarily
    square (np.unique collapses degenerate axes on thin grids)."""
    nx = nx0p.reshape(probe_shape)
    ny = ny0p.reshape(probe_shape)
    gx = pxf.reshape(probe_shape)
    gy = pyf.reshape(probe_shape)
    with np.errstate(invalid="ignore", divide="ignore"):
        grads = [
            np.abs(np.diff(nx, axis=1) / np.diff(gx, axis=1)),
            np.abs(np.diff(ny, axis=1) / np.diff(gx, axis=1)),
            np.abs(np.diff(nx, axis=0) / np.diff(gy, axis=0)),
            np.abs(np.diff(ny, axis=0) / np.diff(gy, axis=0)),
        ]
    vals = np.concatenate([g.ravel() for g in grads])
    vals = vals[np.isfinite(vals)]
    if vals.size == 0:
        return np.inf
    return 1.5 * float(vals.max())  # 1.5: curvature safety margin


def probe_design(shape):
    """The select path's 4x4 probe grid and its quadratic least-squares
    design, as a dict: ``pxf``/``pyf`` the probe pixels (float64, grid
    indices), ``probe_shape`` (rows, cols), ``design`` (P, 6) and its
    pseudo-inverse ``pinv`` (6, P) for the basis [X, Y, 1, X^2, Y^2, XY] on
    NORMALIZED coordinates X = px/(w-1), Y = py/(h-1) (O(1) terms, a
    well-conditioned fit), and ``coeff_rescale`` (6,), which takes the
    fitted coefficients back to pixel units exactly (per-term power of the
    scale)."""
    h, w = shape[1], shape[0]
    ppy = np.unique(np.linspace(0, h - 1, 4).astype(np.int64))
    ppx = np.unique(np.linspace(0, w - 1, 4).astype(np.int64))
    pyg, pxg = np.meshgrid(ppy, ppx, indexing="ij")
    pyf = pyg.ravel().astype(np.float64)
    pxf = pxg.ravel().astype(np.float64)
    sxn = float(max(w - 1, 1))
    syn = float(max(h - 1, 1))
    pxs, pys = pxf / sxn, pyf / syn
    design = np.stack([pxs, pys, np.ones_like(pxs),
                       pxs * pxs, pys * pys, pxs * pys], axis=-1)
    return {
        "pxf": pxf, "pyf": pyf, "probe_shape": (len(ppy), len(ppx)),
        "design": design, "pinv": np.linalg.pinv(design),
        "coeff_rescale": np.array([1.0 / sxn, 1.0 / syn, 1.0,
                                   1.0 / (sxn * sxn), 1.0 / (syn * syn),
                                   1.0 / (sxn * syn)]),
    }


def _probe_fit_products(combo, lonlims, latlims, dc1, dc2, delta_t,
                        rate_wave, dlon_step, dlat_step, design, *, device):
    """Per-combo probe fit: exact float64 probe conjugation and per-lag
    quadratic fit (:func:`_probe_fit`, float64 on ``device``), reduced to
    the host products the select path needs.  ``design`` is
    :func:`probe_design`'s dict.

    Returns ``(ok, coeffs, fit_err, scale)``:
      ok       False when a probe conjugation is non-finite (off-disk lag)
      coeffs   (L, 6, 2) float64 quadratic displacement maps in PIXEL units
      fit_err  max fit residual in grid px
      scale    detector px per grid px at the probes

    ``scale`` exists because the fit residual displaces sampling positions
    on the grid, so its accuracy cost is in DETECTOR pixels.  On a strongly
    oversampled grid a raw grid-px gate would be ~10x over-strict.
    """
    pxf, pyf = design["pxf"], design["pyf"]
    nx0p, ny0p = _probe_projection(
        combo, lonlims[0] + pxf * dlon_step,
        latlims[0] + pyf * dlat_step, delta_t, rate_wave)

    # constant per-lag displacement in DETECTOR pixels
    roll_r = np.radians(combo["roll"])
    cos_r, sin_r = np.cos(roll_r), np.sin(roll_r)
    csx = -(cos_r * dc1 + sin_r * dc2) / combo["cdelt1_arcsec"]
    csy = -(-sin_r * dc1 + cos_r * dc2) / combo["cdelt2_arcsec"]

    x0c, y0c = _pixel_origin(
        combo["crval1_arcsec"], combo["crval2_arcsec"],
        combo["crpix1"], combo["crpix2"], combo["roll"],
        combo["cdelt1_arcsec"], combo["cdelt2_arcsec"], xp=np)
    obs_lat_r = np.radians(combo["obs_lat"])

    def t(v):
        return torch.as_tensor(v, dtype=torch.float64, device=device)

    scal = {k: t(v) for k, v in {
        "x0": x0c, "y0": y0c,
        "ax_scale": np.radians(combo["cdelt1_arcsec"] / 3600.0),
        "ay_scale": np.radians(combo["cdelt2_arcsec"] / 3600.0),
        "dist": combo["dist"],
        "dist2m1": combo["dist"] * combo["dist"] - 1.0,
        "cos_r": cos_r, "sin_r": sin_r,
        "cos_obslat": np.cos(obs_lat_r),
        "sin_obslat": np.sin(obs_lat_r),
        "lon_shift": combo["obs_lon"] - lonlims[0],
        "lat0": latlims[0],
        "inv_dlon": 1.0 / dlon_step,
        "inv_dlat": 1.0 / dlat_step,
    }.items()}
    coeffs_t, fit_err_t, ok_t = _probe_fit(
        t(nx0p), t(ny0p), t(csx), t(csy), scal, t(delta_t),
        t(design["pinv"]), t(design["design"]), t(pxf), t(pyf), rate_wave)
    if not bool(ok_t):
        return False, None, None, None
    # scaled-basis coefficients -> pixel units (exact, float64)
    coeffs = coeffs_t.cpu().numpy() * design["coeff_rescale"][None, :, None]
    scale = _probe_scale_det_per_grid(nx0p, ny0p, pxf, pyf,
                                      design["probe_shape"])
    return True, coeffs, float(fit_err_t), scale


def _carrington_select(small_img, ref_img, sc, delta_t, rate_wave,
                       lonlims, latlims, shape, l1, l2, l3, l4, l5, *,
                       order, method, device, compute_dtype, tol_px=0.05,
                       tile_fft_mode=None, mesh=None):
    """Quadratic-conjugation select path for curved Carrington grids (where
    the FFT path's constant-displacement bound fails).

    Per (cdelt, crota) combo: warp the detector image onto the grid once;
    the per-lag CRVAL displacement, exactly constant in DETECTOR pixels,
    maps into grid space through the spherical projection's inverse.  That
    conjugated field is fitted per lag with a quadratic map over a 4x4 grid
    of exact probe conjugations; the fit residual gates the path (None, so
    the caller falls back to the per-lag gather, when it exceeds ``tol_px``
    detector pixels).  With a ``tile_fft_mode`` (:func:`_tile_fft_mode`)
    the lags are scored on tile-FFT surfaces
    (:func:`tile_fft.evaluate_select_tile_fft`) over the whole set, else,
    where that declines, on the lags that pass the gate one by one
    (:func:`tile_fft.pick_tile_shape_hybrid`).  Every lag left is scored by
    K2 on the pre-warped image (double interpolation, like the
    helioprojective block fast path).  Returns the (n1..n5) hypercube, or
    None.
    """
    if method not in quad_score.METHODS:
        return None
    dev = resolve_device(device)
    dt = resolve_dtype(compute_dtype)
    h, w = shape[1], shape[0]
    design = probe_design(shape)
    dlon_step = (lonlims[1] - lonlims[0]) / (shape[0] - 1)
    dlat_step = (latlims[1] - latlims[0]) / (shape[1] - 1)

    g1, g2 = np.meshgrid(l1, l2, indexing="ij")
    dc1 = g1.ravel() * 3600.0
    dc2 = g2.ravel() * 3600.0
    L = dc1.size

    out = np.zeros((len(l1), len(l2), len(l3), len(l4), len(l5)))
    small_d = to_tensor(small_img, device=dev, dtype=dt)
    ref_d = to_tensor(ref_img, device=dev, dtype=dt)
    for i3, d3 in enumerate(l3):
        for i4, d4 in enumerate(l4):
            for i5, d5 in enumerate(l5):
                combo = _combo(sc, d3, d4, d5)
                with stage("carr_probe_fit_s"):
                    ok, coeffs, fit_err, scale = _probe_fit_products(
                        combo, lonlims, latlims, dc1, dc2, delta_t,
                        rate_wave, dlon_step, dlat_step, design,
                        device=dev)
                if not ok:
                    logger.info("carrington select gate: non-finite probe "
                                "conjugation (off-disk lag)")
                    return None
                # fit residual gate in DETECTOR pixels (see
                # _probe_fit_products for the scale rationale)
                tol_grid = min(tol_px / max(scale, 1e-9), 4.0)
                if fit_err > tol_grid:
                    logger.info("carrington select gate: quadratic fit "
                                "residual %.4f grid px > %.4f (%.3f det px)",
                                fit_err, tol_grid, fit_err * scale)
                    return None

                with timed("carrington pre-warp (small -> grid)"):
                    warped_d = warp_to_grid(small_d, combo, lonlims, latlims,
                                            shape, delta_t, rate_wave, order)
                vals = np.zeros(L)
                rem = np.arange(L)  # lags still to score
                if tile_fft_mode is not None:
                    rem = _select_tile_fft(coeffs, warped_d, ref_d, vals,
                                           order=order, method=method, h=h,
                                           w=w, scale=scale, device=dev,
                                           compute_dtype=dt,
                                           vs_k2=tile_fft_mode == "vs_k2",
                                           mesh=mesh)
                if rem.size:
                    with timed("carrington K2 select evaluation"):
                        vals_k = quad_score.evaluate_select_quad(
                            coeffs[rem], warped_d, ref_d, order=order,
                            method=method, device=dev, compute_dtype=dt,
                            mesh=mesh)
                    if vals_k is None:
                        return None
                    logger.info("carrington select: K2 quad kernel (%d "
                                "lags)", rem.size)
                    vals[rem] = vals_k
                out[:, :, i3, i4, i5] = vals.reshape(len(l1), len(l2))
    return out


def _tile_fft_mode(lag_mode, device):
    """How the select path uses tile-FFT: None (K2 only), ``"always"`` (an
    explicit ``"tile_fft"``: the JAX package's gates) or ``"vs_k2"``
    (``"auto"`` on a card: a plan must also promise to beat K2 on the same
    lags, by the card's cost model of :mod:`.tile_fft`)."""
    if lag_mode == "tile_fft":
        return "always"
    if lag_mode == "auto" and device.type == "cuda":
        return "vs_k2"
    return None


def _select_tile_fft(coeffs, warped_d, ref_d, vals, *, order, method, h, w,
                     scale, device, compute_dtype, vs_k2=False, mesh=None):
    """The tile-FFT leg of the select path for one combo: the whole lag set
    on tile-FFT surfaces, else the per-lag hybrid (the within-tile
    deviation grows about linearly with |lag|, so the inner lags usually
    pass the gate when the whole set fails).  With ``vs_k2`` both are held
    to the card's cost model against K2 (:func:`tile_fft.plan_tiles`): no
    gate runs where K2's estimate is under what tile-FFT spends around its
    transforms, and no hybrid where the whole set passed the gate (its
    shapes would then admit nearly every lag at about the cost of the plan
    just declined).  Writes the scores it computes into ``vals`` and
    returns the indices of the lags left for K2."""
    L = coeffs.shape[0]
    if vs_k2 and tile_fft.k2_is_cheaper(L, h, w):
        logger.info("tile-FFT skipped: K2 est %.4f s for %d lags <= the "
                    "%.3f s tile-FFT spends around its transforms",
                    tile_fft._est_k2_seconds(L, h, w), L,
                    tile_fft._EST_SELECT_OVERHEAD_S)
        return np.arange(L)
    with timed("carrington tile-FFT select evaluation"):
        with stage("carr_tilefft_gate_s"):
            pick = tile_fft.pick_tile_shape(coeffs, h, w, scale)
        vals_t = None if pick is None else tile_fft.evaluate_select_tile_fft(
            coeffs, warped_d, ref_d, order=order, h=h, w=w, method=method,
            scale_det_per_grid=scale, compute_dtype=compute_dtype,
            tile_size=pick[0], vs_k2=vs_k2, device=device, mesh=mesh)
    if vals_t is not None:
        logger.info("carrington select: tile-FFT surfaces (%d lags)", L)
        vals[:] = vals_t
        return np.arange(0)
    if vs_k2 and pick is not None:
        logger.info("carrington tile-FFT: the whole set passed the gate and "
                    "was declined against K2, no hybrid")
        return np.arange(L)
    with stage("carr_tilefft_hybrid_pick_s"):
        hyb = tile_fft.pick_tile_shape_hybrid(coeffs, h, w, scale,
                                              order_hint=order,
                                              compute_dtype=compute_dtype,
                                              vs_k2=vs_k2, mesh=mesh)
    if hyb is not None:
        (th, tw), mask = hyb
        with timed("carrington hybrid tile-FFT evaluation"):
            vals_h = tile_fft.evaluate_select_tile_fft(
                coeffs[mask], warped_d, ref_d, order=order, h=h, w=w,
                method=method, compute_dtype=compute_dtype,
                tile_size=(th, tw), device=device, mesh=mesh)
        if vals_h is not None:
            vals[mask] = vals_h
            rem = np.nonzero(~mask)[0]
            logger.info("carrington select: hybrid tile-FFT (%d lags, shape "
                        "(%d, %d)) + K2 (%d lags)", L - rem.size, th, tw,
                        rem.size)
            return rem
    logger.info("carrington tile-FFT gate failed, trying K2")
    return np.arange(L)


def _carrington_block_fast(small_img, ref_img, sc, delta_t, rate_wave,
                           lonlims, latlims, shape, l1, l2, l3, l4, l5, *,
                           order, method, device, compute_dtype, mesh=None):
    """FFT fast path in the Carrington frame.

    For each (cdelt1, cdelt2, crota) combo the small image is warped onto
    the Carrington grid once; CRVAL lags then displace the detector sampling
    by an exactly constant vector in small-pixel space (x0/y0 are linear in
    CRVAL, rectify.py:396-404), which is conjugated into grid space through
    the spherical map and its inverse.  Returns None (the caller falls back)
    when the conjugated displacement is not constant within the fast-path
    bound (strongly curved grids).
    """
    dev = resolve_device(device)
    dt = resolve_dtype(compute_dtype)
    h, w = shape[1], shape[0]
    pr = np.array([(h // 2, w // 2), (0, 0), (0, w - 1), (h - 1, 0),
                   (h - 1, w - 1)])
    dlon_step = (lonlims[1] - lonlims[0]) / (shape[0] - 1)
    dlat_step = (latlims[1] - latlims[0]) / (shape[1] - 1)

    out = np.zeros((len(l1), len(l2), len(l3), len(l4), len(l5)))
    g1, g2 = np.meshgrid(l1, l2, indexing="ij")
    dc1 = g1.ravel() * 3600.0  # arcsec
    dc2 = g2.ravel() * 3600.0

    small_d = to_tensor(small_img, device=dev, dtype=dt)
    for i3, d3 in enumerate(l3):
        for i4, d4 in enumerate(l4):
            for i5, d5 in enumerate(l5):
                combo = _combo(sc, d3, d4, d5)

                # exact float64 projection at the 5 probe points only
                nx0p, ny0p = _probe_projection(
                    combo, lonlims[0] + pr[:, 1] * dlon_step,
                    latlims[0] + pr[:, 0] * dlat_step, delta_t, rate_wave)

                # exact constant displacement in small-pixel space per lag
                roll_r = np.radians(combo["roll"])
                cos_r, sin_r = np.cos(roll_r), np.sin(roll_r)
                csx = -(cos_r * dc1 + sin_r * dc2) / combo["cdelt1_arcsec"]
                csy = -(-sin_r * dc1 + cos_r * dc2) / combo["cdelt2_arcsec"]

                # conjugate to grid space at the probe points
                px = nx0p[None, :] + csx[:, None]  # (L, 5)
                py = ny0p[None, :] + csy[:, None]
                if not np.isfinite(px).all():
                    return None
                lon_r2, lat2 = spherical_unproject(px, py, combo)
                # undo the differential rotation at the unprojected latitude
                lon2 = lon_r2 + diff_rot_shift_deg(lat2, delta_t, rate_wave)
                gx = (lon2 - lonlims[0]) / dlon_step
                gy = (lat2 - latlims[0]) / dlat_step
                c = np.stack([gx - pr[:, 1][None, :],
                              gy - pr[:, 0][None, :]], axis=-1)  # (L, 5, 2)
                center = c[:, 0, :]
                spread = float(np.max(np.abs(c - center[:, None, :])))
                # bail before paying for the warp
                if spread > fast_corr.MAX_DISPLACEMENT_SPREAD_PX:
                    return None

                warped_d = warp_to_grid(small_d, combo, lonlims, latlims,
                                        shape, delta_t, rate_wave, order)
                r = fast_corr.evaluate_from_displacements(
                    warped_d, ref_img, center, spread, order=order,
                    device=dev, compute_dtype=dt, method=method, mesh=mesh)
                if r is None:
                    return None
                out[:, :, i3, i4, i5] = r.reshape(len(l1), len(l2))
    return out


def _score_lags_carr(d, small_img, ref_img, geom, base, order, method):
    """Scores of a batch of lags ``d`` ((B, 5) tensor, DEGREES, the
    lag_search layout) by the exact single-interpolation warp."""
    def col(k):
        return d[:, k, None, None]

    crval1 = base["crval1_arcsec"] + col(lag_search.D_CRVAL1) * 3600.0
    crval2 = base["crval2_arcsec"] + col(lag_search.D_CRVAL2) * 3600.0
    cdelt1 = base["cdelt1_arcsec"] + col(lag_search.D_CDELT1) * 3600.0
    cdelt2 = base["cdelt2_arcsec"] + col(lag_search.D_CDELT2) * 3600.0
    roll = base["roll"] + col(lag_search.D_CROTA)
    x0, y0 = _pixel_origin(crval1, crval2, base["crpix1"], base["crpix2"],
                           roll, cdelt1, cdelt2)
    nx, ny = spherical_project(geom["x3"], geom["yy"], geom["zz"],
                               base["dist"], roll, x0, y0, cdelt1, cdelt2)
    sampled = resample.sample_image(small_img, nx, ny, order=order)
    return score.SCORE_FUNCTIONS[method](ref_img, sampled)


def _evaluate_flat_carr(lags, small_img, ref_img, geom, base, order, method,
                        batch_size, devices):
    """Per-lag gather engine, ``batch_size`` lags at a time, the lags
    ((L, 5) host array) split over ``devices`` with every operand
    replicated (the JAX ``shard_map`` over lags); (L,) float64 numpy out."""
    n_lags = lags.shape[0]
    dt = small_img.dtype
    ranges = mesh_mod.split(n_lags, devices)
    smalls = mesh_mod.replicate(small_img, devices)
    refs = mesh_mod.replicate(ref_img, devices)
    geoms = [dict(zip(geom, g)) for g in zip(
        *(mesh_mod.replicate(v, devices) for v in geom.values()))]
    bases = [dict(zip(base, b)) for b in zip(
        *(mesh_mod.replicate(v, devices) for v in base.values()))]
    lags_d = [torch.as_tensor(lags[a:b], dtype=dt, device=d)
              for (a, b), d in zip(ranges, devices)]
    parts = {}
    prog = Progress(total=n_lags, label="carrington gather lag search",
                    enabled=n_lags > batch_size)
    for k, s, e in mesh_mod.round_robin(ranges, batch_size):
        d = lags_d[k][s - ranges[k][0]:e - ranges[k][0]]
        parts[s] = _score_lags_carr(d, smalls[k], refs[k], geoms[k],
                                    bases[k], order,
                                    method).to(torch.float64)
        prog.step(e - s)
    return mesh_mod.gather(parts).numpy()


def evaluate_lag_grid_carrington(
    small_img,
    ref_img,
    hdr_small,
    lonlims,
    latlims,
    shape,
    lag_crval1_deg,
    lag_crval2_deg,
    lag_cdelt1_deg,
    lag_cdelt2_deg,
    lag_crota_deg,
    *,
    d_solar_r=1.004,
    reference_date=None,
    rate_wave=None,
    order=2,
    method="correlation",
    device,
    compute_dtype="float32",
    batch_size=8,
    lag_mode="auto",
    mesh=None,
):
    """Score the lag hypercube in the Carrington frame; returns
    (n1, n2, n3, n4, n5) float64 numpy.

    ``ref_img`` must already be on the Carrington grid (see
    :func:`reproject_to_carrington`).  ``lag_mode`` mirrors
    ``Alignment(lag_search_mode=...)``: ``"exact"`` forces the per-lag
    gather engine, ``"pallas"`` goes straight to the select path with K2,
    ``"tile_fft"`` to the select path on tile-FFT surfaces, the hybrid and
    K2 for the rest; ``"auto"``/``"fast"`` try the per-combo FFT path
    first, then the select path (``"auto"`` on a card with tile-FFT first,
    :func:`_tile_fft_mode`; never on the CPU), then the gather.  ``mesh``:
    a sequence of devices every evaluator splits its work over (None:
    ``device`` alone)."""
    dev = resolve_device(device)
    dt = resolve_dtype(compute_dtype)
    devices = mesh_mod.resolve_mesh(mesh)

    sc = header_spherical_scalars(hdr_small, d_solar_r)
    delta_t = 0.0
    if reference_date is not None:
        delta_t = timeutils.time_diff_days(str(hdr_small["DATE-OBS"]),
                                           str(reference_date))

    l1, l2, l3, l4, l5 = (np.asarray(v, dtype=np.float64) for v in (
        lag_crval1_deg, lag_crval2_deg, lag_cdelt1_deg, lag_cdelt2_deg,
        lag_crota_deg))
    out_shape = (len(l1), len(l2), len(l3), len(l4), len(l5))
    common = dict(delta_t=delta_t, rate_wave=rate_wave, lonlims=lonlims,
                  latlims=latlims, shape=shape, l1=l1, l2=l2, l3=l3, l4=l4,
                  l5=l5, order=order, method=method, device=dev,
                  compute_dtype=dt, mesh=devices)

    if (lag_mode in ("auto", "fast") and order in (0, 2)
            and method in ("correlation", "residus_masked")):
        fast = _carrington_block_fast(small_img, ref_img, sc, **common)
        if fast is not None:
            logger.info("engine path: carrington FFT fast")
            return fast
        logger.info("carrington FFT fast preconditions failed, trying "
                    "linearized select path")

    if lag_mode != "exact" and order in (0, 1, 2):
        fast = _carrington_select(
            small_img, ref_img, sc,
            tile_fft_mode=_tile_fft_mode(lag_mode,
                                         devices[0] if devices else dev),
            **common)
        if fast is not None:
            logger.info("engine path: carrington linearized select")
            return fast
        logger.info("carrington select preconditions failed, "
                    "falling back to per-lag gather")

    grids = np.meshgrid(l1, l2, l3, l4, l5, indexing="ij")
    lags = np.stack([g.ravel() for g in grids], axis=-1)

    # gather fallback: full-grid observer geometry on the host in float64
    # (the reference-exact path keeps its numerics there)
    with timed("carrington lon/lat grid (host)"):
        lon, lat = carrington_grid(lonlims, latlims, shape)
    lon_rot = lon - diff_rot_shift_deg(lat, delta_t, rate_wave)
    x3, yy, zz = observer_geometry(lon_rot, lat, sc["obs_lon"], sc["obs_lat"])

    def put(a):
        return to_tensor(a, device=dev, dtype=dt)

    geom = {"x3": put(x3), "yy": put(yy), "zz": put(zz)}
    base = {k: torch.tensor(v, dtype=dt, device=dev) for k, v in sc.items()
            if k not in ("obs_lon", "obs_lat")}
    logger.info("engine path: carrington per-lag gather")
    out = _evaluate_flat_carr(lags, put(small_img), put(ref_img), geom,
                              base, order, method, batch_size,
                              devices or (dev,))
    return out.reshape(out_shape)
