"""Synthetic solar scenes for the port's examples, rendered through the port's
own WCS, so the pointing error each example must recover is known exactly.

The same generators as ``tests/fixtures.py`` (same seeds, same arrays and
header cards), written on numpy and ``euispice_coreg_tpu_torch`` alone: the
examples run where JAX is not installed.
"""
from __future__ import annotations

import numpy as np

from euispice_coreg_tpu_torch.core.header import Header, pc_from_crota
from euispice_coreg_tpu_torch.hdrshift.alignment_spice import \
    spatial_header_from_spice_l2
from euispice_coreg_tpu_torch.io import fits
from euispice_coreg_tpu_torch.utils import coords


def scene_helioprojective(lon_deg, lat_deg, seed=0, n_blobs=30,
                          width_deg=0.02):
    """Deterministic smooth scene T(Tx, Ty) in degrees: Gaussian blobs on a
    level of 100."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.12, 0.12, size=(n_blobs, 2))
    amps = rng.uniform(0.5, 3.0, size=n_blobs)
    widths = rng.uniform(0.5, 2.0, size=n_blobs) * width_deg
    out = np.zeros(np.broadcast(lon_deg, lat_deg).shape, dtype=np.float64)
    for (cx, cy), a, w in zip(centers, amps, widths):
        out += a * np.exp(-(((lon_deg - cx) ** 2) + ((lat_deg - cy) ** 2))
                          / (2 * w**2))
    return out + 100.0


def make_header(naxis=(128, 128), cdelt_arcsec=(10.0, 10.0),
                crval_arcsec=(0.0, 0.0), crota_deg=0.0,
                ctype=("HPLN-TAN", "HPLT-TAN"), extra=None):
    """A 2-D helioprojective header of an FSI-like 174 image."""
    n1, n2 = naxis
    pc11, pc12, pc21, pc22 = pc_from_crota(crota_deg, cdelt_arcsec[0],
                                           cdelt_arcsec[1])
    hdr = Header({
        "NAXIS1": n1, "NAXIS2": n2,
        "CRVAL1": crval_arcsec[0], "CRVAL2": crval_arcsec[1],
        "CRPIX1": (n1 + 1) / 2, "CRPIX2": (n2 + 1) / 2,
        "CDELT1": cdelt_arcsec[0], "CDELT2": cdelt_arcsec[1],
        "CUNIT1": "arcsec", "CUNIT2": "arcsec",
        "CTYPE1": ctype[0], "CTYPE2": ctype[1],
        "CROTA": crota_deg,
        "PC1_1": pc11, "PC1_2": pc12, "PC2_1": pc21, "PC2_2": pc22,
        "DATE-OBS": "2022-03-17T09:50:45.281",
        "DATE-AVG": "2022-03-17T09:50:50.281",
        "WAVELNTH": 174,
        "DETECTOR": "FSI",
        "BUNIT": "DN/s",
    })
    if extra:
        hdr.update(extra)
    return hdr


def render_helioprojective(hdr, seed=0, width_deg=0.02):
    """The analytic scene on a header's pixel grid."""
    lon, lat = coords.header_world_grid(hdr)
    return scene_helioprojective(lon, lat, seed=seed, width_deg=width_deg)


def make_helioprojective_pair(true_shift_arcsec=(8.0, -4.0),
                              true_dcrota_deg=0.0, large_naxis=(196, 196),
                              large_cdelt=(12.0, 12.0), small_naxis=(96, 96),
                              small_cdelt=(5.0, 5.0), small_crota=0.75,
                              seed=0):
    """A large/small pair whose small header is mispointed by exactly
    ``-true_shift``: the lag search must find ``+true_shift``.  Returns
    (data_large, hdr_large, data_small, hdr_small)."""
    hdr_large = make_header(large_naxis, large_cdelt, (0.0, 0.0), 0.0)
    data_large = render_helioprojective(hdr_large, seed=seed)
    hdr_small_true = make_header(small_naxis, small_cdelt, (120.0, 80.0),
                                 small_crota + true_dcrota_deg)
    data_small = render_helioprojective(hdr_small_true, seed=seed)
    hdr_small = make_header(
        small_naxis, small_cdelt,
        (120.0 - true_shift_arcsec[0], 80.0 - true_shift_arcsec[1]),
        small_crota)
    return data_large, hdr_large, data_small, hdr_small


def write_pair_fits(tmp_path, data_large, hdr_large, data_small, hdr_small):
    """The pair as float32 FITS files ``large.fits`` and ``small.fits`` in
    the directory ``tmp_path`` (a :class:`pathlib.Path`)."""
    p_large = str(tmp_path / "large.fits")
    p_small = str(tmp_path / "small.fits")
    fits.write(p_large, [fits.PrimaryHDU(data=data_large.astype(np.float32),
                                         header=hdr_large)])
    fits.write(p_small, [fits.PrimaryHDU(data=data_small.astype(np.float32),
                                         header=hdr_small)])
    return p_large, p_small


def make_spice_l2_header(nx=48, ny=64, nlam=4, cdelt_arcsec=(4.0, 1.0),
                         crval_arcsec=(120.0, 80.0), crota_deg=0.0,
                         dt_per_step=5.0,
                         date_beg="2022-03-17T09:45:00.000"):
    """4-D SPICE L2 header: (x=HPLN-TAN, y=HPLT-TAN, WAVE, UTC) with the
    time<->x raster coupling in PC4_1."""
    pc11, pc12, pc21, pc22 = pc_from_crota(crota_deg, cdelt_arcsec[0],
                                           cdelt_arcsec[1])
    return Header({
        "NAXIS": 4,
        "NAXIS1": nx, "NAXIS2": ny, "NAXIS3": nlam, "NAXIS4": 1,
        "CTYPE1": "HPLN-TAN", "CTYPE2": "HPLT-TAN",
        "CTYPE3": "WAVE", "CTYPE4": "UTC",
        "CUNIT1": "deg", "CUNIT2": "deg", "CUNIT3": "nm", "CUNIT4": "s",
        "CRVAL1": crval_arcsec[0] / 3600.0, "CRVAL2": crval_arcsec[1] / 3600.0,
        "CRVAL3": 77.0, "CRVAL4": dt_per_step * (nx / 2),
        "CRPIX1": (nx + 1) / 2, "CRPIX2": (ny + 1) / 2,
        "CRPIX3": (nlam + 1) / 2, "CRPIX4": 1.0,
        "CDELT1": cdelt_arcsec[0] / 3600.0, "CDELT2": cdelt_arcsec[1] / 3600.0,
        "CDELT3": 0.05, "CDELT4": 1.0,
        "PC1_1": pc11, "PC1_2": pc12, "PC2_1": pc21, "PC2_2": pc22,
        "PC3_3": 1.0, "PC4_4": 1.0,
        "PC4_1": dt_per_step,  # seconds per raster step
        "CROTA": crota_deg,
        "NBIN2": 1, "DETECTOR": "SW", "PXBEG2": 230,
        "SOLAR_B0": 3.0, "RSUN_REF": 6.957e8, "DSUN_OBS": 0.5 * 1.496e11,
        "DATEREF": date_beg, "DATE-BEG": date_beg,
        "DATE-OBS": date_beg, "DATE-AVG": "2022-03-17T09:47:00.000",
        "LEVEL": "L2",
    })


def render_spice_l2_cube(hdr, seed=0, line_profile=(0.1, 0.4, 0.4, 0.1),
                         width_deg=0.02):
    """The analytic scene as a SPICE L2 cube (1, nlam, ny, nx) whose
    spectral sum reproduces the scene."""
    nx, ny = int(hdr["NAXIS1"]), int(hdr["NAXIS2"])
    nlam = int(hdr["NAXIS3"])
    lon, lat = coords.header_world_grid(spatial_header_from_spice_l2(hdr, nx,
                                                                     ny))
    scene = scene_helioprojective(lon, lat, seed=seed, width_deg=width_deg)
    prof = np.asarray(line_profile[:nlam], dtype=np.float64)
    prof = prof / prof.sum()
    return scene[None, None, :, :] * prof[None, :, None, None]
