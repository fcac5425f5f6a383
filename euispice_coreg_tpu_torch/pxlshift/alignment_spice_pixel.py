"""SPICE specialization of the pixel-space shift search (torch).

Counterpart of ``euispice_coreg_tpu/pxlshift/alignment_spice_pixel.py``
(reference ``pxlshift/alignment_spice_pixel.py:9-101``): flattens the SPICE
L2/L3 cube to a 2-D map (spectral sum between the dumbbell limits) and
always applies the raster solar-rotation CDELT1 correction.  The search
itself is :class:`AlignmentPixels` on ``device``.
"""
from __future__ import annotations

import numpy as np

from ..core.ndwcs import NDWCS
from ..hdrshift.alignment_spice import SpiceUtil, spatial_header_from_spice_l2
from ..utils import units
from .alignment_pixels import AlignmentPixels


class AlignmentSpicePixel(AlignmentPixels):
    """:class:`AlignmentPixels` over a SPICE raster (L2 spectral sum or L3
    amplitude window) against an FSI context image, with solar-rotation
    correction from the raster timing (``alignment_spice_pixel.py``)."""

    def __init__(self, fsi_path: str, fsi_window, spice_path: str,
                 spice_window, index_amplitude=None, *, device="cuda"):
        super().__init__(fsi_path, fsi_window, spice_path, spice_window,
                         device=device)
        self.fsi_path = fsi_path
        self.spice_path = spice_path
        self.fsi_window = fsi_window
        self.spice_window = spice_window
        level = 2 if "L2" in str(spice_path) else (3 if "L3" in str(spice_path) else 2)
        self._extract_spice_data_header(level=level, index_amplitude=index_amplitude)

    def _extract_spice_data_header(self, level: int, index_amplitude=None):
        from ..io import fits

        hdul = fits.open(self.spice_path)
        hdu = hdul[self.spice_window]
        hdr_orig = hdu.header
        dt = hdr_orig.get("PC4_1", 0.0)
        if level == 2:
            self._prepare_spice_from_l2(hdu)
        elif level == 3:
            self._prepare_spice_from_l3(hdu, index_amplitude)
        for key in ("SOLAR_B0", "RSUN_REF", "DSUN_OBS"):
            self.hdr_small[key] = hdr_orig[key]
        self._correct_solar_rotation(dt)

    def _prepare_spice_from_l2(self, hdu):
        data = np.asarray(hdu.data, dtype=np.float64)
        hdr = hdu.header
        ymin, ymax = SpiceUtil.vertical_edges_limits(hdr)
        ylen = data.shape[2]
        ylim = max(ymin, ylen - ymax - 1)
        self.data_small = np.nansum(data[0, :, ylim:(ylen - ylim), :], axis=0)

        self.hdr_small = spatial_header_from_spice_l2(
            hdr, self.data_small.shape[1], self.data_small.shape[0])
        self.hdr_small["CRPIX1"] = (self.data_small.shape[1] + 1) / 2
        self.hdr_small["CRPIX2"] = (self.data_small.shape[0] + 1) / 2

    def _prepare_spice_from_l3(self, hdu, index_amplitude):
        data = np.asarray(hdu.data, dtype=np.float64)
        hdr = hdu.header
        self.data_small = data[..., index_amplitude] if data.ndim == 3 else data
        miss = hdr.get("ANA_MISS")
        if miss is not None:
            self.data_small = np.where(self.data_small == miss, np.nan, self.data_small)
        w = NDWCS.from_header(hdr)
        pair = w.celestial_pair()
        drop = [i for i in range(w.n) if i not in pair]
        for d in sorted(drop, reverse=True):
            for j in range(w.n):
                if j != d:
                    w.set_pc(d, j, 0.0)
                    w.set_pc(j, d, 0.0)
            w = w.dropaxis(d)
        self.hdr_small = w.to_header()
        self.hdr_small["NAXIS1"] = self.data_small.shape[1]
        self.hdr_small["NAXIS2"] = self.data_small.shape[0]

    def _correct_solar_rotation(self, dt):
        """CDELT1 stretch, non-limb-corrected variant
        (alignment_spice_pixel.py:47-62)."""
        from ..engine import carrington as carr

        b0 = np.deg2rad(self.hdr_small["SOLAR_B0"])
        band = self.hdr_large["WAVELNTH"]
        if band == 174:
            band = 171
        omega_car = np.deg2rad(360 / 25.38 / 86400)
        coeffs = carr.DIFF_ROT_COEFFS.get(str(band), carr.DIFF_ROT_COEFFS["195"])
        a_car = 360 / 25.38
        corr_deg_day = (coeffs[0] - a_car + coeffs[1] * np.sin(b0) ** 2
                        + coeffs[2] * np.sin(b0) ** 4)
        omega = omega_car + np.deg2rad(corr_deg_day / 86400)
        rsun = self.hdr_small["RSUN_REF"]
        dsun = self.hdr_small["DSUN_OBS"]
        phi = np.rad2deg(omega * rsun / (dsun - rsun)) * 3600  # arcsec/s
        cunit1 = self.hdr_small.get("CUNIT1", "deg")
        dtx_old = units.convert(self.hdr_small["CDELT1"], cunit1, "arcsec")
        self.hdr_small["CDELT1"] = units.convert(dtx_old - dt * phi, "arcsec", cunit1)
