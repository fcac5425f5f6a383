"""Pixel-space (non-WCS) shift search (torch).

Counterpart of ``euispice_coreg_tpu/pxlshift/alignment_pixels.py``
(reference ``pxlshift/alignment_pixels.py:14-156``): degrade the large image
to the small image's plate scale, optionally correct the large image for
solar rotation, then slide the small image (optionally rotated) over it in
integer-pixel steps and Pearson-score every offset.  Per rotation angle the
whole (dx, dy) grid is one FFT correlation-surface evaluation; the rotations
are the frames of one evaluation, split over the devices of a ``mesh``
(:func:`engine.fast_corr.pearson_integer_shifts_frames`).
"""
from __future__ import annotations

import numpy as np

from ..engine import fast_corr, lag_search
from ..utils import timeutils, units
from ..utils.mesh import resolve_mesh
from ..utils.torchcfg import resolve_device


class AlignmentPixels:
    """Pixel-space shift search (no WCS) over (dx, dy, drot) candidates, on
    ``device`` (``"cuda"`` without a card raises).

    Resamples and surfaces run in float64.  (The JAX package resamples and
    scores in float32, a TPU choice; at these sizes float64 costs the card
    little.)"""

    def __init__(self, large_fov_known_pointing: str, window_large,
                 small_fov_to_correct: str, window_small, *, device="cuda"):
        from ..io import fits

        self.device = resolve_device(device)
        hdu_large = fits.open(large_fov_known_pointing)[window_large]
        self.hdr_large = hdu_large.header.copy()
        self.data_large = np.asarray(hdu_large.data, dtype=np.float64)
        hdu_small = fits.open(small_fov_to_correct)[window_small]
        self.hdr_small = hdu_small.header.copy()
        self.data_small = np.asarray(hdu_small.data, dtype=np.float64)
        self.slc_small_ref = None

    def _resample(self, image, x, y):
        return lag_search.resample_to_grid(
            image, x, y, order=1, device=self.device, compute_dtype="float64")

    # ------------------------------------------------------------------
    def find_best_parameters(self, lag_dx, lag_dy, lag_drot,
                             unit_rot: str = "degree",
                             shift_solar_rotation_dx_large: bool = False,
                             mesh=None):
        """corr hypercube of shape (len(lag_dx), len(lag_dy), len(lag_drot)).

        ``mesh``: a sequence of devices (None: ``device`` alone); the
        rotations are split over them as the frames of one evaluation
        (:meth:`_find_best_parameters_fleet`)."""
        mesh = resolve_mesh(mesh)
        if shift_solar_rotation_dx_large:
            self._shift_large_fov()
        self._sub_resolution_large_fov()
        self._initialise_slice_corresponding_to_small()

        lag_dx = np.asarray(lag_dx, dtype=np.int64)
        lag_dy = np.asarray(lag_dy, dtype=np.int64)
        lag_drot = np.atleast_1d(np.asarray(lag_drot, dtype=np.float64))

        # every candidate window must stay inside the large frame
        for dx in (lag_dx.min(), lag_dx.max()):
            for dy in (lag_dy.min(), lag_dy.max()):
                slc = (
                    slice(self.slc_small_ref[0].start + int(dy),
                          self.slc_small_ref[0].stop + int(dy)),
                    slice(self.slc_small_ref[1].start + int(dx),
                          self.slc_small_ref[1].stop + int(dx)),
                )
                self._check_boundaries(slc, self.data_large.shape)

        return self._find_best_parameters_fleet(lag_dx, lag_dy, lag_drot,
                                                unit_rot, mesh)

    def _canvas(self, drot: float, unit_rot: str):
        """The small image rotated by ``drot`` and embedded in large-frame
        coordinates, NaN elsewhere."""
        canvas = np.full(self.data_large.shape, np.nan)
        canvas[self.slc_small_ref] = self._rotate_small(drot, unit_rot)
        return canvas

    def _find_best_parameters_fleet(self, lag_dx, lag_dy, lag_drot,
                                    unit_rot: str, mesh):
        """Rotation-axis fleet: the rotated canvases are the frames of one
        :func:`engine.fast_corr.pearson_integer_shifts_frames` evaluation
        split over ``mesh`` (None: ``self.device``; the large frame placed
        once per device); the (len(dx), len(dy), len(drot)) hypercube."""
        canvases = [self._canvas(float(drot), unit_rot) for drot in lag_drot]
        corr = fast_corr.pearson_integer_shifts_frames(
            canvases, self.data_large, lag_dx, lag_dy, device=self.device,
            mesh=mesh)
        return corr.transpose(1, 2, 0)

    def _rotate_small(self, drot: float, unit_rot: str):
        """Rotate the small image about its center (polar transform +
        order-1 resample, reference ``matrix_transform.py:77-106``)."""
        if drot == 0.0:
            return self.data_small.copy()
        theta = np.radians(drot) if unit_rot in ("degree", "deg") else drot
        h, w = self.data_small.shape
        xx, yy = np.meshgrid(np.arange(w, dtype=np.float64),
                             np.arange(h, dtype=np.float64))
        xc = xx[round(h / 2), round(w / 2)]
        yc = yy[round(h / 2), round(w / 2)]
        r = np.hypot(xx - xc, yy - yc)
        ang = np.arctan2(yy - yc, xx - xc) + theta
        return self._resample(self.data_small, r * np.cos(ang) + xc,
                              r * np.sin(ang) + yc)

    # ------------------------------------------------------------------
    def _shift_large_fov(self):
        """Displace the large image by the solar-rotation drift accumulated
        between the two observations (reference
        ``alignment_pixels.py:86-107``)."""
        dcrval_arcsec = self._return_shift_large_fov_solar_rotation()
        cunit1 = self.hdr_large.get("CUNIT1", "arcsec")
        shift = units.convert(dcrval_arcsec, "arcsec", cunit1)
        if "CROTA" in self.hdr_large:
            theta = np.deg2rad(self.hdr_large["CROTA"])
            dx = shift / self.hdr_large["CDELT1"] * np.cos(-theta)
            dy = shift / self.hdr_large["CDELT2"] * np.sin(-theta)
        else:
            dx = shift / self.hdr_large["CDELT1"]
            dy = 0.0
        h, w = self.data_large.shape
        xx, yy = np.meshgrid(np.arange(w, dtype=np.float64),
                             np.arange(h, dtype=np.float64))
        self.data_large = self._resample(self.data_large, xx + dx, yy + dy)

    def _return_shift_large_fov_solar_rotation(self) -> float:
        """Solar-rotation drift in arcsec (reference
        ``alignment_pixels.py:109-124``)."""
        from ..engine import carrington as carr

        band = self.hdr_large["WAVELNTH"]
        if band == 174:
            band = 171
        b0 = np.deg2rad(self.hdr_large["SOLAR_B0"])
        omega_car = np.deg2rad(360 / 25.38 / 86400)
        coeffs = carr.DIFF_ROT_COEFFS.get(str(band), carr.DIFF_ROT_COEFFS["195"])
        a_car = 360 / 25.38
        corr_deg_day = (coeffs[0] - a_car + coeffs[1] * np.sin(b0) ** 2
                        + coeffs[2] * np.sin(b0) ** 4)
        omega = omega_car + np.deg2rad(corr_deg_day / 86400)
        rsun = self.hdr_large["RSUN_REF"]
        dsun = self.hdr_large["DSUN_OBS"]
        phi = np.rad2deg(omega * rsun / (dsun - rsun)) * 3600  # arcsec/s
        dt = timeutils.time_diff_seconds(
            str(self.hdr_small["DATE-AVG"]), str(self.hdr_large["DATE-AVG"]))
        return dt * phi

    def _sub_resolution_large_fov(self):
        """Degrade the large image to the small image's plate scale
        (reference ``alignment_pixels.py:126-143``)."""
        cunit_l1 = self.hdr_large.get("CUNIT1", "arcsec")
        cunit_l2 = self.hdr_large.get("CUNIT2", "arcsec")
        c1 = units.convert(self.hdr_small["CDELT1"],
                           self.hdr_small.get("CUNIT1", "arcsec"), cunit_l1)
        c2 = units.convert(self.hdr_small["CDELT2"],
                           self.hdr_small.get("CUNIT2", "arcsec"), cunit_l2)
        self.ratio_res_1 = c1 / self.hdr_large["CDELT1"]
        self.ratio_res_2 = c2 / self.hdr_large["CDELT2"]
        x, y = np.meshgrid(
            np.arange(0, self.data_large.shape[1], self.ratio_res_1),
            np.arange(0, self.data_large.shape[0], self.ratio_res_2),
        )
        self.data_large = self._resample(self.data_large, x, y)

    def _initialise_slice_corresponding_to_small(self):
        corner = [int((self.data_large.shape[n] - self.data_small.shape[n] - 1)
                      / 2) for n in range(2)]
        self.slc_small_ref = (
            slice(corner[0], corner[0] + self.data_small.shape[0]),
            slice(corner[1], corner[1] + self.data_small.shape[1]),
        )

    @staticmethod
    def _check_boundaries(slc, shape):
        for n in range(2):
            if slc[n].start < 0 or slc[n].stop > shape[n]:
                raise ValueError("too large shift : outside FSI")
