"""SPICE spectrometer alignment: L2/L3 cube preparation + lag search (torch).

Counterpart of ``euispice_coreg_tpu/hdrshift/alignment_spice.py``
(reference ``hdrshift/alignment_spice.py:13-469``):

* L2 (t, lambda, y, x) cubes are flattened to a 2-D intensity map by summing
  over a wavelength window, with the dumbbell rows NaN'd from the detector
  geometry (``AlignSpiceUtil.vertical_edges_limits``, Util.py:450-455),
* the 4-D WCS is reduced to the spatial pair with the time->x coupling
  zeroed (alignment_spice.py:255-261),
* optionally the raster-scan solar rotation is folded into CDELT1
  (``_correct_solar_rotation``, alignment_spice.py:223-248),
* then the port's lag search runs (helioprojective or Carrington) on
  ``device``.

The preparation is host float64 numpy.  The iterative context raster scores
each chunk of lags with one torch function on the device
(:func:`_iter_chunk_scores`, the JAX package's XLA program of that name).
Its search runs under ``api_align_s``: the cube read and prepared under
``spice_load_prep_s``, each chunk's lag headers under ``iter_lag_headers_s``
(host), its rasters composed under ``iter_compose_s`` and scored under
``iter_score_s`` (card spans), after one ``engine path: iterative context
raster`` line.
The L2/L3 level is inferred from the file path like the reference
(alignment_spice.py:95-98).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import resample, score
from ..core import wcs as wcs2d
from ..core.header import Header, ensure_pcij, get_crota, pc_from_crota
from ..core.ndwcs import NDWCS
from ..utils import obs, units
from ..utils.torchcfg import to_tensor
from .alignment import Alignment


def _capture_pointing_refs(hdr: Header) -> dict:
    """Reference pointing values of a header before lag shifting
    (the reference's ``_set_initial_header_values``, alignment.py:799-842)."""
    return {
        "crval1": float(hdr["CRVAL1"]),
        "crval2": float(hdr["CRVAL2"]),
        "cdelt1": float(hdr["CDELT1"]),
        "cdelt2": float(hdr["CDELT2"]),
        "crota": get_crota(hdr),
        "u1": hdr.get("CUNIT1", "deg"),
        "u2": hdr.get("CUNIT2", "deg"),
    }


def _apply_full_lag(hdr: Header, refs: dict, d1: float, d2: float, d3: float,
                    d4: float, d5: float) -> None:
    """Shift ``hdr`` in place by the full (crval1, crval2, cdelt1, cdelt2,
    crota) lag vector; d1..d4 in degrees, d5 in degrees of roll.

    Reference semantics: ``Alignment._shift_header`` (reference
    ``hdrshift/alignment.py:401-468``) — CRVALs are ref + lag, CDELTs are
    ref + lag, CROTA is ref + lag, and the spatial PCi_j block is rebuilt
    from (crota, cdelt) whenever any cdelt/crota lag is nonzero.  The
    reference's CDELT1 write-back bug (the shifted value never reaches the
    header) is fixed here, as in the main engine.
    """
    hdr["CRVAL1"] = refs["crval1"] + units.from_deg(d1, refs["u1"])
    hdr["CRVAL2"] = refs["crval2"] + units.from_deg(d2, refs["u2"])
    change_pc = (d3 != 0.0) or (d4 != 0.0) or (d5 != 0.0)
    if not change_pc:
        return
    cdelt1 = refs["cdelt1"] + units.from_deg(d3, refs["u1"])
    cdelt2 = refs["cdelt2"] + units.from_deg(d4, refs["u2"])
    hdr["CDELT1"] = cdelt1
    hdr["CDELT2"] = cdelt2
    crota = refs["crota"] + d5
    if "CROTA2" in hdr and "CROTA" not in hdr:
        hdr["CROTA2"] = crota
    else:
        hdr["CROTA"] = crota
    pc11, pc12, pc21, pc22 = pc_from_crota(
        crota,
        units.to_deg(cdelt1, refs["u1"]),
        units.to_deg(cdelt2, refs["u2"]),
    )
    hdr["PC1_1"], hdr["PC1_2"] = pc11, pc12
    hdr["PC2_1"], hdr["PC2_2"] = pc21, pc22


def _iter_chunk_scores(params_l, params_s, data_stack, data_small,
                       kind_l, kind_s, order, method):
    """Score a chunk of iterative-raster lag candidates on the device: the
    composed grids' world coordinates (stacked (L, 1, 1) params
    ``params_l``), the shifted SPICE headers' pixel map (``params_s``), the
    spline sampling of the SPICE image and the score of each composed
    raster of ``data_stack`` (L, ny, nx) against its sample.

    Coordinates are computed in ``data_stack``'s width; the sampling runs
    in float32 (``lag_search.resample_to_grid``'s compute dtype) and the
    score in ``data_stack``'s width, the sequential path's numerics.
    Returns the (L,) scores as a tensor on the device."""
    _, ny, nx = data_stack.shape
    dev, dt = data_stack.device, data_stack.dtype
    px = torch.arange(nx, dtype=dt, device=dev).expand(ny, nx)
    py = torch.arange(ny, dtype=dt, device=dev)[:, None].expand(ny, nx)
    lon, lat = wcs2d.pixel_to_world(params_l, px, py, kind=kind_l)
    if kind_l == "tan":  # header_world_grid's wrap default
        lon = wcs2d.ang2pipi_deg(lon)
        lat = wcs2d.ang2pipi_deg(lat)
    x, y = wcs2d.world_to_pixel(params_s, lon, lat, kind=kind_s)
    small = resample.sample_image(
        data_small.to(torch.float32), x.to(torch.float32),
        y.to(torch.float32), order=order)
    return score.SCORE_FUNCTIONS[method](data_stack, small.to(dt))


class SpiceUtil:
    """Detector-geometry helpers (ports of AlignSpiceUtil, Util.py:428-455)."""

    @staticmethod
    def slit_pxl(header: Header):
        """First and last detector row of the slit."""
        ybin = header["NBIN2"]
        h_detector = 1024 / ybin
        det = header["DETECTOR"]
        if det == "SW":
            h_slit = 600 / ybin
        elif det == "LW":
            h_slit = 626 / ybin
        else:
            raise ValueError(f"unknown detector: {det}")
        slit_beg = (h_detector - h_slit) / 2
        slit_end = h_detector - slit_beg
        slit_beg = slit_beg - header["PXBEG2"] / ybin + 1
        slit_end = slit_end - header["PXBEG2"] / ybin + 1
        return int(np.ceil(slit_beg)), int(np.floor(slit_end))

    @staticmethod
    def vertical_edges_limits(header: Header):
        iymin, iymax = SpiceUtil.slit_pxl(header)
        iymin += int(20 / header["NBIN2"])
        iymax -= int(20 / header["NBIN2"])
        return iymin, iymax


def spatial_header_from_spice_l2(hdr4: Header, naxis1: int, naxis2: int) -> Header:
    """2-D spatial header from a SPICE L2 4-D header: drop the spectral and
    time axes after zeroing the time->x PC coupling
    (alignment_spice.py:255-261)."""
    w = NDWCS.from_header(hdr4)
    w_xyt = w.dropaxis(2)       # drop spectral (FITS axis 3)
    w_xyt.set_pc(2, 0, 0.0)     # decouple time from x
    w_xy = w_xyt.dropaxis(2)    # drop time
    hdr2 = w_xy.to_header()
    hdr2["NAXIS1"] = naxis1
    hdr2["NAXIS2"] = naxis2
    return hdr2


class AlignmentSpice(Alignment):
    """SPICE-raster specialization of :class:`Alignment`: L2/L3 input prep
    (spectral window sum in Angstrom, dumbbell removal, CDELT1 rotation
    correction, ``sub_fov_window``/``cut_from_center``), then the port's
    lag search against a synthetic-raster reference on ``device``
    (``alignment_spice.py:24-356``)."""

    def __init__(
        self,
        large_fov_known_pointing: str,
        small_fov_to_correct: str,
        lag_crval1=None,
        lag_crval2=None,
        lag_cdelt1=None,
        lag_cdelt2=None,
        lag_crota=None,
        lag_solar_r=None,
        large_fov_window=-1,
        small_fov_window=-1,
        parallelism: bool = False,
        counts_cpu_max: int = 40,
        display_progress_bar: bool = False,
        path_save_figure: str | None = None,
        wavelength_interval_to_sum="all",
        sub_fov_window="all",
        small_fov_value_min=None,
        small_fov_value_max=None,
        unit_lag: str = "arcsec",
        **kwargs,
    ):
        """``wavelength_interval_to_sum``: "all" or [min, max] in Angstrom
        (the reference takes astropy Quantities; plain floats here).
        ``sub_fov_window``: "all" or [lon_min, lon_max, lat_min, lat_max] in
        arcsec.  ``kwargs`` go to :class:`Alignment` (``device``,
        ``lag_search_mode``, ``compute_dtype``, ...)."""
        super().__init__(
            large_fov_known_pointing=large_fov_known_pointing,
            small_fov_to_correct=small_fov_to_correct,
            lag_crval1=lag_crval1,
            lag_crval2=lag_crval2,
            lag_cdelt1=lag_cdelt1,
            lag_cdelt2=lag_cdelt2,
            lag_crota=lag_crota,
            lag_solar_r=lag_solar_r,
            parallelism=parallelism,
            counts_cpu_max=counts_cpu_max,
            display_progress_bar=display_progress_bar,
            large_fov_window=large_fov_window,
            small_fov_window=small_fov_window,
            path_save_figure=path_save_figure,
            small_fov_value_min=small_fov_value_min,
            small_fov_value_max=small_fov_value_max,
            unit_lag=unit_lag,
            **kwargs,
        )
        self.wavelength_interval_to_sum = wavelength_interval_to_sum
        self.sub_fov_window = sub_fov_window
        self.extend_pixel_size = False
        self.cut_from_center = None

    # ------------------------------------------------------------------
    def _infer_level(self) -> int:
        path = str(self.small_fov_to_correct)
        if "L2" in path:
            return 2
        if "L3" in path:
            return 3
        return 2

    def _extract_imager_data_header(self):
        from ..io import fits

        hdul = fits.open(self.large_fov_known_pointing)
        hdu = hdul[self.large_fov_window]
        self.data_large = np.asarray(hdu.data, dtype=np.float64)
        self.hdr_large = hdu.header.copy()
        ensure_pcij(self.hdr_large, self.force_crota_0)

    def _extract_spice_data_header(self, level: int, coeff: int | None = None):
        from ..io import fits

        hdul = fits.open(self.small_fov_to_correct)
        hdu = hdul[self.small_fov_window]
        hdr_orig = hdu.header
        dt = hdr_orig.get("PC4_1", 0.0)

        if level == 2:
            self._prepare_spice_from_l2(hdu)
        elif level == 3:
            self._prepare_spice_from_l3(hdu, coeff)
        else:
            raise ValueError("level must be 2 or 3")

        for key in ("SOLAR_B0", "RSUN_REF", "DSUN_OBS", "CROTA"):
            if key in hdr_orig:
                self.hdr_small[key] = hdr_orig[key]
        for key in ("CRLN_OBS", "CRLT_OBS", "DATE-OBS", "DATE-AVG", "DATE-BEG"):
            if key in hdr_orig and key not in self.hdr_small:
                self.hdr_small[key] = hdr_orig[key]
        ensure_pcij(self.hdr_small, force_crota_0=True)

        if self.extend_pixel_size:
            self._correct_solar_rotation(dt)

    def _prepare_spice_from_l2(self, hdu):
        """L2 (t, lambda, y, x) -> 2-D intensity map
        (alignment_spice.py:250-323)."""
        data = np.asarray(hdu.data, dtype=np.float64)
        hdr = hdu.header
        ymin, ymax = SpiceUtil.vertical_edges_limits(hdr)

        data = data.copy()
        data[:, :, :ymin, :] = np.nan
        data[:, :, ymax:, :] = np.nan

        interval = self.wavelength_interval_to_sum
        if isinstance(interval, str) and interval == "all":
            self.data_small = np.nansum(data[0], axis=0)
        elif isinstance(interval, (list, tuple)):
            # wavelength world values of the spectral axis (FITS axis 3)
            w = NDWCS.from_header(hdr)
            k = np.arange(data.shape[1], dtype=np.float64)
            ispec = 2  # FITS axis 3, 0-based
            wave = (w.crval[ispec]
                    + w.cdelt[ispec] * w.pc[ispec, ispec] * (k + 1 - w.crpix[ispec]))
            # interval given in Angstrom; spectral CUNIT usually nm
            cunit = w.cunit[ispec].strip().lower()
            to_angstrom = {"nm": 10.0, "angstrom": 1.0, "m": 1e10}.get(cunit, 10.0)
            wave_ang = wave * to_angstrom
            sel = (wave_ang >= interval[0]) & (wave_ang <= interval[1])
            self.data_small = np.nansum(data[0, sel], axis=0)
        else:
            raise ValueError(
                "wavelength_interval_to_sum must be [wave_min, wave_max] "
                "(Angstrom) or 'all'"
            )
        self.data_small[:ymin, :] = np.nan
        self.data_small[ymax:, :] = np.nan

        if self.cut_from_center is not None:
            xlen = self.cut_from_center
            xmid = self.data_small.shape[1] // 2
            self.data_small[:, : (xmid - xlen // 2 - 1)] = np.nan
            self.data_small[:, (xmid + xlen // 2):] = np.nan

        self.hdr_small = spatial_header_from_spice_l2(
            hdr, self.data_small.shape[1], self.data_small.shape[0]
        )

        if not (isinstance(self.sub_fov_window, str) and self.sub_fov_window == "all"):
            from ..utils import coords

            lon, lat = coords.header_world_grid(self.hdr_small)
            win = [units.to_deg(v, "arcsec") for v in self.sub_fov_window]
            keep = ((lon >= win[0]) & (lon <= win[1])
                    & (lat >= win[2]) & (lat <= win[3]))
            self.data_small[~keep] = np.nan

    def _prepare_spice_from_l3(self, hdu, coeff: int | None):
        """L3 fitted-coefficient cube -> 2-D map (alignment_spice.py:340-355).

        The coefficient axis is selected on the leading numpy axis like the
        reference; the WCS is reduced to the spatial pair.
        """
        data = np.asarray(hdu.data, dtype=np.float64)
        hdr = hdu.header
        if coeff is None:
            coeff = 0
        self.data_small = data[coeff].copy() if data.ndim == 3 else data[coeff, 0].copy()
        ymin, ymax = SpiceUtil.vertical_edges_limits(hdr)
        self.data_small[:ymin, :] = np.nan
        self.data_small[ymax:, :] = np.nan

        w = NDWCS.from_header(hdr)
        # drop every axis that is not the celestial pair, zeroing couplings
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

    # ------------------------------------------------------------------
    def _correct_solar_rotation(self, dt):
        """Stretch CDELT1 for raster-scan solar rotation
        (alignment_spice.py:223-248): each raster column is exposed dt
        seconds after the previous, during which the scene rotates."""
        from ..engine import carrington as carr

        b0 = np.deg2rad(self.hdr_small["SOLAR_B0"])
        band = self.hdr_large["WAVELNTH"]
        if band == 174:
            band = 171
        omega_car = np.deg2rad(360 / 25.38 / 86400)  # rad/s
        coeffs = carr.DIFF_ROT_COEFFS.get(str(band), carr.DIFF_ROT_COEFFS["195"])
        a_car = 360 / 25.38
        corr_deg_day = (coeffs[0] - a_car + coeffs[1] * np.sin(b0) ** 2
                        + coeffs[2] * np.sin(b0) ** 4)
        omega = omega_car + np.deg2rad(corr_deg_day / 86400)  # rad/s

        rsun = self.hdr_small["RSUN_REF"]
        dsun = self.hdr_small["DSUN_OBS"]
        phi_rot = 1.004 * omega * rsun / (dsun - 1.004 * rsun)  # rad/s
        phi_rot = np.rad2deg(phi_rot) * 3600  # arcsec/s

        alpha = units.to_deg(self.hdr_small["CRVAL1"],
                             self.hdr_small.get("CUNIT1", "deg")) * np.pi / 180.0
        phi = np.arcsin(((dsun - 1.004 * rsun) / (1.004 * rsun)) * np.sin(alpha))

        cunit1 = self.hdr_small.get("CUNIT1", "deg")
        dtx_old = units.convert(self.hdr_small["CDELT1"], cunit1, "arcsec")
        dtx_new = dtx_old - dt * phi_rot * np.cos(phi)
        self.hdr_small["CDELT1"] = units.convert(dtx_new, "arcsec", cunit1)

    def _load_pair_spice(self, coeff):
        """The imager reference and the prepared SPICE map, each under its
        stage clock (``api_fits_load_s``, ``spice_load_prep_s``) and this
        file's id."""
        with obs.stage("api_fits_load_s", file=self._file_id):
            self._extract_imager_data_header()
        with obs.stage("spice_load_prep_s", file=self._file_id):
            self._extract_spice_data_header(level=self._infer_level(),
                                            coeff=coeff)

    # ------------------------------------------------------------------
    def align_using_helioprojective(
        self,
        method: str = "correlation",
        extend_pixel_size: bool = False,
        cut_from_center=None,
        return_type: str = "AlignmentResults",
        coefficient_l3: int | None = None,
        fov_limits=None,
        remove_fov_limits=None,
    ):
        self.extend_pixel_size = extend_pixel_size
        self.cut_from_center = cut_from_center
        self._load_pair_spice(coefficient_l3)
        return super().align_using_helioprojective(
            method=method,
            return_type=return_type,
            fov_limits=fov_limits,
            remove_fov_limits=remove_fov_limits,
        )

    def align_using_carrington(
        self,
        lonlims=None,
        latlims=None,
        size_deg_carrington=None,
        shape=None,
        reference_date=None,
        method: str = "correlation",
        return_type: str = "AlignmentResults",
        coefficient_l3: int | None = None,
        method_carrington_reprojection: str = "fa",
    ):
        self.extend_pixel_size = False
        self._load_pair_spice(coefficient_l3)
        # the reference normalizes the SPICE header to arcsec before the
        # Carrington search (alignment_spice.py:159-168)
        for ax in (1, 2):
            cunit = self.hdr_small.get(f"CUNIT{ax}", "deg")
            self.hdr_small[f"CRVAL{ax}"] = units.ang2pipi(
                units.convert(self.hdr_small[f"CRVAL{ax}"], cunit, "arcsec"), "arcsec")
            self.hdr_small[f"CDELT{ax}"] = units.convert(
                self.hdr_small[f"CDELT{ax}"], cunit, "arcsec")
            self.hdr_small[f"CUNIT{ax}"] = "arcsec"
        return super().align_using_carrington(
            lonlims=lonlims,
            latlims=latlims,
            size_deg_carrington=size_deg_carrington,
            shape=shape,
            reference_date=reference_date,
            method=method,
            method_carrington_reprojection=method_carrington_reprojection,
            return_type=return_type,
        )


class AlignementSpiceIterativeContextRaster(AlignmentSpice):
    """SPICE alignment where the synthetic raster is rebuilt for every lag
    candidate from the shifted SPICE pointing.

    Port of the reference class of the same (misspelled) name
    (``alignment_spice.py:357-469``): each lag shifts the unflattened SPICE
    header, rebuilds the composed imager raster against it, and correlates.
    The reference image changes per lag, so the lag engine does not apply:
    lags are scored in chunks (or one by one) with the imager frames held
    on the device by the builder.
    """

    def __init__(self, large_fov_list_paths, small_fov_to_correct: str,
                 threshold_time: float, lag_crval1=None, lag_crval2=None,
                 lag_cdelt1=None, lag_cdelt2=None, lag_crota=None,
                 small_fov_value_min=None, small_fov_value_max=None,
                 parallelism=False, counts_cpu_max=40, large_fov_window=-1,
                 small_fov_window=-1, path_save_figure=None, **kwargs):
        super().__init__(
            large_fov_known_pointing="No_specific_path",
            small_fov_to_correct=small_fov_to_correct,
            lag_crval1=lag_crval1, lag_crval2=lag_crval2,
            lag_cdelt1=lag_cdelt1, lag_cdelt2=lag_cdelt2, lag_crota=lag_crota,
            small_fov_value_min=small_fov_value_min,
            small_fov_value_max=small_fov_value_max,
            parallelism=parallelism, counts_cpu_max=counts_cpu_max,
            large_fov_window=large_fov_window,
            small_fov_window=small_fov_window,
            path_save_figure=path_save_figure, **kwargs)
        self.large_fov_list_paths = [str(p) for p in large_fov_list_paths]
        self.threshold_time = float(threshold_time)
        self.header_spice_unflattened = None
        self._builder = None

    def _get_builder(self):
        from ..synras.map_builder import SPICEComposedMapBuilder

        if self._builder is None:
            self._builder = SPICEComposedMapBuilder(
                path_to_spectro=self.small_fov_to_correct,
                list_imager_paths=self.large_fov_list_paths,
                threshold_time=self.threshold_time,
                window_imager=self.large_fov_window,
                window_spectro=self.small_fov_window,
                device=self.device,
            )
        return self._builder

    def align_using_helioprojective(self, method="correlation",
                                    extend_pixel_size=False,
                                    cut_from_center=None,
                                    return_type="AlignmentResults",
                                    coefficient_l3=None,
                                    batch_lags: bool = True,
                                    lag_chunk: int = 64):
        """``batch_lags``: score lag candidates in chunks of ``lag_chunk``:
        the raster rebuild samples each imager frame for all lags of a
        chunk at once and the chunk is scored by one device call
        (:func:`_iter_chunk_scores`), its scores copied to the host once,
        instead of the reference's one full builder run + one score per lag
        (``alignment_spice.py:376-420``).  ``batch_lags=False`` keeps the
        sequential per-lag loop: one full raster rebuild from each shifted
        4-D header (same results; the parity tests pin the two together).

        Both routes score through :func:`_iter_chunk_scores` (the
        sequential one a stack of one), where the JAX package's sequential
        route maps the SPICE image with host numpy.  The composed grid is
        the SPICE grid, so that map lands on whole pixels, and whether the
        first column is sampled (x = 0 or -1e-13) turns on rounding; the
        card's float64 functions round otherwise than the host's, which
        moved r by 1.5e-5 between the two routes on an H100."""
        from ..io import fits as fitsio
        from ..utils import coords
        from ..utils.obs import Progress

        self.method = method
        self.extend_pixel_size = extend_pixel_size
        self.cut_from_center = cut_from_center

        with obs.stage("api_align_s", file=self._file_id):
            with obs.stage("spice_load_prep_s"):
                hdul = fitsio.open(self.small_fov_to_correct)
                self.header_spice_unflattened = \
                    hdul[self.small_fov_window].header.copy()
                self._extract_spice_data_header(level=self._infer_level(),
                                                coeff=coefficient_l3)
            self._apply_thresholds()

            # reference pointing values of both headers; every lag candidate
            # shifts both by the full 5-vector like the reference's _step
            # (alignment_spice.py:376-388 via _shift_header)
            refs_s = _capture_pointing_refs(self.hdr_small)
            refs_u = _capture_pointing_refs(self.header_spice_unflattened)

            builder = self._get_builder()
            l1d, l2d, l3d, l4d, l5d = self._lags_deg(wrap=True)
            shape = (len(l1d), len(l2d), len(l3d), len(l4d), len(l5d))
            corr = np.zeros(shape)

            progress = Progress(total=int(np.prod(shape)),
                                label="iterative context-raster lag search",
                                enabled=self.display_progress_bar)
            small_d = to_tensor(self.data_small, device=self.device,
                                dtype=torch.float32)

            def score_stack(hdrs_large, hdrs_s, data_stack):
                # one device call for the (L, ny, nx) stack of composed
                # rasters against the SPICE image through the L shifted
                # headers, the scores copied to the host once
                pl, kind_l = coords.stack_wcs_params(hdrs_large)
                ps, kind_s = coords.stack_wcs_params(hdrs_s)
                vals = _iter_chunk_scores(
                    {k: torch.as_tensor(v, device=self.device)
                     for k, v in pl.items()},
                    {k: torch.as_tensor(v, device=self.device)
                     for k, v in ps.items()},
                    data_stack, small_d, kind_l, kind_s, self.order, method)
                return vals.to(torch.float64).cpu().numpy()

            def lag_headers(d1, d2, d3, d4, d5):
                # shift both the flattened and the unflattened headers by
                # the full lag vector (crota/cdelt rebuild the spatial PC
                # block)
                hdr_s = self.hdr_small.copy()
                _apply_full_lag(hdr_s, refs_s, d1, d2, d3, d4, d5)
                hdr_u = self.header_spice_unflattened.copy()
                _apply_full_lag(hdr_u, refs_u, d1, d2, d3, d4, d5)
                return hdr_s, hdr_u

            if batch_lags:
                # one prep of the unshifted header: pointing lags only touch
                # the spatial WCS block, which passes through the
                # axis-dropping prep verbatim — so shifting the prepped 2-D
                # spatial header by the lag vector equals prepping the
                # shifted 4-D header (the parity test pins this against the
                # sequential path)
                builder._prepare_spectro_meta(self.header_spice_unflattened,
                                              False, 2)
                hdr_sp0 = builder.hdr_spice_
                refs_sp = _capture_pointing_refs(hdr_sp0)

                all_idx = list(np.ndindex(*shape))  # C order: flat index
                corr_flat = corr.reshape(-1)
                chunk_n = max(1, int(lag_chunk))
                obs.logger.info(
                    "engine path: iterative context raster (%d lags in %d "
                    "chunks of %d)", len(all_idx),
                    -(-len(all_idx) // chunk_n), chunk_n)
                for c0 in range(0, len(all_idx), chunk_n):
                    chunk = all_idx[c0: c0 + chunk_n]
                    hdrs_s, hdrs_sp = [], []
                    with obs.stage("iter_lag_headers_s"):
                        for idx in chunk:
                            d = (l1d[idx[0]], l2d[idx[1]], l3d[idx[2]],
                                 l4d[idx[3]], l5d[idx[4]])
                            hs = self.hdr_small.copy()
                            _apply_full_lag(hs, refs_s, *d)
                            hdrs_s.append(hs)
                            hsp = hdr_sp0.copy()
                            _apply_full_lag(hsp, refs_sp, *d)
                            hdrs_sp.append(hsp)
                    with obs.stage("iter_compose_s", card=True):
                        data_stack, hdrs_large = \
                            builder.compose_many_from_headers(
                                [self.header_spice_unflattened] * len(chunk),
                                spatial_headers=hdrs_sp, as_numpy=False)
                    with obs.stage("iter_score_s", card=True):
                        corr_flat[c0: c0 + len(chunk)] = score_stack(
                            hdrs_large, hdrs_s, data_stack)
                    progress.step(len(chunk))
            else:
                # the composed raster rebuilt from each shifted 4-D header,
                # then scored as a stack of one
                obs.logger.info(
                    "engine path: iterative context raster, one lag at a time "
                    "(%d lags)", corr.size)
                for idx in np.ndindex(*shape):
                    hdr_s, hdr_u = lag_headers(l1d[idx[0]], l2d[idx[1]],
                                               l3d[idx[2]], l4d[idx[3]],
                                               l5d[idx[4]])
                    builder.process_from_header(hdr_spice=hdr_u,
                                                print_filename=False)
                    data = to_tensor(builder.data_composed[None],
                                     device=self.device, dtype=torch.float64)
                    corr[idx] = score_stack([builder.hdr_composed], [hdr_s],
                                            data)[0]
                    progress.step()
            corr6 = corr[..., np.newaxis]
            if return_type == "corr":
                return corr6
            return self._make_results(corr6)
