"""Public coalignment API: the ``Alignment`` class (torch).

Counterpart of ``euispice_coreg_tpu/hdrshift/alignment.py`` with the same
constructor and the same three entry points (``align_using_helioprojective``,
``align_using_initial_carrington``, ``align_using_carrington``), plus
``device``:

* FITS I/O and header math stay on the host (float64 numpy),
* the reference image is resampled onto the comparison grid once on the
  device (the reference's ``_create_submap_of_large_data``), or reprojected
  onto the user's Carrington grid (``engine.carrington``),
* the 5-D lag hypercube is scored on the device by
  ``engine.lag_search.evaluate_lag_grid`` or, on a Carrington grid, by
  ``engine.carrington.evaluate_lag_grid_carrington``.

``device`` is required to exist: ``device="cuda"`` without a card raises.
``parallelism`` and ``counts_cpu_max`` are accepted no-ops, as in the JAX
package.  ``path_save_figure`` saves the same diagnostic figures as the JAX
package (matplotlib, imported only then).  ``use_device_mesh=True`` (the
default) shards every search over all the machine's cards when it has more
than one (``utils.mesh.default_mesh``: ``self.mesh``, None on one card or
the CPU).
"""
from __future__ import annotations

import os
import sys
import warnings

import numpy as np
import torch

from ..core import wcs as wcs_mod
from ..core.header import ensure_pcij, get_crota, wcs_params_from_header
from ..engine import carrington as carr_engine
from ..engine import lag_search
from ..utils import coords, units
from ..utils.mesh import default_mesh
from ..utils.torchcfg import resolve_device, resolve_dtype, to_tensor
from .results import AlignmentResults


class HiddenPrints:
    """Context manager silencing stdout (the upstream reference's public
    helper; it wraps sunpy's reprojection chatter with it)."""

    def __enter__(self):
        self._original_stdout = sys.stdout
        sys.stdout = open(os.devnull, "w")

    def __exit__(self, exc_type, exc_val, exc_tb):
        sys.stdout.close()
        sys.stdout = self._original_stdout


def divide_chunks(l, n):  # noqa: E741 - the reference's signature
    """Yield successive n-sized chunks of l (the upstream reference's
    public helper)."""
    for i in range(0, len(l), n):
        yield l[i:i + n]


class Alignment:
    """Co-alignment of a small-FOV image against a reference with known
    pointing, over a 5-D lag hypercube (crval1/2, cdelt1/2, crota).

    ``lag_search_mode``:

    * "auto" (default): CRVAL-only grids use the FFT fast path.  Mixed
      grids (cdelt or crota lags) go through
      ``engine.lag_search.route_mixed_grid``: on a CUDA device, where both
      apply (correlation at reprojection order 0 or 2), the cheaper of K1
      and the block path (one warp per cdelt/crota combo, the CRVAL
      sub-grid on FFT surfaces) by a cost model measured on an H100, K1
      where it alone applies, and for ``residus_masked`` the block path
      above 2000 candidates; on the CPU the block path above 2000
      candidates, as in the JAX package.  Everything else, and what the
      block path declines, takes the exact per-lag engine.  On a
      Carrington grid: the per-combo FFT path, else the
      quadratic-conjugation select path (on a CUDA device on tile-FFT
      surfaces and the hybrid where they promise to beat K2, else on kernel
      K2), else the per-lag gather;
    * "exact": always the per-lag engine (K1 on a CUDA device for
      correlation at order 0-2);
    * "fast": the FFT fast path on CRVAL-only grids, the block path on any
      mixed grid (on a Carrington grid as "auto" without tile-FFT);
    * "pallas": the fused warp+score kernel K1; on a Carrington grid the
      select path on K2 directly;
    * "tile_fft": on a Carrington grid the select path on tile-FFT
      surfaces (``engine.tile_fft``), else the per-lag hybrid (tile-FFT on
      the lags that pass its gate), with K2 for every lag left; elsewhere
      as "fast".

    Raw ``"residus"`` always takes the exact engine (its NaN propagation
    does not factorize over FFT surfaces).
    """

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
        small_fov_value_min=None,
        parallelism=False,
        display_progress_bar: bool = False,
        small_fov_value_max=None,
        counts_cpu_max: int = 40,
        large_fov_window=-1,
        small_fov_window=-1,
        path_save_figure: str | None = None,
        reprojection_order: int = 2,
        force_crota_0: bool = False,
        unit_lag: str = "arcsec",
        compute_dtype="float32",
        batch_size_lags: int = 8,
        use_device_mesh: bool = True,
        lag_search_mode: str = "auto",
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.mesh = default_mesh(self.device) if use_device_mesh else None
        self.large_fov_known_pointing = large_fov_known_pointing
        self.small_fov_to_correct = small_fov_to_correct

        def _lag(v):
            if v is None:
                return np.array([0.0])
            return np.atleast_1d(np.asarray(v, dtype=np.float64))

        self.lag_crval1 = _lag(lag_crval1)
        self.lag_crval2 = _lag(lag_crval2)
        self.lag_cdelt1 = _lag(lag_cdelt1)
        self.lag_cdelt2 = _lag(lag_cdelt2)
        self.lag_crota = _lag(lag_crota)
        self.lag_solar_r = (
            np.atleast_1d(np.asarray(lag_solar_r, dtype=np.float64))
            if lag_solar_r is not None
            else np.array([1.004])  # alignment.py:841-842
        )
        self.unit_lag = unit_lag

        self.small_fov_value_min = small_fov_value_min
        self.small_fov_value_max = small_fov_value_max
        self.large_fov_window = large_fov_window
        self.small_fov_window = small_fov_window
        self.path_save_figure = path_save_figure
        if reprojection_order not in (0, 1, 2, 3):
            raise ValueError(
                f"reprojection_order must be 0..3 (scipy map_coordinates "
                f"spline orders the resampler implements), got "
                f"{reprojection_order!r}")
        self.order = reprojection_order
        self.force_crota_0 = force_crota_0
        self.parallelism = parallelism
        self.counts = counts_cpu_max
        self.display_progress_bar = display_progress_bar

        self.batch_size_lags = batch_size_lags
        if lag_search_mode not in ("auto", "exact", "fast", "pallas",
                                   "tile_fft"):
            raise ValueError(f"unknown lag_search_mode: {lag_search_mode!r}")
        self.lag_search_mode = lag_search_mode

        self.data_large = None
        self.data_small = None
        self.hdr_large = None
        self.hdr_small = None
        self.method = None
        self.coordinate_frame = None
        self.lonlims = None
        self.latlims = None
        self.shape = None
        self.reference_date = None
        self.rat_wave = dict(carr_engine.RAT_WAVE)

    # ------------------------------------------------------------------
    # data loading / preprocessing (host)
    # ------------------------------------------------------------------
    def _load_pair(self, dtype=np.float64):
        from ..utils.obs import stage

        with stage("api_fits_load_s"):
            self._load_pair_body(dtype)

    def _load_pair_body(self, dtype=np.float64):
        from ..io import fits

        f_large = fits.open(self.large_fov_known_pointing)
        f_small = fits.open(self.small_fov_to_correct)
        hdu_l = f_large[self.large_fov_window]
        hdu_s = f_small[self.small_fov_window]
        self.data_large = np.asarray(hdu_l.data, dtype=dtype)
        self.hdr_large = hdu_l.header.copy()
        self.data_small = np.asarray(hdu_s.data, dtype=dtype)
        self.hdr_small = hdu_s.header.copy()
        ensure_pcij(self.hdr_small, self.force_crota_0)
        ensure_pcij(self.hdr_large, self.force_crota_0)

    def _to_device(self, a):
        return to_tensor(a, device=self.device, dtype=self.compute_dtype)

    def _apply_thresholds(self):
        """Min/max thresholds on |value| -> NaN (alignment.py:876-887)."""
        if self.small_fov_value_min is not None:
            self.data_small[np.abs(self.data_small) < self.small_fov_value_min] = np.nan
        if self.small_fov_value_max is not None:
            self.data_small[np.abs(self.data_small) > self.small_fov_value_max] = np.nan

    def _apply_remove_fov(self, remove_fov_limits, unit="arcsec"):
        """NaN out a world-coordinate box (alignment.py:863-874)."""
        lon, lat = coords.header_world_grid(self.hdr_small)
        lonlims = units.to_deg(np.asarray(remove_fov_limits[0], dtype=np.float64), unit)
        latlims = units.to_deg(np.asarray(remove_fov_limits[1], dtype=np.float64), unit)
        inside = (
            (lon >= lonlims[0]) & (lon <= lonlims[1])
            & (lat >= latlims[0]) & (lat <= latlims[1])
        )
        self.data_small[inside] = np.nan

    def _apply_fov_limits(self, fov_limits, unit="arcsec"):
        """Crop the small image to a world-coordinate box by resampling it
        onto a fresh regular grid and replacing its header
        (alignment.py:1082-1127)."""
        lon, lat = coords.header_world_grid(self.hdr_small)
        lonlims = units.to_deg(np.asarray(fov_limits[0], dtype=np.float64), unit)
        latlims = units.to_deg(np.asarray(fov_limits[1], dtype=np.float64), unit)
        long, latg, dlon, dlat = coords.build_regular_grid(
            lon, lat, lonlims_deg=lonlims, latlims_deg=latlims
        )
        mid_r, mid_c = long.shape[0] // 2, long.shape[1] // 2
        cunit1 = self.hdr_small.get("CUNIT1", "deg")
        cunit2 = self.hdr_small.get("CUNIT2", "deg")
        hdrg = self.hdr_small.copy()
        hdrg["CRVAL1"] = units.from_deg(long[mid_r, mid_c], cunit1)
        hdrg["CRVAL2"] = units.from_deg(latg[mid_r, mid_c], cunit2)
        hdrg["CRPIX1"] = mid_c + 1
        hdrg["CRPIX2"] = mid_r + 1
        hdrg["CDELT1"] = units.from_deg(dlon, cunit1)
        hdrg["CDELT2"] = units.from_deg(dlat, cunit2)
        hdrg["PC1_1"], hdrg["PC1_2"] = 1.0, 0.0
        hdrg["PC2_1"], hdrg["PC2_2"] = 0.0, 1.0
        hdrg["CROTA"] = 0.0
        hdrg["CROTA2"] = 0.0
        hdrg["NAXIS1"] = long.shape[1]
        hdrg["NAXIS2"] = long.shape[0]

        xg, yg = coords.world_to_pixel_of_header(self.hdr_small, long, latg)
        self.data_small = lag_search.resample_to_grid(
            self.data_small, xg, yg, order=self.order, device=self.device,
            compute_dtype=self.compute_dtype)
        self.hdr_small = hdrg

    def _lags_deg(self, wrap=True):
        """Lag arrays in degrees (reference converts lags to CUNIT units with
        an ang2pipi wrap; alignment.py:819-837)."""
        conv = (lambda v: units.ang2pipi(units.to_deg(v, self.unit_lag), "deg")) if wrap \
            else (lambda v: units.to_deg(v, self.unit_lag))
        return (
            conv(self.lag_crval1),
            conv(self.lag_crval2),
            conv(self.lag_cdelt1),
            conv(self.lag_cdelt2),
            self.lag_crota,  # always degrees
        )

    def _make_results(self, corr):
        return AlignmentResults(
            corr=corr,
            lag_crval1=self.lag_crval1,
            lag_crval2=self.lag_crval2,
            lag_cdelt1=self.lag_cdelt1,
            lag_cdelt2=self.lag_cdelt2,
            lag_crota=self.lag_crota,
            unit_lag=self.unit_lag,
            image_to_align_path=self.small_fov_to_correct,
            image_to_align_window=self.small_fov_window,
            reference_image_path=self.large_fov_known_pointing,
            reference_image_window=self.large_fov_window,
        )

    # ------------------------------------------------------------------
    # alignment entry points
    # ------------------------------------------------------------------
    def align_using_helioprojective(
        self,
        method: str = "correlation",
        return_type: str = "AlignmentResults",
        fov_limits=None,
        remove_fov_limits=None,
    ):
        """Lag search in the helioprojective frame (the main path)."""
        self._begin_helioprojective(method, fov_limits=fov_limits,
                                    remove_fov_limits=remove_fov_limits)
        corr = self._run_projected_search(wrap=True)
        if return_type == "corr":
            return corr
        return self._make_results(corr)

    def _begin_helioprojective(self, method: str, fov_limits=None,
                               remove_fov_limits=None):
        """Load, thresholds and field-of-view limits of a helioprojective
        search; shared with the movie fleet
        (``jitter_correction._align_movie_batched``), so that both stay the
        same up to the engine call."""
        self.method = method
        self.coordinate_frame = "final_helioprojective"
        if self.data_small is None:
            self._load_pair()
        self._apply_thresholds()
        if remove_fov_limits is not None:
            self._apply_remove_fov(remove_fov_limits)
        if fov_limits is not None:
            self._apply_fov_limits(fov_limits)
        if np.all(np.isnan(self.data_small)):
            raise ValueError("minimum or maximum value have set all small FOV to nan")

    def align_using_initial_carrington(
        self, method: str = "correlation", return_type: str = "AlignmentResults"
    ):
        """Lag search for inputs already in Carrington (CAR) coordinates
        (alignment.py:344-399)."""
        self.method = method
        self.coordinate_frame = "initial_carrington"
        if self.data_small is None:
            self._load_pair(dtype=np.float64)
        self._apply_thresholds()
        if np.all(np.isnan(self.data_small)):
            raise ValueError("minimum or maximum value have set all small FOV to nan")
        corr = self._run_projected_search(wrap=False)
        if return_type == "corr":
            return corr
        return self._make_results(corr)

    def align_using_carrington(
        self,
        lonlims=None,
        latlims=None,
        size_deg_carrington=None,
        shape=None,
        reference_date=None,
        method: str = "correlation",
        method_carrington_reprojection: str = "fa",
        return_type: str = "AlignmentResults",
    ):
        """Lag search on a user Carrington lon/lat grid (alignment.py:144-261).

        ``method_carrington_reprojection="fa"`` searches on an explicit
        Carrington lon/lat grid.  ``"sunpy"`` reproduces the reference's
        sunpy branch natively (no sunpy dependency): the reference image is
        reprojected once onto the small image's own WCS assuming solar-
        surface corotation (``alignment.py:939-985``), and the per-lag
        search then runs in the small image's projected frame (lonlims/
        latlims/shape/reference_date are not required, matching the
        reference docstring).
        """
        if method_carrington_reprojection not in ("fa", "sunpy"):
            raise ValueError(
                "method_carrington_reprojection must be either 'fa' or 'sunpy'"
            )
        self.method = method
        self.coordinate_frame = "final_carrington"
        if self.data_small is None:
            self._load_pair()
        self._apply_thresholds()
        if np.all(np.isnan(self.data_small)):
            raise ValueError("minimum or maximum value have set all small FOV to nan")

        if method_carrington_reprojection == "sunpy":
            corr = self._run_solar_surface_search()
            if return_type == "corr":
                return corr
            return self._make_results(corr)

        if reference_date is None:
            if "DATE-AVG" not in self.hdr_large:
                raise ValueError(
                    "Either provide a reference date manually or the reference "
                    "file header must have a DATE-AVG keyword."
                )
            self.reference_date = self.hdr_large["DATE-AVG"]
        else:
            self.reference_date = reference_date

        if (lonlims is None) and (latlims is None) and (size_deg_carrington is not None):
            crln = self.hdr_small["CRLN_OBS"]
            crlt = self.hdr_small["CRLT_OBS"]
            self.lonlims = [crln - 0.5 * size_deg_carrington[0], crln + 0.5 * size_deg_carrington[0]]
            self.latlims = [crlt - 0.5 * size_deg_carrington[1], crlt + 0.5 * size_deg_carrington[1]]
            self.shape = [int(self.hdr_small["NAXIS1"]), int(self.hdr_small["NAXIS2"])]
        elif (lonlims is not None) and (latlims is not None) and (shape is not None):
            self.lonlims = list(lonlims)
            self.latlims = list(latlims)
            self.shape = list(shape)
        else:
            raise ValueError("either set lonlims as None, or not. no in between.")
        if self.shape[0] * self.shape[1] > 25_000_000:
            warnings.warn(
                f"shape parameter is {self.shape}, which is very large. "
                "Computational time might significantly increase"
            )

        wave = self.hdr_large.get("WAVELNTH")
        rate_wave = self.rat_wave.get(str(int(wave))) if wave is not None else None

        corr = self._run_carrington_fa_search(rate_wave)
        if return_type == "corr":
            return corr
        return self._make_results(corr)

    def _run_carrington_fa_search(self, rate_wave):
        """Carrington explicit-grid search body: one reprojection of the
        reference image and one lag search per ``lag_solar_r``, stacked on
        the last axis (alignment.py:144-261)."""
        from ..utils.obs import stage

        l1, l2, l3, l4, l5 = self._lags_deg(wrap=True)
        large = self._to_device(self.data_large)
        small = self._to_device(self.data_small)
        corr_parts = []
        for d_solar_r in self.lag_solar_r:
            with stage("carr_api_reproject_s"):
                ref_img = carr_engine.reproject_to_carrington(
                    large, self.hdr_large, self.lonlims, self.latlims,
                    self.shape, d_solar_r=float(d_solar_r),
                    reference_date=self.reference_date, rate_wave=rate_wave,
                    order=self.order, device=self.device,
                    compute_dtype=self.compute_dtype, as_numpy=False)
            self._save_carrington_figures(ref_img, d_solar_r, rate_wave)
            with self._progress_scope():
                corr5 = carr_engine.evaluate_lag_grid_carrington(
                    small, ref_img, self.hdr_small, self.lonlims,
                    self.latlims, self.shape, l1, l2, l3, l4, l5,
                    d_solar_r=float(d_solar_r),
                    reference_date=self.reference_date, rate_wave=rate_wave,
                    order=self.order, method=self.method, device=self.device,
                    compute_dtype=self.compute_dtype,
                    batch_size=self.batch_size_lags,
                    lag_mode=self.lag_search_mode, mesh=self.mesh)
            corr_parts.append(corr5)
        return np.stack(corr_parts, axis=-1)

    def _run_solar_surface_search(self):
        """Native equivalent of the reference's sunpy reprojection branch
        (``alignment.py:939-985``): the reference image is reprojected once
        per ``lag_solar_r`` onto the small image's own WCS assuming solar-
        surface corotation (``engine.carrington.reproject_solar_surface``);
        the per-lag reprojection (shifted small WCS onto the original small
        WCS at equal obstime) is then plain WCS resampling, i.e. the
        projected-frame engine, so every helioprojective path applies."""
        from ..utils.obs import logger, timed

        small_params = wcs_params_from_header(self.hdr_small)
        kind = small_params.kind
        h, w = self.data_small.shape
        lon, lat = lag_search.compute_world_grid(
            small_params.as_dict(), h, w, kind, False, device=self.device,
            compute_dtype=self.compute_dtype)
        base = {**small_params.as_dict(), "crota": get_crota(self.hdr_small)}

        l1, l2, l3, l4, l5 = self._lags_deg(wrap=True)
        n_lags = len(l1) * len(l2) * len(l3) * len(l4) * len(l5)
        allow_fast = self._allow_fast_mode((l1, l2, l3, l4, l5),
                                            self.data_small.shape)
        logger.info("solar-surface (sunpy-equivalent) search: %d candidates, "
                    "mode=%s", n_lags * len(self.lag_solar_r),
                    self.lag_search_mode)

        small = self._to_device(self.data_small)
        corr_parts = []
        for d_solar_r in self.lag_solar_r:
            with timed("solar-surface reprojection (reference -> small WCS)"):
                ref_img = carr_engine.reproject_solar_surface(
                    self.data_large, self.hdr_large, self.hdr_small,
                    d_solar_r=float(d_solar_r), order=self.order,
                    device=self.device, compute_dtype=self.compute_dtype)
            self._save_solar_surface_figures(ref_img)
            with timed(f"lag-grid search ({n_lags} candidates)"), \
                    self._progress_scope():
                corr5 = lag_search.evaluate_lag_grid(
                    small, ref_img, lon, lat, base, l1, l2, l3, l4, l5,
                    order=self.order, method=self.method, kind=kind,
                    device=self.device, compute_dtype=self.compute_dtype,
                    batch_size=self.batch_size_lags, allow_fast=allow_fast,
                    mesh=self.mesh)
            corr_parts.append(corr5)
        return np.stack(corr_parts, axis=-1)

    def _prepare_projected_operands(self, wrap: bool):
        """Comparison-grid world coordinates + reference submap + base WCS
        for a projected (helioprojective / initial-carrington) search.

        Returns ``(lon, lat, ref_img, base, kind)`` with the arrays as
        tensors on ``self.device``."""
        from ..utils.obs import timed

        small_params = wcs_params_from_header(self.hdr_small)
        large_params = wcs_params_from_header(self.hdr_large)
        kind = small_params.kind

        do_wrap = wrap and kind == "tan"
        h, w = self.data_small.shape

        # the ]-180, 180] wrap is a mathematical no-op unless the field
        # approaches the branch cut; applying it in float32 costs ~0.04 px
        # of world precision (mod-360 at magnitude ~360), so skip it when
        # the host float64 probes show it cannot fire
        if do_wrap:
            px_pr, py_pr = lag_search.probe_pixel_points(h, w)
            pl_pr, pb_pr = wcs_mod.pixel_to_world(
                small_params.as_dict(), px_pr, py_pr, kind=kind, xp=np)
            if max(np.max(np.abs(pl_pr)), np.max(np.abs(pb_pr))) < 170.0:
                do_wrap = False

        with timed("submap (reference image -> comparison grid)"):
            lon, lat, ref_img = lag_search.prepare_grid_and_submap(
                self.data_large, small_params.as_dict(),
                large_params.as_dict(), h, w, kind, do_wrap, self.order,
                device=self.device, compute_dtype=self.compute_dtype)

        base = {**small_params.as_dict(), "crota": get_crota(self.hdr_small)}
        return lon, lat, ref_img, base, kind

    # ------------------------------------------------------------------
    # in-alignment diagnostic figures (reference alignment.py:988-1012,
    # 903-927, 955-972 — saved when ``path_save_figure`` is set)
    # ------------------------------------------------------------------
    def _figpath(self, name: str) -> str:
        os.makedirs(self.path_save_figure, exist_ok=True)
        return os.path.join(self.path_save_figure, name)

    def _save_projected_figures(self, ref_img):
        """Reprojected large/small FOV + compare figures for a projected
        search (the reference saves these inside
        ``_create_submap_of_large_data``, alignment.py:988-1016)."""
        if self.path_save_figure is None:
            return
        from matplotlib import pyplot as plt

        from ..plot import plot

        plot.simple_plot(self.hdr_large, self.data_large, show=False,
                         path_save=self._figpath("large_fov_before_cut.pdf"),
                         device=self.device)
        date_small = str(self.hdr_small.get(
            "DATE-AVG", self.hdr_small.get("DATE-OBS", "unknown")))
        date_small = date_small.replace(":", "_")
        submap = ref_img.to(torch.float64).cpu().numpy()
        # after the cut the reference grid IS the small header's grid
        plot.simple_plot(self.hdr_small, submap, show=False,
                         path_save=self._figpath(f"large_fov_{date_small}.pdf"),
                         device=self.device)
        plot.simple_plot(self.hdr_small, self.data_small, show=False,
                         path_save=self._figpath(f"small_fov_{date_small}.pdf"),
                         device=self.device)
        levels = [0.15 * np.nanmax(self.data_small)]
        plot.contour_plot(self.hdr_small, submap, self.hdr_small,
                          self.data_small, levels=levels, show=False,
                          path_save=self._figpath(f"compare_plot_{date_small}.pdf"),
                          device=self.device)
        plt.close("all")

    def _save_carrington_figures(self, ref_img, d_solar_r, rate_wave):
        """Reprojected large + small Carrington FOV figures (the reference
        saves these inside ``_carrington_transform_fa``,
        alignment.py:903-927; its dlat extent bug — latlims mixed with
        lonlims — is not reproduced)."""
        if self.path_save_figure is None:
            return
        from matplotlib import pyplot as plt

        from ..plot import plot

        dlon = (self.lonlims[1] - self.lonlims[0]) / self.shape[0]
        dlat = (self.latlims[1] - self.latlims[0]) / self.shape[1]
        extent = (self.lonlims[0] - 0.5 * dlon, self.lonlims[1] + 0.5 * dlon,
                  self.latlims[0] - 0.5 * dlat, self.latlims[1] + 0.5 * dlat)
        date_obs = str(self.hdr_large.get(
            "DATE-OBS", self.hdr_large.get("DATE-AVG", "unknown")))[:19]
        plot.plot_fov(ref_img.to(torch.float64).cpu().numpy(), show=False,
                      path_save=self._figpath(f"image_large_{date_obs}.pdf"),
                      extent=extent,
                      xlabel="carrington longitude [°]",
                      ylabel="carrington latitude [°]")
        image_small = carr_engine.reproject_to_carrington(
            self._to_device(self.data_small), self.hdr_small, self.lonlims,
            self.latlims, self.shape, d_solar_r=float(d_solar_r),
            reference_date=self.reference_date, rate_wave=rate_wave,
            order=self.order, device=self.device,
            compute_dtype=self.compute_dtype)
        date_obs = str(self.hdr_small.get(
            "DATE-OBS", self.hdr_small.get("DATE-AVG", "unknown")))[:19]
        plot.plot_fov(image_small, show=False,
                      path_save=self._figpath(f"image_small_{date_obs}.pdf"),
                      extent=extent,
                      xlabel="carrington longitude [°]",
                      ylabel="carrington latitude [°]")
        plt.close("all")

    def _save_solar_surface_figures(self, ref_img):
        """Small / large / reprojected-large figures for the native
        sunpy-equivalent branch (reference alignment.py:955-972)."""
        if self.path_save_figure is None:
            return
        from matplotlib import pyplot as plt

        from ..plot import plot

        date_obs = str(self.hdr_large.get(
            "DATE-OBS", self.hdr_large.get("DATE-AVG", "unknown")))[:19]
        plot.simple_plot_sunpy((self.data_small, self.hdr_small), show=False,
                               path_save=self._figpath(f"image_small_{date_obs}.pdf"),
                               device=self.device)
        date_obs = str(self.hdr_small.get(
            "DATE-OBS", self.hdr_small.get("DATE-AVG", "unknown")))[:19]
        plot.simple_plot_sunpy((self.data_large, self.hdr_large), show=False,
                               path_save=self._figpath(f"image_large_{date_obs}.pdf"),
                               device=self.device)
        plot.simple_plot_sunpy(
            (ref_img, self.hdr_small),
            show=False,
            path_save=self._figpath(f"image_large_rep_{date_obs}.pdf"),
            device=self.device)
        plt.close("all")

    def _run_projected_search(self, wrap: bool):
        """Shared helioprojective / initial-carrington search body."""
        from ..utils.obs import logger, timed

        if self.display_progress_bar:
            from ..utils.obs import enable_console_logging

            enable_console_logging()

        lon, lat, ref_img, base, kind = self._prepare_projected_operands(wrap)
        self._save_projected_figures(ref_img)

        l1, l2, l3, l4, l5 = self._lags_deg(wrap=wrap)
        n_lags = len(l1) * len(l2) * len(l3) * len(l4) * len(l5)
        allow_fast = self._allow_fast_mode((l1, l2, l3, l4, l5),
                                            self.data_small.shape)
        logger.info("lag search: %d candidates, mode=%s, order=%d",
                    n_lags * len(self.lag_solar_r), self.lag_search_mode, self.order)
        with timed(f"lag-grid search ({n_lags} candidates)"), \
                self._progress_scope():
            corr5 = lag_search.evaluate_lag_grid(
                self._to_device(self.data_small), ref_img, lon, lat, base,
                l1, l2, l3, l4, l5,
                order=self.order,
                method=self.method,
                kind=kind,
                device=self.device,
                compute_dtype=self.compute_dtype,
                batch_size=self.batch_size_lags,
                allow_fast=allow_fast,
                mesh=self.mesh,
            )
        # helioprojective ignores lag_solar_r: replicate across the 6th axis
        return np.repeat(corr5[..., np.newaxis], len(self.lag_solar_r), axis=-1)

    def _progress_scope(self):
        """Console progress bar for long public-API calls when
        ``display_progress_bar=True`` (the reference's tqdm bar)."""
        from ..utils import obs

        return obs.console_progress_bar(self.display_progress_bar)

    def _allow_fast_mode(self, lags, shape):
        """Map ``lag_search_mode`` to the engine's ``allow_fast`` knob for
        the lag axes ``lags`` (l1..l5) of a search on a small image of
        ``shape`` (h, w)."""
        if self.lag_search_mode == "exact":
            return False
        if self.lag_search_mode == "pallas":
            return "pallas"
        if self.lag_search_mode in ("fast", "tile_fft"):
            # tile_fft is a Carrington select mode; projected searches use
            # the FFT/block fast paths
            return "block"
        # auto
        l1, l2, l3, l4, l5 = lags
        n_combos = len(l3) * len(l4) * len(l5)
        if n_combos == 1 and not (l3[0] or l4[0] or l5[0]):
            # a CRVAL-only grid: the FFT path at order 0/2, whatever the knob
            return ("block" if len(l1) * len(l2)
                    > lag_search.JAX_BLOCK_MIN_LAGS else True)
        return lag_search.route_mixed_grid(
            len(l1), len(l2), n_combos, *shape, order=self.order,
            method=self.method, device_type=self.device.type,
            n_shards=len(self.mesh) if self.mesh else 1)
