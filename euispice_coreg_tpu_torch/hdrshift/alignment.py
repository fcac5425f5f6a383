"""Public coalignment API: the ``Alignment`` class (torch).

Counterpart of ``euispice_coreg_tpu/hdrshift/alignment.py`` with the same
constructor and the same ``align_using_helioprojective`` /
``align_using_initial_carrington`` entry points, plus ``device``:

* FITS I/O and header math stay on the host (float64 numpy),
* the reference image is resampled onto the comparison grid once on the
  device (the reference's ``_create_submap_of_large_data``),
* the 5-D lag hypercube is scored by ``engine.lag_search.evaluate_lag_grid``
  on the device.

``device`` is required to exist: ``device="cuda"`` without a card raises.
``parallelism`` and ``counts_cpu_max`` are accepted no-ops, as in the JAX
package.  Not ported yet (ROADMAP.md): ``align_using_carrington``, the
diagnostic figures (``path_save_figure``) and multi-device meshes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import wcs as wcs_mod
from ..core.header import ensure_pcij, get_crota, wcs_params_from_header
from ..engine import lag_search
from ..utils import coords, units
from ..utils.torchcfg import resolve_device, resolve_dtype, to_tensor
from .results import PLOT_NOT_PORTED, AlignmentResults


class Alignment:
    """Co-alignment of a small-FOV image against a reference with known
    pointing, over a 5-D lag hypercube (crval1/2, cdelt1/2, crota).

    ``lag_search_mode``:

    * "auto" (default): CRVAL-only grids use the FFT fast path; mixed grids
      of more than 2000 candidates would use the block fleet path (not
      ported: raises ``NotImplementedError``), smaller ones the exact
      per-lag engine;
    * "exact": always the per-lag engine (K1 on a CUDA device for
      correlation at order 0-2);
    * "fast"/"tile_fft": the FFT/block fast paths where applicable;
    * "pallas": the fused warp+score kernel K1.
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
        if path_save_figure is not None:
            raise NotImplementedError(PLOT_NOT_PORTED)
        if (use_device_mesh and self.device.type == "cuda"
                and torch.cuda.device_count() > 1):
            raise NotImplementedError(
                "multi-GPU lag sharding: not yet ported, see ROADMAP; pass "
                "use_device_mesh=False")
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

        corr = self._run_projected_search(wrap=True)
        if return_type == "corr":
            return corr
        return self._make_results(corr)

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

    def align_using_carrington(self, *args, **kwargs):
        """Carrington-grid search: not ported yet (ROADMAP.md)."""
        raise NotImplementedError(
            "align_using_carrington: Carrington engine not yet ported, see "
            "ROADMAP")

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

    def _run_projected_search(self, wrap: bool):
        """Shared helioprojective / initial-carrington search body."""
        from ..utils.obs import logger, timed

        if self.display_progress_bar:
            from ..utils.obs import enable_console_logging

            enable_console_logging()

        lon, lat, ref_img, base, kind = self._prepare_projected_operands(wrap)

        l1, l2, l3, l4, l5 = self._lags_deg(wrap=wrap)
        n_lags = len(l1) * len(l2) * len(l3) * len(l4) * len(l5)
        allow_fast = self._allow_fast_mode(n_lags)
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
            )
        # helioprojective ignores lag_solar_r: replicate across the 6th axis
        return np.repeat(corr5[..., np.newaxis], len(self.lag_solar_r), axis=-1)

    def _progress_scope(self):
        """Console progress bar for long public-API calls when
        ``display_progress_bar=True`` (the reference's tqdm bar)."""
        from ..utils import obs

        return obs.console_progress_bar(self.display_progress_bar)

    def _allow_fast_mode(self, n_lags):
        """Map ``lag_search_mode`` to the engine's ``allow_fast`` knob."""
        if self.lag_search_mode == "exact":
            return False
        if self.lag_search_mode == "pallas":
            return "pallas"
        if self.lag_search_mode in ("fast", "tile_fft"):
            # tile_fft is a Carrington select mode; projected searches use
            # the FFT/block fast paths
            return "block"
        return "block" if n_lags > 2000 else True  # auto
