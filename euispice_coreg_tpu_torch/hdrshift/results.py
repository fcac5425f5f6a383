"""Alignment results: argmax bookkeeping, sub-pixel Gaussian fit, FITS output.

Behavioural port of ``AlignmentResults``
(``euispice_coreg/hdrshift/AlignmentResults.py:23-355``):
the 6-D correlation hypercube is reduced at the argmax of the
cdelt1/cdelt2/crota/solar-r axes, a 2-D Gaussian is fitted over the 5x5
neighborhood of the crval1/crval2 argmax with the same initial guess and
bounds, and the fitted sub-pixel optimum is interpolated back onto the lag
axes.  Falls back to the raw argmax when the fit fails or has too few points.
"""
from __future__ import annotations

import warnings

import numpy as np
from scipy.optimize import curve_fit

from ..core.header import correct_pointing_header
from ..utils import obs, units

# what a CompImageHDU carries of its file's compression (io/fits.py)
_COMPRESSION_SETTINGS = ("compression_type", "quantize_level",
                         "quantize_method", "dither_seed", "tile_shape")


def _maybe_int(s: str):
    try:
        return int(s)
    except ValueError:
        return s


def twoD_Gaussian(xy, amplitude, xo, yo, sigma_x, sigma_y, offset):
    """Same model as the reference (AlignmentResults.py:12-20)."""
    x, y = xy
    g = offset + amplitude * np.exp(
        -(((x - float(xo)) ** 2) / (2 * sigma_x**2)
          + ((y - float(yo)) ** 2) / (2 * sigma_y**2))
    )
    return np.ravel(g)


class AlignmentResults:
    """Search result: the correlation hypercube, its argmax, and the 5x5
    Gaussian sub-pixel fit of the (crval1, crval2) peak — same fit model,
    p0 and bounds as the reference (``AlignmentResults.py:200-280``) — plus
    corrected-header/FITS writers and npz checkpoints (framework extension).
    """

    def __init__(
        self,
        corr: np.ndarray,
        lag_crval1,
        lag_crval2,
        lag_cdelt1,
        lag_cdelt2,
        lag_crota,
        unit_lag: str,
        image_to_align_path: str | None = None,
        image_to_align_window=None,
        reference_image_path: str | None = None,
        reference_image_window=None,
    ):
        def _arr(v):
            return np.atleast_1d(np.asarray(v if v is not None else [0], dtype=np.float64))

        corr = np.asarray(corr, dtype=np.float64)
        if corr.ndim == 5:
            corr = corr[..., np.newaxis]
        self.corr = corr
        self.unit_lag = unit_lag

        self.parameters_alignment = {
            "lag_crval1": _arr(lag_crval1),
            "lag_crval2": _arr(lag_crval2),
            "lag_cdelt1": _arr(lag_cdelt1),
            "lag_cdelt2": _arr(lag_cdelt2),
            "lag_crota": _arr(lag_crota),
        }
        self.parameters_alignment_arcsec = {
            k: (units.convert(v, unit_lag, "arcsec") if k != "lag_crota" else v)
            for k, v in self.parameters_alignment.items()
        }
        self.image_to_align_path = image_to_align_path
        self.image_to_align_window = image_to_align_window
        self.reference_image_path = reference_image_path
        self.reference_image_window = reference_image_window
        self.shift_pixels = None
        self.shift_arcsec = None
        # the spans of the fit and of return_corrected_header run under the
        # file id of the search that made this result
        self._file_id = obs.current_file()
        with obs.stage("api_fit_s"):
            self.max_index = np.unravel_index(np.nanargmax(corr), corr.shape)
            self._compute_shift()

    # ------------------------------------------------------------------
    def _argmax_shift(self):
        mi = self.max_index
        pa = self.parameters_alignment_arcsec
        self.shift_pixels = (mi[0], mi[1], mi[2], mi[3], mi[4])
        self.shift_arcsec = (
            pa["lag_crval1"][mi[0]],
            pa["lag_crval2"][mi[1]],
            pa["lag_cdelt1"][mi[2]],
            pa["lag_cdelt2"][mi[3]],
            pa["lag_crota"][mi[4]],
        )

    def _compute_shift(self, method: str = "fitting_gaussian"):
        mi = self.max_index
        corr2d = self.corr[:, :, mi[2], mi[3], mi[4], mi[5]]
        lenx, leny = corr2d.shape

        px, py = [mi[0]], [mi[1]]
        for ii in (-2, -1, 0, 1, 2):
            for jj in (-2, -1, 0, 1, 2):
                if ii == 0 and jj == 0:
                    continue
                x, y = mi[0] + ii, mi[1] + jj
                if 0 <= x < lenx and 0 <= y < leny:
                    px.append(x)
                    py.append(y)

        if method != "fitting_gaussian":
            raise NotImplementedError(method)

        if len(px) < 4:
            warnings.warn("Cannot compute shift with Gaussian fitting: not enough points")
            self._argmax_shift()
            return None

        A = (np.float64(px), np.float64(py))
        B = np.float64(corr2d[px, py].ravel())
        p0 = (
            float(corr2d[mi[0], mi[1]]),
            float(mi[0]),
            float(mi[1]),
            1.0,
            1.0,
            0.9,
        )
        bounds = (
            [0.0, mi[0] - 5.0, mi[1] - 5.0, 0.0, 0.0, -10.0],
            [10.0, mi[0] + 5.0, mi[1] + 5.0, 1000.0, 1000.0, 10.0],
        )
        try:
            popt, _ = curve_fit(f=twoD_Gaussian, xdata=A, ydata=B, p0=p0, bounds=bounds)
        except (ValueError, RuntimeError):
            warnings.warn(
                "Gaussian fitting failed, setting shift params as the pixel "
                "of the maximal correlation"
            )
            self._argmax_shift()
            return None

        pa = self.parameters_alignment_arcsec
        lag_x = pa["lag_crval1"]
        lag_y = pa["lag_crval2"]
        shift_x = np.interp(popt[1], np.arange(len(lag_x)), lag_x)
        shift_y = np.interp(popt[2], np.arange(len(lag_y)), lag_y)
        self.shift_pixels = (popt[1], popt[2], mi[2], mi[3], mi[4])
        self.shift_arcsec = (
            float(shift_x),
            float(shift_y),
            pa["lag_cdelt1"][mi[2]],
            pa["lag_cdelt2"][mi[3]],
            pa["lag_crota"][mi[4]],
        )
        return True

    # ------------------------------------------------------------------
    # persistence (framework extension: the reference has no checkpoint
    # mechanism beyond callers saving the returned corr array, SURVEY.md 5)
    # ------------------------------------------------------------------
    def save(self, path: str):
        """Persist the full result (corr hypercube + lags + provenance) to a
        .npz checkpoint; reload with :meth:`AlignmentResults.load`."""
        np.savez_compressed(
            path,
            corr=self.corr,
            unit_lag=np.array(self.unit_lag),
            image_to_align_path=np.array(str(self.image_to_align_path)),
            image_to_align_window=np.array(str(self.image_to_align_window)),
            reference_image_path=np.array(str(self.reference_image_path)),
            reference_image_window=np.array(str(self.reference_image_window)),
            **{k: v for k, v in self.parameters_alignment.items()},
        )

    @classmethod
    def load(cls, path: str) -> "AlignmentResults":
        z = np.load(path, allow_pickle=False)
        return cls(
            corr=z["corr"],
            lag_crval1=z["lag_crval1"],
            lag_crval2=z["lag_crval2"],
            lag_cdelt1=z["lag_cdelt1"],
            lag_cdelt2=z["lag_cdelt2"],
            lag_crota=z["lag_crota"],
            unit_lag=str(z["unit_lag"]),
            image_to_align_path=str(z["image_to_align_path"]),
            image_to_align_window=_maybe_int(str(z["image_to_align_window"])),
            reference_image_path=str(z["reference_image_path"]),
            reference_image_window=_maybe_int(str(z["reference_image_window"])),
        )

    # ------------------------------------------------------------------
    def write_corrected_fits(
        self,
        window_list_to_apply_shift,
        path_to_l3_output: str,
        path_to_l2_input: str | None = None,
    ):
        """Write a copy of the input FITS with corrected pointing headers
        (data untouched, cast to <f4 in corrected windows like the reference,
        Util.py:107-159)."""
        from ..io import fits

        if path_to_l2_input is None:
            if self.image_to_align_path is None:
                raise ValueError("Please provide a path_to_l2_input parameter")
            path_to_l2_input = self.image_to_align_path

        shift = self.shift_arcsec
        hdul = fits.open(path_to_l2_input)
        out = fits.HDUList()
        n = len(hdul)
        corrected = 0
        windows = list(window_list_to_apply_shift)
        for ii, hdu in enumerate(hdul):
            extname = hdu.header.get("EXTNAME", "nothing98695")
            if (extname in windows) or (ii in windows) or ((ii - n) in windows):
                header = hdu.header.copy()
                correct_pointing_header(
                    header,
                    lag_crval1=shift[0],
                    lag_crval2=shift[1],
                    lag_cdelt1=shift[2],
                    lag_cdelt2=shift[3],
                    lag_crota=shift[4],
                )
                data = None if hdu.data is None else np.asarray(hdu.data, dtype=np.float32)
                # re-wrap by input class like the reference (Util.py:143-150):
                # compressed windows stay tile-compressed (quantized <f4)
                # with the input's codec, quantization and tiles (the JAX
                # package writes its writer defaults instead)
                if isinstance(hdu, fits.CompImageHDU):
                    out.append(fits.CompImageHDU(
                        data=data, header=header,
                        **{k: getattr(hdu, k) for k in _COMPRESSION_SETTINGS}))
                else:
                    cls = fits.PrimaryHDU if ii == 0 else fits.ImageHDU
                    out.append(cls(data=data, header=header))
                corrected += 1
            else:
                out.append(hdu)
        # Validate BEFORE publishing: writing first would leave an
        # uncorrected copy on disk that resume= paths (e.g.
        # jitter_correction resume=True) would then trust as done.
        if corrected == 0:
            raise ValueError("has not corrected any window.")
        fits.write(path_to_l3_output, out, overwrite=True)

    def return_corrected_header(self, window, path_to_l2_input: str | None = None):
        from ..io import fits

        if path_to_l2_input is None:
            if self.image_to_align_path is None:
                raise ValueError("Please provide a path_to_l2_input parameter")
            path_to_l2_input = self.image_to_align_path
        with obs.stage("api_corrected_header_s", file=self._file_id):
            hdul = fits.open(path_to_l2_input)
            header = hdul[window].header.copy()
            correct_pointing_header(
                header,
                lag_crval1=self.shift_arcsec[0],
                lag_crval2=self.shift_arcsec[1],
                lag_cdelt1=self.shift_arcsec[2],
                lag_cdelt2=self.shift_arcsec[3],
                lag_crota=self.shift_arcsec[4],
            )
        return header

    def savefig(self, filename: str, **kwargs):
        """Save the correlation figure to ``filename``.

        The reference declares this but leaves it unimplemented
        (``AlignmentResults.py:178-179`` raises NotImplementedError); here it
        delegates to :meth:`plot_correlation`."""
        return self.plot_correlation(path_save_figure=filename, **kwargs)

    def saveyaml(self, filename: str, window=0, path_to_l2_input: str | None = None):
        """Write the corrected pointing keywords plus the fitted shift as
        YAML.  The reference declares this but leaves it unimplemented
        (``AlignmentResults.py:181-184``)."""
        hdr = self.return_corrected_header(window, path_to_l2_input)
        doc = {
            "shift_arcsec": {
                k: float(v) for k, v in zip(
                    ("crval1", "crval2", "cdelt1", "cdelt2", "crota"),
                    self.shift_arcsec)
            },
            "corrected_header": {
                k: (float(hdr[k]) if isinstance(hdr[k], (int, float, np.floating,
                                                         np.integer))
                    else str(hdr[k])) for k in
                ("CRVAL1", "CRVAL2", "CRPIX1", "CRPIX2", "CDELT1", "CDELT2",
                 "PC1_1", "PC1_2", "PC2_1", "PC2_2", "CROTA")
                if k in hdr
            },
            "max_correlation": float(np.nanmax(self.corr)),
        }
        try:
            import yaml

            text = yaml.safe_dump(doc, sort_keys=False)
        except ImportError:  # minimal hand-rolled fallback
            lines = []
            for k, v in doc.items():
                if isinstance(v, dict):
                    lines.append(f"{k}:")
                    lines.extend(f"  {kk}: {vv!r}" for kk, vv in v.items())
                else:
                    lines.append(f"{k}: {v!r}")
            text = "\n".join(lines) + "\n"
        with open(filename, "w") as f:
            f.write(text)
        return filename

    # ------------------------------------------------------------------
    def plot_correlation(self, path_save_figure=None, show=False, fig=None, ax=None):
        from ..plot import plot

        return plot.plot_correlation(
            corr=self.corr,
            show=show,
            path_save_figure=path_save_figure,
            fig=fig,
            ax=ax,
            shift=self.shift_arcsec,
            unit_to_plot=self.unit_lag,
            lag_dx_label=f"CRVAL1 [{self.unit_lag}]",
            lag_dy_label=f"CRVAL2 [{self.unit_lag}]",
            **self.parameters_alignment_arcsec,
        )

    def plot_co_alignment(self, path_save_figure=None, show=False,
                          lonlims=None, latlims=None, **kwargs):
        """Before/after figure (:func:`plot.plot_co_alignment`); pass
        ``device="cpu"`` to resample on the CPU."""
        from ..plot import plot

        return plot.plot_co_alignment(
            reference_image_path=self.reference_image_path,
            reference_image_window=self.reference_image_window,
            image_to_align_path=self.image_to_align_path,
            image_to_align_window=self.image_to_align_window,
            path_save_figure=path_save_figure,
            shift_arcsec=self.shift_arcsec,
            show=show,
            unit_to_plot=self.unit_lag,
            lonlims=lonlims,
            latlims=latlims,
            **kwargs,
        )

    def __str__(self):
        s = self.shift_arcsec
        return (
            f"\n Shift : \n x = {s[0]} '' \n y = {s[1]} '' \n dx = {s[2]} '' "
            f"\n dy = {s[3]} '' \n dcrot = {s[4]} deg"
        )

    __repr__ = __str__
