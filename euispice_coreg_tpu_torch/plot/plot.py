"""Diagnostic plotting (host-side, matplotlib).

Counterpart of ``euispice_coreg_tpu/plot/plot.py``: a rebuild of the
reference's plotting toolkit (``euispice_coreg/plot/plot.py``) without
astropy visualization helpers; normalization stretches are implemented
inline.  matplotlib is imported inside the functions, so the package works
without it.  The figures that resample an image onto a world grid
(:func:`simple_plot`, :func:`contour_plot` and the functions built on them)
sample on ``device`` (``"cuda"`` unless the caller asks for the CPU); the
figure itself is drawn on the host.
"""
from __future__ import annotations

import numpy as np

from ..utils import coords, units


def _power_norm(corr, a=3, vmin_percentile=30):
    """PowerStretch(a=3) with a percentile floor, like plot.py:135-138."""
    import matplotlib.colors as mcolors

    finite = corr[np.isfinite(corr)]
    vmin = np.percentile(finite, vmin_percentile) if finite.size else 0.0
    vmax = np.nanmax(corr) if finite.size else 1.0
    return mcolors.PowerNorm(gamma=a, vmin=vmin, vmax=vmax)


def plot_correlation(
    corr,
    lag_crval1,
    lag_crval2,
    lag_crota=None,
    lag_cdelt1=None,
    lag_cdelt2=None,
    path_save_figure=None,
    fig=None,
    ax=None,
    show=False,
    lag_dx_label="CRVAL1 [arcsec]",
    lag_dy_label="CRVAL2 [arcsec]",
    shift=None,
    unit_to_plot="arcsec",
):
    """Correlation heatmap at the argmax of the trailing axes
    (plot.py:55-178): crval1 on x, crval2 on y, argmax cell boxed, shift
    cross-hairs, text box with the shift values."""
    import matplotlib.patches as patches
    from matplotlib import pyplot as plt

    corr = np.asarray(corr)
    if corr.ndim == 5:
        corr = corr[..., np.newaxis]
    max_index = np.unravel_index(np.nanargmax(corr), corr.shape)
    corr2d = corr[:, :, max_index[2], max_index[3], max_index[4], max_index[5]]

    unit = {"arcsec": "''", "deg": "°"}.get(unit_to_plot)
    if unit is None:
        raise NotImplementedError(f"unit_to_plot={unit_to_plot!r}")

    if fig is None:
        fig = plt.figure()
    if ax is None:
        ax = fig.add_subplot()

    lag_dx = units.convert(np.asarray(lag_crval1, dtype=float), "arcsec", unit_to_plot)
    lag_dy = units.convert(np.asarray(lag_crval2, dtype=float), "arcsec", unit_to_plot)
    dx = lag_dx[1] - lag_dx[0] if len(lag_dx) > 1 else 1.0
    dy = lag_dy[1] - lag_dy[0] if len(lag_dy) > 1 else 1.0

    def _opt(v):
        return np.atleast_1d(np.asarray(v, dtype=float)) if v is not None else np.array([0.0])

    lag_cdelt1_ = units.convert(_opt(lag_cdelt1), "arcsec", unit_to_plot)
    lag_cdelt2_ = units.convert(_opt(lag_cdelt2), "arcsec", unit_to_plot)
    lag_crota_ = _opt(lag_crota)

    if shift is None:
        shift = (
            lag_dx[max_index[0]],
            lag_dy[max_index[1]],
            lag_cdelt1_[max_index[2]],
            lag_cdelt2_[max_index[3]],
            lag_crota_[max_index[4]],
        )
    else:
        shift = (
            units.convert(shift[0], "arcsec", unit_to_plot),
            units.convert(shift[1], "arcsec", unit_to_plot),
            units.convert(shift[2], "arcsec", unit_to_plot),
            units.convert(shift[3], "arcsec", unit_to_plot),
            shift[4],
        )

    norm = _power_norm(corr2d)
    im = ax.imshow(
        corr2d.T,
        origin="lower",
        interpolation="none",
        norm=norm,
        cmap="plasma",
        extent=(
            lag_dx[0] - 0.5 * dx, lag_dx[-1] + 0.5 * dx,
            lag_dy[0] - 0.5 * dy, lag_dy[-1] + 0.5 * dy,
        ),
    )
    rect = patches.Rectangle(
        (lag_dx[max_index[0]] - 0.5 * dx, lag_dy[max_index[1]] - 0.5 * dy),
        dx, dy, edgecolor="r", linewidth=0.3, facecolor="none",
    )
    ax.add_patch(rect)
    ax.axhline(y=shift[1], color="r", linestyle="--", linewidth=0.5)
    ax.axvline(x=shift[0], color="r", linestyle="--", linewidth=0.5)

    if (lag_crota is not None) and (lag_cdelt1 is None):
        text = "\n".join([
            rf"$dx={shift[0]:.3f}$ {unit}",
            rf"$dy={shift[1]:.3f}$ {unit}",
            rf"$drota={shift[4]:.3f}$ $^\circ$",
            rf"max_cc = {np.nanmax(corr2d):.3f}",
        ])
    elif (lag_crota is not None) and (lag_cdelt1 is not None):
        text = "\n".join([
            rf"$dx={shift[0]:.3f}$ {unit}",
            rf"$dy={shift[1]:.3f}$ {unit}",
            rf"$drota={shift[4]:.3f}$ $^\circ$",
            rf"$cdelt1={shift[2]:.3f}$ $^\circ$",
            rf"$cdelt2={shift[3]:.3f}$ $^\circ$",
            rf"max_cc = {np.nanmax(corr2d):.3f}",
        ])
    else:
        text = "\n".join([
            rf"$\delta CRVAL1={shift[0]:.3f}$ {unit}",
            rf"$\delta CRVAL2={shift[1]:.3f}$ {unit}",
            rf"max_cc = {np.nanmax(corr2d):.3f}",
        ])
    ax.text(
        0.05, 0.95, text, transform=ax.transAxes, fontsize=7,
        verticalalignment="top",
        bbox=dict(boxstyle="round", facecolor="wheat", alpha=0.5),
    )
    ax.set_xlabel(lag_dx_label)
    ax.set_ylabel(lag_dy_label)
    fig.colorbar(im, ax=ax, label="correlation")
    if show:
        fig.show()
    if path_save_figure is not None:
        fig.tight_layout()
        fig.savefig(path_save_figure)
    return fig, ax


def plot_fov(data, path_save=None, show=False, fig=None, ax=None,
             norm=None, extent=None, xlabel=None, ylabel=None,
             plot_colorbar=True):
    """Simple image plot (PlotFits.plot_fov, Util.py:726-742)."""
    from matplotlib import pyplot as plt
    import matplotlib.colors as mcolors

    if fig is None:
        fig = plt.figure()
    if ax is None:
        ax = fig.add_subplot()
    if norm is None:
        finite = np.asarray(data)[np.isfinite(data)]
        if finite.size and np.nanmin(finite) > 0:
            norm = mcolors.LogNorm()
        else:
            norm = None
    im = ax.imshow(data, origin="lower", interpolation="none", norm=norm, extent=extent)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    if plot_colorbar:
        fig.colorbar(im, ax=ax)
    if show:
        fig.show()
    if path_save is not None:
        fig.savefig(path_save)
    return fig, ax


def simple_plot(hdr_main, data_main, path_save=None, show=False, ax=None,
                fig=None, norm=None, show_xlabel=True, show_ylabel=True,
                plot_colorbar=True, cmap="plasma", device="cuda"):
    """Image on a regular world grid (PlotFits.simple_plot, Util.py:744-786)."""
    from matplotlib import pyplot as plt

    from ..engine import lag_search as _ls

    lon, lat = coords.header_world_grid(hdr_main)
    long, latg, dlon, dlat = coords.build_regular_grid(lon, lat)
    x, y = coords.world_to_pixel_of_header(hdr_main, long, latg)
    img = _ls.resample_to_grid(np.asarray(data_main, dtype=np.float64), x, y,
                               order=1, device=device)

    if fig is None:
        fig = plt.figure()
    if ax is None:
        ax = fig.add_subplot()
    ext = [
        units.convert(long[0, 0], "deg", "arcsec") - 0.5 * dlon * 3600,
        units.convert(long[-1, -1], "deg", "arcsec") + 0.5 * dlon * 3600,
        units.convert(latg[0, 0], "deg", "arcsec") - 0.5 * dlat * 3600,
        units.convert(latg[-1, -1], "deg", "arcsec") + 0.5 * dlat * 3600,
    ]
    im = ax.imshow(img, origin="lower", interpolation="none", norm=norm,
                   extent=ext, cmap=cmap)
    if show_xlabel:
        ax.set_xlabel("Solar-X [arcsec]")
    if show_ylabel:
        ax.set_ylabel("Solar-Y [arcsec]")
    if plot_colorbar:
        label = hdr_main.get("BUNIT", "")
        fig.colorbar(im, ax=ax, label=label)
    if show:
        fig.show()
    if path_save is not None:
        fig.savefig(path_save)
    return im


def contour_plot(hdr_main, data_main, hdr_contour, data_contour,
                 path_save=None, show=False, levels=None, ax=None, fig=None,
                 norm=None, show_xlabel=True, show_ylabel=True,
                 plot_colorbar=True, device="cuda"):
    """Base image + contours of a second image on a shared regular grid
    (PlotFits.contour_plot, Util.py:788-843)."""
    from matplotlib import pyplot as plt

    from ..engine import lag_search as _ls

    lon, lat = coords.header_world_grid(hdr_contour)
    long, latg, dlon, dlat = coords.build_regular_grid(lon, lat)

    x_m, y_m = coords.world_to_pixel_of_header(hdr_main, long, latg)
    img_main = _ls.resample_to_grid(np.asarray(data_main, dtype=np.float64),
                                    x_m, y_m, order=1, device=device)
    x_c, y_c = coords.world_to_pixel_of_header(hdr_contour, long, latg)
    img_con = _ls.resample_to_grid(np.asarray(data_contour, dtype=np.float64),
                                   x_c, y_c, order=1, device=device)

    if fig is None:
        fig = plt.figure()
    if ax is None:
        ax = fig.add_subplot()
    ext = [
        units.convert(long[0, 0], "deg", "arcsec") - 0.5 * dlon * 3600,
        units.convert(long[-1, -1], "deg", "arcsec") + 0.5 * dlon * 3600,
        units.convert(latg[0, 0], "deg", "arcsec") - 0.5 * dlat * 3600,
        units.convert(latg[-1, -1], "deg", "arcsec") + 0.5 * dlat * 3600,
    ]
    im = ax.imshow(img_main, origin="lower", interpolation="none", norm=norm, extent=ext)
    if levels is None:
        levels = [0.5 * np.nanmax(img_con)]
    ax.contour(img_con, levels=levels, origin="lower", linewidths=0.5,
               colors="w", extent=ext)
    if show_xlabel:
        ax.set_xlabel("Solar-X [arcsec]")
    if show_ylabel:
        ax.set_ylabel("Solar-Y [arcsec]")
    if plot_colorbar:
        fig.colorbar(im, ax=ax, label=hdr_main.get("BUNIT", ""))
    if show:
        fig.show()
    if path_save is not None:
        fig.savefig(path_save)
    return im


def compare_plot(hdr_main, data_main, hdr_contour_1, data_contour_1,
                 hdr_contour_2, data_contour_2, norm=None, path_save=None,
                 show=False, levels=None, device="cuda"):
    """Before/after contour comparison (PlotFits.compare_plot,
    Util.py:845-871)."""
    from matplotlib import pyplot as plt
    from matplotlib.gridspec import GridSpec

    fig = plt.figure(figsize=(10, 5))
    gs = GridSpec(1, 3, width_ratios=[1, 1, 0.1], wspace=0.3)
    ax1 = fig.add_subplot(gs[0])
    ax2 = fig.add_subplot(gs[1])
    ax_cbar = fig.add_subplot(gs[2])

    contour_plot(hdr_main, data_main, hdr_contour_1, data_contour_1,
                 plot_colorbar=False, show=False, levels=levels,
                 fig=fig, ax=ax1, norm=norm, device=device)
    im = contour_plot(hdr_main, data_main, hdr_contour_2, data_contour_2,
                      show_ylabel=False, plot_colorbar=False, show=False,
                      levels=levels, fig=fig, ax=ax2, norm=norm,
                      device=device)
    fig.colorbar(im, cax=ax_cbar, label=hdr_main.get("BUNIT", ""))
    if show:
        fig.show()
    if path_save is not None:
        fig.savefig(path_save)
    return fig


def plot_co_alignment(
    reference_image_path,
    reference_image_window,
    image_to_align_path,
    image_to_align_window,
    shift_arcsec,
    path_save_figure=None,
    show=False,
    unit_to_plot="arcsec",
    lonlims=None,
    latlims=None,
    type_plot="compare_plot",
    levels_percentile=80,
    device="cuda",
    **kwargs,
):
    """Before/after co-alignment figure (plot.py:607-925): reload both FITS,
    apply the corrected header, show reference image with contours of the
    image-to-align before and after correction."""
    from ..core.header import correct_pointing_header
    from ..io import fits

    ref_hdul = fits.open(reference_image_path)
    ref = ref_hdul[reference_image_window]
    al_hdul = fits.open(image_to_align_path)
    al = al_hdul[image_to_align_window]

    hdr_before = al.header.copy()
    hdr_after = al.header.copy()
    correct_pointing_header(
        hdr_after,
        lag_crval1=shift_arcsec[0],
        lag_crval2=shift_arcsec[1],
        lag_cdelt1=shift_arcsec[2],
        lag_cdelt2=shift_arcsec[3],
        lag_crota=shift_arcsec[4],
    )
    data_al = np.asarray(al.data, dtype=np.float64)
    data_ref = np.asarray(ref.data, dtype=np.float64)
    levels = [np.nanpercentile(data_al, levels_percentile)]
    if type_plot == "compare_plot":
        fig = compare_plot(
            ref.header, data_ref, hdr_before, data_al, hdr_after, data_al,
            path_save=path_save_figure, show=show, levels=levels,
            device=device,
        )
        return fig
    if type_plot == "successive_plot":
        return successive_plot(
            ref.header, data_ref, hdr_before, hdr_after, data_al,
            path_save=path_save_figure, show=show, levels=levels,
            device=device,
        )
    if type_plot == "sunpy":
        return _solar_surface_pages(
            ref.header, data_ref, hdr_before, hdr_after, data_al,
            path_save=path_save_figure, show=show, device=device,
        )
    raise NotImplementedError(f"type_plot={type_plot!r}")


def _solar_surface_pages(hdr_ref, data_ref, hdr_before, hdr_after, data_al,
                         path_save=None, show=False, device="cuda"):
    """Native stand-in for the reference's ``type_plot="sunpy"`` branch
    (plot.py:887-925): a multi-page figure set where the reference image,
    the shifted image and the unshifted image are each reprojected onto the
    image-to-align's WCS assuming solar-surface corotation, then shown with
    :func:`simple_plot` semantics.  Requires the solar observer keywords
    (DSUN_OBS/CRLN_OBS/CRLT_OBS/DATE-OBS) in both headers."""
    from matplotlib import pyplot as plt

    from ..engine.carrington import reproject_solar_surface

    figs = []
    pdf = None
    if path_save is not None and str(path_save).lower().endswith(".pdf"):
        from matplotlib.backends.backend_pdf import PdfPages

        pdf = PdfPages(path_save)
    try:
        pages = [
            (data_ref, hdr_ref, "Reference image"),
            (data_al, hdr_after, "to align image shifted"),
            (data_al, hdr_before, "to align not Shifted"),
        ]
        for k, (data, hdr, title) in enumerate(pages):
            rep = reproject_solar_surface(data, hdr, hdr_before, order=1,
                                          device=device)
            fig, ax = plt.subplots(figsize=(6, 6))
            simple_plot(hdr_before, rep, fig=fig, ax=ax, show=False,
                        device=device)
            ax.set_title(title)
            figs.append(fig)
            if pdf is not None:
                pdf.savefig(fig)
            elif path_save is not None:
                root, dot, ext = str(path_save).rpartition(".")
                fig.savefig(f"{root}_{k}{dot}{ext}" if dot else
                            f"{path_save}_{k}")
            if show:
                fig.show()
    finally:
        if pdf is not None:
            pdf.close()
    return figs


def successive_plot(hdr_ref, data_ref, hdr_before, hdr_after, data_al,
                    path_save=None, show=False, levels=None, norm=None,
                    device="cuda"):
    """Three-panel figure: the image to align, then the reference with its
    contours before and after the pointing correction (the reference's
    'successive_plot' mode, plot.py:607-925)."""
    from matplotlib import pyplot as plt
    from matplotlib.gridspec import GridSpec

    fig = plt.figure(figsize=(14, 5))
    gs = GridSpec(1, 4, width_ratios=[1, 1, 1, 0.08], wspace=0.35)
    ax0 = fig.add_subplot(gs[0])
    ax1 = fig.add_subplot(gs[1])
    ax2 = fig.add_subplot(gs[2])
    ax_cbar = fig.add_subplot(gs[3])

    simple_plot(hdr_before, data_al, fig=fig, ax=ax0, show=False,
                plot_colorbar=False, norm=norm, device=device)
    ax0.set_title("image to align")
    contour_plot(hdr_ref, data_ref, hdr_before, data_al, fig=fig, ax=ax1,
                 show=False, plot_colorbar=False, levels=levels, norm=norm,
                 show_ylabel=False, device=device)
    ax1.set_title("before correction")
    im = contour_plot(hdr_ref, data_ref, hdr_after, data_al, fig=fig, ax=ax2,
                      show=False, plot_colorbar=False, levels=levels,
                      norm=norm, show_ylabel=False, device=device)
    ax2.set_title("after correction")
    fig.colorbar(im, cax=ax_cbar, label=hdr_ref.get("BUNIT", ""))
    if show:
        fig.show()
    if path_save is not None:
        fig.savefig(path_save)
    return fig


def use_style():
    """Activate the package plot style (plot/euicoreg.mplstyle), the
    counterpart of the reference's perso.mplstyle."""
    import os

    from matplotlib import pyplot as plt

    plt.style.use(os.path.join(os.path.dirname(__file__), "euicoreg.mplstyle"))


def plot_fov_rectangle(data, slc=None, path_save=None, show=False,
                       plot_colorbar=True, norm=None, angle=0):
    """Image with a highlighted rectangle (PlotFits.plot_fov_rectangle,
    Util.py:710-723)."""
    import matplotlib.patches as patches
    from matplotlib import pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot()
    plot_fov(data, show=False, fig=fig, ax=ax, norm=norm,
             plot_colorbar=plot_colorbar)
    rect = patches.Rectangle(
        (slc[1].start, slc[0].start),
        slc[1].stop - slc[1].start, slc[0].stop - slc[0].start,
        linewidth=1, edgecolor="r", facecolor="none", angle=angle,
    )
    ax.add_patch(rect)
    if show:
        fig.show()
    if path_save is not None:
        fig.savefig(path_save)
    return fig, ax


def simple_plot_sunpy(m_main, path_save=None, show=False, ax=None, fig=None,
                      norm=None, show_xlabel=True, show_ylabel=True,
                      plot_colorbar=True, cmap="plasma", rsun=None,
                      device="cuda"):
    """Native equivalent of the reference's sunpy-Map figure helper
    (``euispice_coreg/plot/plot.py:228-257``).

    Accepts any "map-like" input instead of a ``sunpy.map.Map``: an object
    with ``.data`` and ``.meta`` (sunpy duck type), an HDU with ``.data`` and
    ``.header``, or a ``(data, header)`` pair.  The image is rendered on a
    regular world grid in arcsec via :func:`simple_plot` (the reference plots
    through the Map's WCS projection; the world-grid rendering is the same
    helioprojective frame).  ``rsun`` is accepted for signature parity but
    unused (it only sets the assumed limb radius on the sunpy Map)."""
    from matplotlib import pyplot as plt

    from ..core.header import Header

    if isinstance(m_main, (tuple, list)) and len(m_main) == 2:
        data, meta = m_main
    elif hasattr(m_main, "meta"):
        data, meta = m_main.data, m_main.meta
    elif hasattr(m_main, "header"):
        data, meta = m_main.data, m_main.header
    else:
        raise TypeError(
            "m_main must be a (data, header) pair or have .data/.meta")
    hdr = meta if isinstance(meta, Header) else Header(dict(meta))
    data = np.asarray(data, dtype=np.float64)

    if norm is None:
        from ..utils.util_compat import PlotFits

        norm = PlotFits.get_range(data, stre=None)
    if fig is None:
        fig = plt.figure()
    if ax is None:
        ax = fig.add_subplot()
    im = simple_plot(hdr, data, fig=fig, ax=ax, norm=norm, cmap=cmap,
                     show_xlabel=show_xlabel, show_ylabel=show_ylabel,
                     plot_colorbar=plot_colorbar, show=False, device=device)
    if show:
        fig.show()
    if path_save is not None:
        fig.savefig(path_save)
    return im


# re-export for drop-in parity with the reference's plot namespace
# (euispice_coreg/plot/plot.py:23-51 defines its own
# interpol2d copy; one canonical implementation lives in core/resample)
from ..core.resample import interpol2d  # noqa: E402,F401


class PlotFunctions:
    """Namespace-class parity surface for the reference's ``PlotFunctions``
    (``euispice_coreg/plot/plot.py:54``, staticmethod-only).
    The implementations are this module's functions; ``simple_plot_sunpy``
    takes map-like input (no sunpy dependency)."""

    plot_correlation = staticmethod(plot_correlation)
    plot_fov = staticmethod(plot_fov)
    plot_fov_rectangle = staticmethod(plot_fov_rectangle)
    simple_plot = staticmethod(simple_plot)
    simple_plot_sunpy = staticmethod(simple_plot_sunpy)
    contour_plot = staticmethod(contour_plot)
    compare_plot = staticmethod(compare_plot)
    successive_plot = staticmethod(successive_plot)
    plot_co_alignment = staticmethod(plot_co_alignment)
