"""The port's figures (``euispice_coreg_tpu_torch.plot``) against the
committed goldens of ``tests/test_plot_golden.py``, the figures that
``Alignment(path_save_figure=...)`` and jitter's ``path_figures`` save, and
``utils.util_compat`` against the JAX package's, all on the CPU.

The goldens are only read here: a missing golden fails, nothing is written
under ``tests/goldens/``.
"""
import glob
import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import fixtures as fx  # noqa: E402
from euispice_coreg_tpu_torch import Alignment  # noqa: E402
from euispice_coreg_tpu_torch.plot import plot  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
# the tolerances of tests/test_plot_golden.py
PIX_TOL = 12
FRAC_TOL = 0.02


def read_png(path):
    return (plt.imread(path)[..., :3] * 255).astype(np.int16)


def changed_fraction(png_path, name):
    got = read_png(png_path)
    want = read_png(os.path.join(GOLDEN_DIR, name))
    assert got.shape == want.shape, (
        f"{name}: figure geometry {got.shape}, golden {want.shape}")
    return float((np.abs(got - want).max(axis=-1) > PIX_TOL).mean())


def assert_matches_golden(png_path, name):
    frac = changed_fraction(png_path, name)
    assert frac < FRAC_TOL, (
        f"{name}: {frac * 100:.2f}% of pixels changed by more than "
        f"{PIX_TOL}/255")


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    td = tmp_path_factory.mktemp("golden_pair")
    dl, hl, ds, hs = fx.make_helioprojective_pair(true_shift_arcsec=(8.0, -4.0))
    p_large, p_small = fx.write_pair_fits(td, dl, hl, ds, hs)
    A = Alignment(
        large_fov_known_pointing=p_large, small_fov_to_correct=p_small,
        lag_crval1=np.arange(2.0, 15.0, 2.0),
        lag_crval2=np.arange(-10.0, 3.0, 2.0),
        small_fov_window=0, large_fov_window=0, device="cpu",
    )
    return p_large, p_small, A.align_using_helioprojective()


def test_plot_correlation_golden(aligned, tmp_path):
    _, _, res = aligned
    out = str(tmp_path / "corr.png")
    res.plot_correlation(path_save_figure=out)
    assert_matches_golden(out, "plot_correlation.png")


@pytest.mark.parametrize("mode", ["compare_plot", "successive_plot"])
def test_plot_co_alignment_golden(aligned, tmp_path, mode):
    p_large, p_small, res = aligned
    out = str(tmp_path / f"coalign_{mode}.png")
    plot.plot_co_alignment(
        p_large, 0, p_small, 0, shift_arcsec=res.shift_arcsec,
        path_save_figure=out, type_plot=mode, device="cpu")
    assert_matches_golden(out, f"coalign_{mode}.png")


def test_results_plot_co_alignment_golden(aligned, tmp_path):
    """The same figure through ``AlignmentResults.plot_co_alignment``."""
    _, _, res = aligned
    out = str(tmp_path / "coalign_results.png")
    res.plot_co_alignment(path_save_figure=out, type_plot="compare_plot",
                          device="cpu")
    assert_matches_golden(out, "coalign_compare_plot.png")


def test_plot_co_alignment_sunpy_golden(tmp_path):
    dl, hl, ds, hs = fx.make_carrington_pair(true_shift_arcsec=(20.0, -10.0))
    p_large, p_small = fx.write_pair_fits(tmp_path, dl, hl, ds, hs)
    out = str(tmp_path / "coalign_sunpy.png")
    figs = plot.plot_co_alignment(
        p_large, 0, p_small, 0, shift_arcsec=(20.0, -10.0, 0.0, 0.0, 0.0),
        path_save_figure=out, type_plot="sunpy", device="cpu")
    assert len(figs) == 3
    for k in range(3):
        assert_matches_golden(str(tmp_path / f"coalign_sunpy_{k}.png"),
                              f"coalign_sunpy_{k}.png")


def test_plot_fov_golden(tmp_path):
    hdr = fx.make_header((64, 64), (10.0, 10.0))
    out = str(tmp_path / "fov.png")
    plot.plot_fov(fx.render_helioprojective(hdr), path_save=out)
    assert_matches_golden(out, "plot_fov.png")


def test_golden_detects_colormap_change(aligned, tmp_path):
    """A deliberately wrong rendering fails the comparison."""
    _, _, res = aligned
    out = str(tmp_path / "corr_bad.png")
    res.plot_correlation(path_save_figure=out)
    plt.imsave(out, 1.0 - plt.imread(out)[..., :3])
    assert changed_fraction(out, "plot_correlation.png") >= FRAC_TOL


def test_use_style_stays_inside_the_test():
    """``use_style`` changes rcParams; the repository's conftest restores
    them after each test, so later figures keep the goldens' geometry."""
    default_dpi = matplotlib.rcParamsDefault["savefig.dpi"]
    with matplotlib.rc_context():
        plot.use_style()
        assert matplotlib.rcParams["savefig.dpi"] == 150
    assert matplotlib.rcParams["savefig.dpi"] == default_dpi


# ---------------------------------------------------------------------------
# Alignment(path_save_figure=...): the counterparts of test_save_figures.py
# ---------------------------------------------------------------------------

def _helio_alignment(tmp_path, figdir):
    dl, hl, ds, hs = fx.make_helioprojective_pair(true_shift_arcsec=(8.0, -4.0))
    p_large, p_small = fx.write_pair_fits(tmp_path, dl, hl, ds, hs)
    return Alignment(
        large_fov_known_pointing=p_large, small_fov_to_correct=p_small,
        lag_crval1=np.array([4.0, 8.0, 12.0]), lag_crval2=np.array([-4.0]),
        small_fov_window=0, large_fov_window=0,
        path_save_figure=str(figdir), device="cpu")


def _carrington_alignment(tmp_path, figdir):
    dl, hl, ds, hs = fx.make_carrington_pair(true_shift_arcsec=(20.0, -10.0))
    p_large, p_small = fx.write_pair_fits(tmp_path, dl, hl, ds, hs)
    return Alignment(
        large_fov_known_pointing=p_large, small_fov_to_correct=p_small,
        lag_crval1=np.array([15.0, 20.0, 25.0]), lag_crval2=np.array([-10.0]),
        small_fov_window=0, large_fov_window=0,
        path_save_figure=str(figdir), device="cpu")


def assert_figures(figdir, stems):
    for stem in stems:
        hits = glob.glob(str(figdir / (stem + ".pdf")))
        assert len(hits) == 1, f"missing figure {stem}"
        assert os.path.getsize(hits[0]) > 1000


def test_helioprojective_saves_figures(tmp_path):
    figdir = tmp_path / "figs"
    corr = _helio_alignment(tmp_path, figdir).align_using_helioprojective(
        return_type="corr")
    assert np.argmax(corr[:, 0, 0, 0, 0, 0]) == 1
    assert_figures(figdir, ("large_fov_before_cut", "large_fov_2022*",
                            "small_fov_2022*", "compare_plot_2022*"))


def test_carrington_fa_saves_figures(tmp_path):
    figdir = tmp_path / "figs_carr"
    _carrington_alignment(tmp_path, figdir).align_using_carrington(
        lonlims=(115.0, 125.0), latlims=(-2.0, 8.0), shape=(128, 128),
        return_type="corr")
    assert_figures(figdir, ("image_large_2022*", "image_small_2022*"))


def test_sunpy_branch_saves_figures(tmp_path):
    figdir = tmp_path / "figs_ss"
    _carrington_alignment(tmp_path, figdir).align_using_carrington(
        method_carrington_reprojection="sunpy", return_type="corr")
    assert_figures(figdir, ("image_small_2022*", "image_large_2022*",
                            "image_large_rep_2022*"))


def test_no_figures_without_kwarg(tmp_path):
    A = _helio_alignment(tmp_path, tmp_path / "unused")
    A.path_save_figure = None
    A.align_using_helioprojective(return_type="corr")
    assert not os.path.exists(str(tmp_path / "unused"))


def test_jitter_path_figures(tmp_path):
    """``jitter_correction_imagers(path_figures=...)`` saves each aligned
    frame's correlation and before/after figures, and corrects the frames
    as it does without figures."""
    from euispice_coreg_tpu_torch.io import fits
    from euispice_coreg_tpu_torch.jitter_correction import \
        jitter_correction_imagers
    from euispice_coreg_tpu_torch.utils import timeutils

    t0 = timeutils.parse_fits_time("2022-03-17T09:00:00")
    hdr_true = fx.make_header((96, 96), (8.0, 8.0), (40.0, -30.0), 0.3)
    data = fx.render_helioprojective(hdr_true, width_deg=0.005).astype(
        np.float32)
    paths = []
    for k, (ox, oy) in enumerate([(0.0, 0.0), (3.0, -2.0), (-2.0, 3.0)]):
        hdr = hdr_true.copy()
        hdr["CRVAL1"] = hdr_true["CRVAL1"] - ox
        hdr["CRVAL2"] = hdr_true["CRVAL2"] - oy
        hdr["DATE-AVG"] = timeutils.format_fits_time(t0 + 60 * k)
        paths.append(str(tmp_path / f"frame_{k}.fits"))
        fits.write(paths[-1], [fits.PrimaryHDU(data=data, header=hdr)])
    out, figdir = tmp_path / "out", tmp_path / "figs"
    os.makedirs(out)
    os.makedirs(figdir)
    lags = np.arange(-5.0, 5.5, 1.0)
    res = jitter_correction_imagers(
        paths, str(out), lag_crval1=lags, lag_crval2=lags, lag_cdelt1=None,
        lag_cdelt2=None, lag_crota=None, sublist_length=2, overlap=1,
        window_files_input=0, alignement_method="helioprojective",
        path_figures=str(figdir), plot_all_figures=True, device="cpu")
    assert sorted(res) == [1, 2]
    assert len(glob.glob(str(figdir / "correlation_*.pdf"))) == 2
    assert len(glob.glob(str(figdir / "plot_co_alignment_*.pdf"))) == 2
    np.testing.assert_allclose(res[1].shift_arcsec[:2], (3.0, -2.0), atol=0.5)


# ---------------------------------------------------------------------------
# utils.util_compat against the JAX package's
# ---------------------------------------------------------------------------

def test_util_compat_surface():
    """The cases of JAX ``test_util_compat_surface``, each value held
    against the JAX package's."""
    from euispice_coreg_tpu.utils import util_compat as J
    from euispice_coreg_tpu_torch.utils import util_compat as T

    assert T.AlignCommonUtil.ang2pipi(190.0) == pytest.approx(-170.0)
    assert T.AlignEUIUtil.diff_rot(0.3) == J.AlignEUIUtil.diff_rot(0.3) > 0
    hdr = fx.make_spice_l2_header()
    assert T.AlignSpiceUtil.vertical_edges_limits(hdr) == \
        J.AlignSpiceUtil.vertical_edges_limits(hdr) == (3, 563)
    assert T.AlignSpiceUtil.slit_pxl(hdr) == J.AlignSpiceUtil.slit_pxl(hdr)

    hdr_eui = fx.make_header(extra={"DSUN_OBS": 1.0e11})
    lon, lat, dsun = T.AlignEUIUtil.extract_EUI_coordinates(hdr_eui)
    jlon, jlat, _ = J.AlignEUIUtil.extract_EUI_coordinates(hdr_eui)
    assert lon.shape == (128, 128) and dsun == 1.0e11
    np.testing.assert_array_equal(lon, jlon)
    np.testing.assert_array_equal(lat, jlat)

    data = np.random.default_rng(0).uniform(1, 10, (32, 32))
    for stre in (None, "sqrt", "log"):
        norm_t = T.PlotFits.get_range(data, stre=stre)
        norm_j = J.PlotFits.get_range(data, stre=stre)
        assert type(norm_t) is type(norm_j)
        assert (norm_t.vmin, norm_t.vmax) == (norm_j.vmin, norm_j.vmax)

    dates = {"date-avg": ["2022-03-17T09:00:00", "2022-03-17T10:00:30"],
             "dsun-obs": [1e11, 1e11]}
    got = T.AlignCommonUtil.find_closest_dict_index(
        "2022-03-17T10:00:00", dates, threshold_time=60.0)
    assert got == J.AlignCommonUtil.find_closest_dict_index(
        "2022-03-17T10:00:00", dates, threshold_time=60.0)
    assert got[0] == 1 and got[1] == pytest.approx(30.0)
    with pytest.raises(ValueError, match="Delta time"):
        T.AlignCommonUtil.find_closest_dict_index(
            "2022-03-17T20:00:00",
            {"date-avg": ["2022-03-17T09:00:00"], "dsun-obs": [1e11]},
            threshold_time=60.0)


def test_extend_regular_grid():
    from euispice_coreg_tpu.utils import util_compat as J
    from euispice_coreg_tpu_torch.utils import util_compat as T

    lon, lat = np.meshgrid(np.arange(0.0, 1.0, 0.1), np.arange(0.0, 1.0, 0.1))
    lon2, lat2 = T.PlotFits.extend_regular_grid(lon, lat, 0.4, 0.2)
    assert lon2.min() < lon.min() and lon2.max() > lon.max()
    assert lon2.shape[1] > lon.shape[1]
    jlon2, jlat2 = J.PlotFits.extend_regular_grid(lon, lat, 0.4, 0.2)
    np.testing.assert_array_equal(lon2, jlon2)
    np.testing.assert_array_equal(lat2, jlat2)


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_interpol2d_matches_jax(order):
    """``AlignCommonUtil.interpol2d`` and ``core.resample.interpol2d`` (the
    re-export of ``plot``) against the JAX package's, float64, with
    coordinates outside the image (fill) and a ``dst`` buffer."""
    from euispice_coreg_tpu.core import resample as jres
    from euispice_coreg_tpu_torch.core import resample
    from euispice_coreg_tpu_torch.utils.util_compat import AlignCommonUtil

    assert plot.interpol2d is resample.interpol2d
    rng = np.random.default_rng(order)
    img = rng.normal(size=(24, 31))
    x = rng.uniform(-2.0, 33.0, size=(7, 9))
    y = rng.uniform(-2.0, 26.0, size=(7, 9))
    want = np.asarray(jres.interpol2d(img, x, y, fill=-1.0, order=order))
    got = AlignCommonUtil.interpol2d(img, x, y, -1.0, order, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-12)
    assert (got == -1.0).any()
    dst = np.empty_like(x)
    assert AlignCommonUtil.interpol2d(img, x, y, -1.0, order, dst=dst,
                                      device="cpu") is None
    np.testing.assert_array_equal(dst, got)


def test_write_corrected_fits_and_align_pixels_shift(tmp_path):
    """``AlignCommonUtil.write_corrected_fits`` (argmax of a hypercube) and
    ``align_pixels_shift`` give the JAX package's headers."""
    from euispice_coreg_tpu.io import fits as jfits
    from euispice_coreg_tpu.utils import util_compat as J
    from euispice_coreg_tpu_torch.io import fits
    from euispice_coreg_tpu_torch.utils import util_compat as T

    dl, hl, ds, hs = fx.make_helioprojective_pair(true_shift_arcsec=(8.0, -4.0))
    p_large, p_small = fx.write_pair_fits(tmp_path, dl, hl, ds, hs)
    corr = np.zeros((3, 3, 1, 1, 1))
    corr[2, 0] = 1.0
    lags = dict(lag_crval1=[4.0, 6.0, 8.0], lag_crval2=[-4.0, -2.0, 0.0])
    for mod, fio, name in ((T, fits, "t.fits"), (J, jfits, "j.fits")):
        mod.AlignCommonUtil.write_corrected_fits(p_small, [0],
                                                 str(tmp_path / name), corr,
                                                 **lags)
    ht = fits.open(str(tmp_path / "t.fits"))[0].header
    hj = jfits.open(str(tmp_path / "j.fits"))[0].header
    for k in ("CRVAL1", "CRVAL2", "CRPIX1", "CRPIX2", "PC1_1", "PC2_2"):
        assert ht[k] == hj[k], k
    assert ht["CRVAL1"] == pytest.approx(hs["CRVAL1"] + 8.0)

    got = T.AlignCommonUtil.align_pixels_shift(2, -3, [0], p_large, 0, p_small)
    want = J.AlignCommonUtil.align_pixels_shift(2, -3, [0], p_large, 0,
                                                p_small)
    for k in ("CRVAL1", "CRVAL2", "CRPIX1", "CRPIX2"):
        assert got[k] == pytest.approx(want[k], abs=1e-9), k
