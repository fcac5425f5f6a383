"""The port's synthetic-raster builder against the JAX package's, on the
same FITS files (the imager series of tests/test_spice.py) on the CPU."""
import numpy as np
import pytest
import torch

import fixtures as fx
from euispice_coreg_tpu.hdrshift.alignment_spice import (
    _apply_full_lag as j_apply_full_lag,
    _capture_pointing_refs as j_capture_refs,
)
from euispice_coreg_tpu.io import fits as jfits
from euispice_coreg_tpu.synras import SPICEComposedMapBuilder as JBuilder
from euispice_coreg_tpu.utils import timeutils
from euispice_coreg_tpu_torch.io import fits
from euispice_coreg_tpu_torch.synras import SPICEComposedMapBuilder

T0 = timeutils.parse_fits_time("2022-03-17T09:45:00")


def write_imagers(tmp_path, n_frames=3):
    """Imager frames 120 s apart spanning the raster (tests/test_spice.py
    make_imager_series)."""
    paths = []
    for k in range(n_frames):
        hdr = fx.make_header((196, 196), (12.0, 12.0), (0.0, 0.0), 0.0)
        hdr["DATE-AVG"] = timeutils.format_fits_time(T0 + k * 120.0)
        hdr["DATE-OBS"] = timeutils.format_fits_time(T0 + k * 120.0 - 5.0)
        p = str(tmp_path / f"imager_{k}.fits")
        jfits.write(p, [jfits.PrimaryHDU(
            data=fx.render_helioprojective(hdr).astype(np.float32),
            header=hdr)])
        paths.append(p)
    return paths


def l3_header(hdr2):
    """An L3 header (FITS axes coefficient, x, y, t) with the L2 header's
    spatial WCS and raster timing."""
    hdr = fx.make_spice_l2_header()
    out = {"NAXIS": 4, "NAXIS1": 2, "CTYPE1": "COEFF", "CUNIT1": "",
           "CRVAL1": 0.0, "CRPIX1": 1.0, "CDELT1": 1.0, "PC1_1": 1.0}
    for src, dst in ((1, 2), (2, 3), (4, 4)):
        for key in ("NAXIS", "CTYPE", "CUNIT", "CRVAL", "CRPIX", "CDELT"):
            out[f"{key}{dst}"] = hdr2[f"{key}{src}"]
    out.update({"PC2_2": hdr["PC1_1"], "PC2_3": hdr["PC1_2"],
                "PC3_2": hdr["PC2_1"], "PC3_3": hdr["PC2_2"],
                "PC4_4": 1.0, "PC4_2": hdr["PC4_1"]})
    for key in ("DATEREF", "DATE-BEG", "DATE-OBS", "DATE-AVG", "DETECTOR"):
        out[key] = hdr[key]
    return type(hdr)(out)


def write_spice(tmp_path, level=2, dt_per_step=5.0, **kw):
    hdr = fx.make_spice_l2_header(nx=48, ny=64, dt_per_step=dt_per_step, **kw)
    cube = fx.render_spice_l2_cube(hdr)
    if level == 3:
        hdr = l3_header(hdr)
        cube = np.moveaxis(cube[:, :2], 1, -1)  # (t, y, x, coefficient)
    p = str(tmp_path / f"solo_L{level}_spice.fits")
    jfits.write(p, [jfits.PrimaryHDU(data=cube.astype(np.float32),
                                     header=hdr)])
    return p


def builders(p_spice, paths, threshold=600.0):
    kw = dict(path_to_spectro=p_spice, list_imager_paths=paths,
              threshold_time=threshold, window_imager=0, window_spectro=0)
    return JBuilder(**kw), SPICEComposedMapBuilder(**kw, device="cpu")


def assert_headers_equal(got, want):
    assert list(got.keys()) == list(want.keys())
    for k in want.keys():
        if isinstance(want[k], float):
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-15), k
        else:
            assert got[k] == want[k], k


def assert_rasters_close(got, want, rtol=1e-5):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("level,keep", [(2, False), (3, False), (2, True)])
def test_process_matches_jax(tmp_path, level, keep):
    """``process`` writes the composed raster: data within 1e-5 relative
    (both sample in float32), header cards equal, the same frames chosen;
    L2, L3 and ``keep_original_imager_pixel_size`` (the imager's 12"
    pitch: 16 columns, CRPIX recentred)."""
    paths = write_imagers(tmp_path)
    p_spice = write_spice(tmp_path, level=level)
    jb, tb = builders(p_spice, paths)
    out = {}
    for name, b in (("jax", jb), ("torch", tb)):
        out[name] = b.process(folder_path_output=str(tmp_path),
                              basename_output=f"composed_{name}.fits",
                              print_filename=False, level=level,
                              keep_original_imager_pixel_size=keep,
                              return_synras_name=True)
    hdu_j, hdu_t = jfits.open(out["jax"])[0], fits.open(out["torch"])[0]
    assert_rasters_close(hdu_t.data, hdu_j.data)
    assert_headers_equal(hdu_t.header, hdu_j.header)
    np.testing.assert_array_equal(tb.dates_selected, jb.dates_selected)
    assert tb.get_path_to_composed_map() == out["torch"]
    assert np.isfinite(hdu_t.data).mean() > 0.9
    if keep:
        assert hdu_t.data.shape[1] == len(np.arange(0, 48, 12.0 / 4.0))
        assert hdu_t.header["CDELT1"] == pytest.approx(12.0 / 3600.0)
        assert hdu_t.header["CRPIX1"] == (hdu_t.data.shape[1] + 1) / 2


def test_time_matching_and_threshold_match_jax(tmp_path):
    """Each column takes the frame closest to its exposure (column 0 at
    t0 -> frame 0, column 47 at t0 + 235 s -> frame 2), as the JAX
    package's; a column farther than ``threshold_time`` from every frame
    raises the same error in both."""
    paths = write_imagers(tmp_path)
    hdr = fx.make_spice_l2_header(nx=48, ny=64, dt_per_step=5.0)
    hdr.update({"CRVAL4": 0.0, "CRPIX4": 1.0, "CRPIX1": 1.0})
    p_spice = str(tmp_path / "solo_L2_spice_t.fits")
    jfits.write(p_spice, [jfits.PrimaryHDU(
        data=fx.render_spice_l2_cube(hdr).astype(np.float32), header=hdr)])
    jb, tb = builders(p_spice, paths)
    for b in (jb, tb):
        b.process_from_header(hdr, level=2)
    np.testing.assert_array_equal(tb.dates_selected, jb.dates_selected)
    assert tb.dates_selected[0] == pytest.approx(T0)
    assert tb.dates_selected[-1] == pytest.approx(T0 + 240.0)
    assert_rasters_close(tb.data_composed, jb.data_composed)
    assert_headers_equal(tb.hdr_composed, jb.hdr_composed)

    p_slow = write_spice(tmp_path, dt_per_step=60.0)
    for b in builders(p_slow, paths[:1], threshold=10.0):
        with pytest.raises(ValueError, match="sufficiently close in time"):
            b.process(folder_path_output=str(tmp_path), level=2,
                      print_filename=False)


def lag_headers(hdr, lags_arcsec):
    """``hdr`` shifted by each (crval1, crval2, cdelt1, crota) lag (arcsec,
    degrees of roll), as the iterative context raster shifts it."""
    refs = j_capture_refs(hdr)
    out = []
    for d1, d2, d3, d5 in lags_arcsec:
        h = hdr.copy()
        j_apply_full_lag(h, refs, d1 / 3600.0, d2 / 3600.0, d3 / 3600.0,
                         0.0, d5)
        out.append(h)
    return out


LAGS = [(0.0, 0.0, 0.0, 0.0), (2.0, -1.0, 0.0, 0.0), (-3.0, 2.0, 0.0, 1.5),
        (1.0, 1.0, 0.2, -1.0)]


def test_compose_many_matches_jax_and_per_header_process(tmp_path):
    """``compose_many_from_headers`` over four shifted headers (crval,
    crota and cdelt lags): each raster within 1e-6 relative of the port's
    own ``process_from_header`` on that header, and within 1e-5 of the
    JAX package's batched compose; composed headers equal; with
    ``as_numpy=False`` the same values as a tensor on the device."""
    paths = write_imagers(tmp_path)
    p_spice = write_spice(tmp_path)
    jb, tb = builders(p_spice, paths)
    hdrs = lag_headers(fits.open(p_spice)[0].header, LAGS)
    data_t, hdrs_t = tb.compose_many_from_headers(hdrs)
    data_j, hdrs_j = jb.compose_many_from_headers(hdrs)
    assert data_t.shape == data_j.shape == (4, 64, 48)
    assert_rasters_close(data_t, data_j)
    for ht, hj in zip(hdrs_t, hdrs_j):
        assert_headers_equal(ht, hj)
    np.testing.assert_array_equal(tb.data_composed, data_t[-1])
    for k, hdr in enumerate(hdrs):
        tb.process_from_header(hdr)
        assert_rasters_close(data_t[k], tb.data_composed, rtol=1e-6)
        assert_headers_equal(hdrs_t[k], tb.hdr_composed)
    dev, _ = tb.compose_many_from_headers(hdrs, as_numpy=False)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float64
    np.testing.assert_array_equal(dev.numpy(), data_t)


def test_compose_many_checks_raise_as_jax(tmp_path):
    """The consistency checks of ``compose_many_from_headers``: spatial
    headers with ``keep_original_imager_pixel_size``, a spatial-header
    count mismatch, and cdelt lags under ``keep_original_imager_pixel_size``
    (grids that differ per lag) raise in both packages."""
    paths = write_imagers(tmp_path)
    p_spice = write_spice(tmp_path)
    hdrs = lag_headers(fits.open(p_spice)[0].header, LAGS)
    for b in builders(p_spice, paths):
        with pytest.raises(ValueError, match="lag-independent"):
            b.compose_many_from_headers(hdrs[:2], spatial_headers=hdrs[:2],
                                        keep_original_imager_pixel_size=True)
        with pytest.raises(ValueError, match="length mismatch"):
            b.compose_many_from_headers(hdrs[:2], spatial_headers=hdrs[:1])
        with pytest.raises(ValueError, match="pixel grids differ"):
            b.compose_many_from_headers(hdrs, keep_original_imager_pixel_size=True)
