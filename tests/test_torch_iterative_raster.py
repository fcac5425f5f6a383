"""The port's iterative context raster, ``AlignmentSpicePixel`` and the
selector-driven SPICE alignment against the JAX package's, on the same
FITS files on the CPU."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

import fixtures as fx
from euispice_coreg_tpu.engine import fast_corr as jfast
from euispice_coreg_tpu.engine import lag_search as jlag
from euispice_coreg_tpu.hdrshift import alignment_spice as jspice
from euispice_coreg_tpu.hdrshift.alignment_spice_selector import \
    AlignmentSpiceSelector as JSelectorAlignment
from euispice_coreg_tpu.io import fits as jfits
from euispice_coreg_tpu.pxlshift import AlignmentSpicePixel as JSpicePixel
from euispice_coreg_tpu.utils import timeutils
from euispice_coreg_tpu_torch.hdrshift import (
    AlignementSpiceIterativeContextRaster)
from euispice_coreg_tpu_torch.hdrshift import alignment_spice as tspice
from euispice_coreg_tpu_torch.hdrshift.alignment_spice_selector import \
    AlignmentSpiceSelector
from euispice_coreg_tpu_torch.pxlshift import AlignmentSpicePixel
from euispice_coreg_tpu_torch.selector import Selector

T0 = timeutils.parse_fits_time("2022-03-17T09:45:00")


def test_apply_full_lag_matches_jax():
    """``_capture_pointing_refs``/``_apply_full_lag`` (crval, cdelt and
    crota lags; CROTA2-only headers; an all-zero cdelt/crota lag leaves PC
    and CROTA untouched): every card equal to the JAX package's."""
    for crota_key in ("CROTA", "CROTA2"):
        hdr = fx.make_spice_l2_header(crota_deg=1.5)
        if crota_key == "CROTA2":
            hdr["CROTA2"] = hdr.pop("CROTA")
        assert tspice._capture_pointing_refs(hdr) == \
            jspice._capture_pointing_refs(hdr)
        refs = tspice._capture_pointing_refs(hdr)
        for lag in ((0.001, -0.002, 1e-4, 5e-5, 2.0), (0.001, 0.0, 0.0, 0.0,
                                                        0.0)):
            got, want = hdr.copy(), hdr.copy()
            tspice._apply_full_lag(got, refs, *lag)
            jspice._apply_full_lag(want, refs, *lag)
            assert dict(got.items()) == dict(want.items())
        assert got["PC1_1"] == hdr["PC1_1"] and got[crota_key] == 1.5


def write_imager_series(tmp_path, n=2):
    """tests/test_iterative_raster.py's two imager frames 150 s apart."""
    paths = []
    for k in range(n):
        hdr = fx.make_header((196, 196), (12.0, 12.0), (0.0, 0.0), 0.0)
        hdr["DATE-AVG"] = timeutils.format_fits_time(T0 + 150.0 * k)
        p = str(tmp_path / f"it_imager_{k}.fits")
        jfits.write(p, [jfits.PrimaryHDU(
            data=fx.render_helioprojective(hdr).astype(np.float32),
            header=hdr)])
        paths.append(p)
    return paths


def write_spice(tmp_path, hdr_true, hdr_given, name="solo_L2_it_spice.fits"):
    p = str(tmp_path / name)
    jfits.write(p, [jfits.PrimaryHDU(
        data=fx.render_spice_l2_cube(hdr_true).astype(np.float32),
        header=hdr_given)])
    return p


def iterative(cls, paths, p_spice, **lags):
    kw = dict(large_fov_list_paths=paths, small_fov_to_correct=p_spice,
              threshold_time=600.0, large_fov_window=0, small_fov_window=0,
              **lags)
    if cls is AlignementSpiceIterativeContextRaster:
        kw["device"] = "cpu"
    return cls(**kw)


CASES = {
    # a mixed crval x crota grid around a (+1", -1", +1 deg) error
    "crota": (dict(crval_arcsec=(121.0, 79.0), crota_deg=1.0),
              dict(lag_crval1=np.array([-1.0, 0.0, 1.0]),
                   lag_crval2=np.array([-1.0, 0.0, 1.0]),
                   lag_crota=np.array([0.0, 1.0])), (2, 0, 0, 0, 1)),
    # pixel-scale errors on both axes
    "cdelt": (dict(cdelt_arcsec=(4.4, 1.1)),
              dict(lag_cdelt1=np.array([0.0, 0.4, 0.8]),
                   lag_cdelt2=np.array([0.0, 0.1])), (0, 0, 1, 1, 0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_iterative_raster_matches_jax_and_sequential(tmp_path, case):
    """The batched route (chunks of 7 lags: ragged last chunk) against the
    JAX package's batched route within 1e-5 relative (both sample in
    float32) and against the port's sequential route within rtol 1e-6,
    atol 1e-9 (tests/test_iterative_raster.py); argmax on the injected
    error."""
    true_kw, lags, want_idx = CASES[case]
    paths = write_imager_series(tmp_path)
    p_spice = write_spice(
        tmp_path, fx.make_spice_l2_header(**true_kw),
        fx.make_spice_l2_header(crval_arcsec=(120.0, 80.0)))
    corr_j = iterative(jspice.AlignementSpiceIterativeContextRaster, paths,
                       p_spice, **lags).align_using_helioprojective(
        return_type="corr", lag_chunk=7)
    corr_b = iterative(AlignementSpiceIterativeContextRaster, paths, p_spice,
                       **lags).align_using_helioprojective(
        return_type="corr", lag_chunk=7)
    corr_s = iterative(AlignementSpiceIterativeContextRaster, paths, p_spice,
                       **lags).align_using_helioprojective(
        return_type="corr", batch_lags=False)
    assert corr_b.shape == corr_s.shape == corr_j.shape
    assert np.all(np.isfinite(corr_b))
    np.testing.assert_allclose(corr_b, corr_j, rtol=1e-5)
    np.testing.assert_allclose(corr_b, corr_s, rtol=1e-6, atol=1e-9)
    assert np.unravel_index(np.argmax(corr_b), corr_b.shape)[:5] == want_idx


def write_fsi_and_spice(tmp_path):
    """A 160^2 FSI-like frame at 10" and the SPICE L2 fixture (pointing
    irrelevant: the search is in pixels)."""
    hdr = fx.make_header((160, 160), (10.0, 10.0), (0.0, 0.0), 0.0)
    p_fsi = str(tmp_path / "fsi.fits")
    jfits.write(p_fsi, [jfits.PrimaryHDU(
        data=fx.render_helioprojective(hdr).astype(np.float32), header=hdr)])
    hdr_s = fx.make_spice_l2_header(crval_arcsec=(30.0, -20.0))
    return p_fsi, write_spice(tmp_path, hdr_s, hdr_s,
                              name="solo_L2_pixel_spice.fits")


def test_alignment_spice_pixel_matches_jax(tmp_path, monkeypatch):
    """``AlignmentSpicePixel``: the L2 map between the dumbbell limits, the
    solar-rotation CDELT1 (1e-12 relative) and the (dx, dy) hypercube,
    both packages in float64 (the port's ``AlignmentPixels`` resamples in
    float64, the JAX package's in float32, see tests/test_torch_movie.py):
    atol 1e-9, argmax equal."""
    monkeypatch.setattr(jfast, "pearson_integer_shifts", functools.partial(
        jfast.pearson_integer_shifts, compute_dtype=jnp.float64))
    monkeypatch.setattr(jlag, "resample_to_grid", functools.partial(
        jlag.resample_to_grid, compute_dtype=jnp.float64))
    p_fsi, p_spice = write_fsi_and_spice(tmp_path)
    ja = JSpicePixel(p_fsi, 0, p_spice, 0)
    ta = AlignmentSpicePixel(p_fsi, 0, p_spice, 0, device="cpu")
    np.testing.assert_array_equal(ta.data_small, ja.data_small)
    assert ta.hdr_small["CDELT1"] == pytest.approx(ja.hdr_small["CDELT1"],
                                                   rel=1e-12)
    assert ta.hdr_small["CDELT1"] < 4.0 / 3600.0
    lag = np.arange(-4, 5)
    want = ja.find_best_parameters(lag, lag, [0.0])
    got = ta.find_best_parameters(lag, lag, [0.0])
    assert got.shape == want.shape == (9, 9, 1)
    np.testing.assert_allclose(got, want, atol=1e-9)
    assert np.nanargmax(got) == np.nanargmax(want)


def test_alignment_spice_selector_matches_jax(tmp_path):
    """``AlignmentSpiceSelector`` with a local stub selector (no network):
    the synthetic raster composed from the stub's frames, then the search;
    hypercube within 1e-4 of the JAX package's (default float32 operands,
    tests/test_torch_alignment.py), argmax equal and on (+8", -4")."""
    paths = []
    for k in range(3):
        hdr = fx.make_header((196, 196), (12.0, 12.0), (0.0, 0.0), 0.0)
        hdr["DATE-AVG"] = timeutils.format_fits_time(T0 + 120.0 * k)
        p = str(tmp_path / f"solo_L2_eui-fsi304-image_20220317T0{945 + 2 * k}00000_V01.fits")
        jfits.write(p, [jfits.PrimaryHDU(
            data=fx.render_helioprojective(hdr).astype(np.float32),
            header=hdr)])
        paths.append(p)

    class LocalSelector(Selector):
        """The imager 'archive' is the local files: no index page fetched."""

        def get_url_from_time_interval(self, t1, t2, file_name_str=None):
            return np.asarray(paths), np.asarray([T0, T0 + 120, T0 + 240])

    p_spice = write_spice(tmp_path, fx.make_spice_l2_header(),
                          fx.make_spice_l2_header(crval_arcsec=(112.0, 84.0)),
                          name="solo_L2_spice.fits")
    lag1, lag2 = np.arange(0.0, 17.0, 2.0), np.arange(-12.0, 5.0, 2.0)
    out = {}
    for name, cls, extra in (("jax", JSelectorAlignment,
                              dict(use_device_mesh=False)),
                             ("torch", AlignmentSpiceSelector,
                              dict(device="cpu"))):
        folder = tmp_path / name
        folder.mkdir()
        A = cls(small_fov_to_correct=p_spice, lag_crval1=lag1,
                lag_crval2=lag2, small_fov_window=0, threshold_time=600.0,
                folder_path_synras=str(folder), selector=LocalSelector(""),
                **extra)
        assert A.synras_path.startswith(str(folder))
        out[name] = A.align_using_helioprojective()
    res_j, res_t = out["jax"], out["torch"]
    np.testing.assert_allclose(res_t.corr, res_j.corr, atol=1e-4)
    assert res_t.max_index == res_j.max_index
    assert (lag1[res_t.max_index[0]], lag2[res_t.max_index[1]]) == (8.0, -4.0)
