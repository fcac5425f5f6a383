"""The port's SPICE preparation and ``AlignmentSpice`` against the JAX
package's, on the same FITS files (tests/fixtures.py) on the CPU."""
import numpy as np
import pytest

import fixtures as fx
from euispice_coreg_tpu.core.ndwcs import NDWCS as JNDWCS
from euispice_coreg_tpu.hdrshift import alignment_spice as jspice
from euispice_coreg_tpu.io import fits as jfits
from euispice_coreg_tpu_torch.core.header import Header
from euispice_coreg_tpu_torch.core.ndwcs import NDWCS
from euispice_coreg_tpu_torch.hdrshift import AlignmentSpice
from euispice_coreg_tpu_torch.hdrshift import alignment_spice as tspice

LAG1 = np.arange(4.0, 12.1, 2.0)
LAG2 = np.arange(-8.0, 0.1, 2.0)


def assert_headers_equal(got, want):
    """Same cards, float values within 1e-12 relative."""
    assert list(got.keys()) == list(want.keys())
    for k in want.keys():
        if isinstance(want[k], float):
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-15), k
        else:
            assert got[k] == want[k], k


def assert_maps_equal(got, want):
    """NaN at the same pixels, values within 1e-5 relative."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_spice_util_matches_jax():
    """Slit rows and dumbbell limits of both detectors and binnings."""
    for nbin, det, pxbeg in ((1, "SW", 230), (2, "LW", 115), (1, "LW", 1),
                             (4, "SW", 17)):
        hdr = Header({"NBIN2": nbin, "DETECTOR": det, "PXBEG2": pxbeg})
        assert tspice.SpiceUtil.slit_pxl(hdr) == jspice.SpiceUtil.slit_pxl(hdr)
        assert (tspice.SpiceUtil.vertical_edges_limits(hdr)
                == jspice.SpiceUtil.vertical_edges_limits(hdr))
    with pytest.raises(ValueError, match="unknown detector"):
        tspice.SpiceUtil.slit_pxl(Header({"NBIN2": 1, "DETECTOR": "X",
                                          "PXBEG2": 1}))


def test_ndwcs_and_spatial_header_match_jax():
    """NDWCS from_header/to_header round trip, dropaxis, set_pc, axis and
    pair lookup, time origin and pixel_to_world on every axis; the spatial
    header of an L2 cube: cards equal, values within 1e-12."""
    hdr = fx.make_spice_l2_header(crota_deg=1.5)
    w, jw = NDWCS.from_header(hdr), JNDWCS.from_header(hdr)
    assert_headers_equal(w.to_header(), jw.to_header())
    assert_headers_equal(NDWCS.from_header(w.to_header()).to_header(),
                         w.to_header())
    assert w.celestial_pair() == jw.celestial_pair() == (0, 1)
    assert w.axis_index("UTC") == jw.axis_index("UTC") == 3
    assert w.time_origin_seconds() == jw.time_origin_seconds()
    px = np.arange(24.0).reshape(6, 4)
    coords = (px, 0.7 * px + 1.0, np.zeros_like(px), 0.5 * px)
    for got, want in zip(w.pixel_to_world(*coords), jw.pixel_to_world(*coords)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    w_xyt, jw_xyt = w.dropaxis(2), jw.dropaxis(2)
    w_xyt.set_pc(2, 0, 0.0)
    jw_xyt.set_pc(2, 0, 0.0)
    assert_headers_equal(w_xyt.to_header(), jw_xyt.to_header())
    with pytest.raises(KeyError):
        w.axis_index("FREQ")
    assert_headers_equal(tspice.spatial_header_from_spice_l2(hdr, 48, 64),
                         jspice.spatial_header_from_spice_l2(hdr, 48, 64))


def both(p_imager, p_spice, **kw):
    """The JAX and the port's AlignmentSpice on the same files."""
    kw = dict(large_fov_known_pointing=p_imager, small_fov_to_correct=p_spice,
              lag_crval1=LAG1, lag_crval2=LAG2, large_fov_window=0,
              small_fov_window=0, **kw)
    return (jspice.AlignmentSpice(**kw, use_device_mesh=False),
            AlignmentSpice(**kw, device="cpu"))


def prepare(aligners, level=2, cut_from_center=None, extend=False):
    for a in aligners:
        a.cut_from_center = cut_from_center
        a.extend_pixel_size = extend
        a._extract_imager_data_header()
        a._extract_spice_data_header(level=level)


@pytest.mark.parametrize("case", ["all", "interval", "sub_fov", "cut"])
def test_l2_prep_matches_jax(tmp_path, case):
    """L2 cube -> 2-D map: the spectral sum ("all" or 769.5-770.5 A), the
    dumbbell rows, ``sub_fov_window`` and ``cut_from_center``: maps within
    1e-5 relative with NaN at the same pixels, header cards equal."""
    p_imager, p_spice = fx.make_spice_pair(tmp_path)
    kw = {"interval": dict(wavelength_interval_to_sum=[769.5, 770.5]),
          "sub_fov": dict(sub_fov_window=[60.0, 180.0, 30.0, 130.0])}
    ja, ta = both(p_imager, p_spice, **kw.get(case, {}))
    prepare((ja, ta), cut_from_center=30 if case == "cut" else None)
    assert_maps_equal(ta.data_small, ja.data_small)
    assert_headers_equal(ta.hdr_small, ja.hdr_small)
    np.testing.assert_array_equal(ta.data_large, ja.data_large)
    assert np.isnan(ta.data_small[:3]).all()
    if case == "cut":
        assert np.isnan(ta.data_small[:, 0]).all()


def test_l3_prep_matches_jax(tmp_path):
    """L3 coefficient cube (coefficient 1 of 2): map and header as the JAX
    package's."""
    p_imager, _ = fx.make_spice_pair(tmp_path)
    hdr = fx.make_spice_l2_header()
    cube = fx.render_spice_l2_cube(hdr)[0, :2] * np.array([1.0, 3.0])[:, None,
                                                                       None]
    p_l3 = str(tmp_path / "solo_L3_spice.fits")
    jfits.write(p_l3, [jfits.PrimaryHDU(data=cube.astype(np.float32),
                                        header=hdr)])
    ja, ta = both(p_imager, p_l3)
    assert ta._infer_level() == ja._infer_level() == 3
    for a in (ja, ta):
        a._extract_imager_data_header()
        a._extract_spice_data_header(level=3, coeff=1)
    assert_maps_equal(ta.data_small, ja.data_small)
    assert_headers_equal(ta.hdr_small, ja.hdr_small)


def test_correct_solar_rotation_matches_jax(tmp_path):
    """``extend_pixel_size``: CDELT1 stretched for the raster's solar
    rotation, within 1e-12 relative of the JAX value (and smaller)."""
    p_imager, p_spice = fx.make_spice_pair(tmp_path)
    ja, ta = both(p_imager, p_spice)
    prepare((ja, ta), extend=True)
    assert ta.hdr_small["CDELT1"] == pytest.approx(ja.hdr_small["CDELT1"],
                                                   rel=1e-12)
    assert 3.0 / 3600.0 < ta.hdr_small["CDELT1"] < 4.0 / 3600.0


@pytest.mark.parametrize("mode,dtype,atol,lags", [
    ("auto", "float64", 1e-6, {}),    # FFT path, both float64
    ("pallas", None, 2e-4, {}),       # K1: JAX's kernel works in float32
    ("exact", "float64", 1e-6, dict(lag_crota=[-1.0, 0.0])),
])
def test_helioprojective_matches_jax(tmp_path, mode, dtype, atol, lags):
    """``align_using_helioprojective`` on the SPICE pair (+8", -4"
    injected): hypercube within ``atol`` (the tolerances of
    tests/test_torch_alignment.py), argmax equal and on the truth."""
    p_imager, p_spice = fx.make_spice_pair(tmp_path)
    kw = dict(lag_search_mode=mode, **lags)
    if dtype:
        kw["compute_dtype"] = dtype
    ja, ta = both(p_imager, p_spice, **kw)
    res_j, res_t = (a.align_using_helioprojective() for a in (ja, ta))
    assert res_t.corr.shape == res_j.corr.shape
    np.testing.assert_allclose(res_t.corr, res_j.corr, atol=atol)
    assert res_t.max_index == res_j.max_index
    assert (LAG1[res_t.max_index[0]], LAG2[res_t.max_index[1]]) == (8.0, -4.0)


def write_carrington_spice_pair(tmp_path):
    """make_spice_pair with the Carrington keys on both files."""
    hdr_im = fx.make_header((196, 196), (12.0, 12.0), (0.0, 0.0), 0.0,
                            extra=fx.CARR_EXTRA)
    p_imager = str(tmp_path / "imager_carr.fits")
    jfits.write(p_imager, [jfits.PrimaryHDU(
        data=fx.render_helioprojective(hdr_im).astype(np.float32),
        header=hdr_im)])
    cube = fx.render_spice_l2_cube(fx.make_spice_l2_header())
    hdr = fx.make_spice_l2_header(crval_arcsec=(112.0, 84.0))
    hdr.update({"CRLN_OBS": 120.0, "CRLT_OBS": 3.0})
    p_spice = str(tmp_path / "solo_L2_spice_carr.fits")
    jfits.write(p_spice, [jfits.PrimaryHDU(data=cube.astype(np.float32),
                                           header=hdr)])
    return p_imager, p_spice


def test_carrington_matches_jax(tmp_path):
    """``align_using_carrington("fa")`` on a 64^2 Carrington grid over the
    raster, default float32: the SPICE header normalized to arcsec as the
    JAX package does, argmax equal and on the truth, fitted shift within
    0.01" (tests/test_torch_carrington_api.py)."""
    p_imager, p_spice = write_carrington_spice_pair(tmp_path)
    ja, ta = both(p_imager, p_spice)
    grid = dict(lonlims=(120.8, 125.8), latlims=(4.7, 6.2), shape=(64, 64))
    res_j, res_t = (a.align_using_carrington(**grid) for a in (ja, ta))
    assert_headers_equal(ta.hdr_small, ja.hdr_small)
    assert ta.hdr_small["CUNIT1"] == "arcsec"
    assert res_t.corr.shape == res_j.corr.shape == (5, 5, 1, 1, 1, 1)
    assert res_t.max_index == res_j.max_index
    assert (LAG1[res_t.max_index[0]], LAG2[res_t.max_index[1]]) == (8.0, -4.0)
    np.testing.assert_allclose(res_t.shift_arcsec, res_j.shift_arcsec,
                               atol=0.01)
