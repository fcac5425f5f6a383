"""The real-header archetypes of ``tests/test_real_headers.py`` through the
port's full API, held against the JAX package's on the same files.

Each archetype rewrites the fixture pair's small header (or file) the way a
real Solar Orbiter L2 file is spelled: CUNIT deg or mixed, a CD matrix, a
CROTA2-only header, a BLANK/BSCALE int16 window, a RICE_1 window chosen by
EXTNAME, a ``.fits.gz`` file, a 4-D SPICE cube.  The files are written once
(through the JAX package's writer, as the JAX tests write them) and read by
both packages.  Each case: the port recovers ``TRUE_SHIFT``; its hypercube
is within 1e-5 absolute of the JAX package's (both float32 operands on the
FFT path, surfaced in float64 by the port); the argmax is equal.  The int16
case also writes the corrected file with both packages: the data read back
within rtol 1e-6 of the input, the corrected pointing within 2e-2 arcsec of
the JAX package's (the 5x5 Gaussian fit on float32 hypercubes, as
``test_torch_alignment`` holds it) and every other header card equal.
"""
import gzip

import numpy as np
import pytest

import fixtures as fx
import test_real_headers as jrh
from euispice_coreg_tpu.hdrshift.alignment import Alignment as JAlignment
from euispice_coreg_tpu.hdrshift.alignment_spice import \
    AlignmentSpice as JAlignmentSpice
from euispice_coreg_tpu.io import fits as jfits
from euispice_coreg_tpu_torch import Alignment
from euispice_coreg_tpu_torch.hdrshift import AlignmentSpice
from euispice_coreg_tpu_torch.io import fits

HYPERCUBE_ATOL = 1e-5
SHIFT_ATOL = 2e-2
POINTING_KEYS = ("CRVAL1", "CRVAL2", "CDELT1", "CDELT2", "PC1_1", "PC1_2",
                 "PC2_1", "PC2_2", "CROTA")
HEADER_REWRITES = {"cunit_deg": jrh.to_deg_units,
                   "cunit_mixed": jrh.to_mixed_units,
                   "cd_matrix": jrh.to_cd_matrix,
                   "crota2_only": jrh.to_crota2}


def write_archetype(tmp_path, name):
    """The archetype's files: ``(p_large, p_small, small_window, extra)``
    with ``extra`` what the int16 case checks after the search."""
    dl, hl, ds, hs = jrh.standard_pair()
    if name in HEADER_REWRITES:
        hs = jrh.rewrite_header(hs, HEADER_REWRITES[name])
        return (*fx.write_pair_fits(tmp_path, dl, hl, ds, hs), 0, None)
    p_large = str(tmp_path / "large.fits")
    jfits.write(p_large, [jfits.PrimaryHDU(data=dl.astype(np.float32),
                                           header=hl)])
    if name == "bscale_int16":
        ds = ds.copy()
        ds[5:9, 5:9] = np.nan
        lo, hi = np.nanmin(ds), np.nanmax(ds)
        bzero, bscale, blank = (hi + lo) / 2.0, (hi - lo) / 60000.0, -32768
        quant = np.where(np.isfinite(ds), np.round((ds - bzero) / bscale),
                         blank).astype(np.int16)
        hs = hs.copy()
        hs["BSCALE"], hs["BZERO"], hs["BLANK"] = bscale, bzero, blank
        p_small = str(tmp_path / "small_int16.fits")
        jfits.write(p_small, [jfits.PrimaryHDU(data=quant, header=hs)])
        return p_large, p_small, 0, (ds, bscale)
    if name == "rice_window":
        hs = hs.copy()
        hs["EXTNAME"] = "HRI_EUV"
        comp = jfits.CompImageHDU(data=ds.astype(np.float32), header=hs,
                                  compression_type="RICE_1")
        comp.quantize_level = 64.0
        p_small = str(tmp_path / "small_rice.fits")
        jfits.write(p_small, [jfits.PrimaryHDU(), comp])
        return p_large, p_small, "HRI_EUV", None
    assert name == "gzip"
    p_large, p_plain = fx.write_pair_fits(tmp_path, dl, hl, ds, hs)
    p_small = str(tmp_path / "small.fits.gz")
    with open(p_plain, "rb") as f_in, gzip.open(p_small, "wb") as f_out:
        f_out.write(f_in.read())
    return p_large, p_small, 0, None


def both(jax_cls, port_cls, p_large, p_small, small_window):
    kw = dict(large_fov_known_pointing=p_large, small_fov_to_correct=p_small,
              lag_crval1=jrh.LAGS1, lag_crval2=jrh.LAGS2, lag_cdelt1=None,
              lag_cdelt2=None, lag_crota=None, small_fov_window=small_window,
              large_fov_window=0)
    return (jax_cls(**kw, use_device_mesh=False),
            port_cls(**kw, device="cpu"))


def assert_hypercubes_agree(ja, ta):
    """Hypercube within HYPERCUBE_ATOL, argmax equal, TRUE_SHIFT found."""
    want, got = (a.align_using_helioprojective(method="correlation",
                                               return_type="corr")
                 for a in (ja, ta))
    assert got.shape == want.shape == (11, 11, 1, 1, 1, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=HYPERCUBE_ATOL)
    mi = np.unravel_index(np.nanargmax(got), got.shape)
    assert mi == np.unravel_index(np.nanargmax(want), want.shape)
    assert ta.lag_crval1[mi[0]] == pytest.approx(jrh.TRUE_SHIFT[0])
    assert ta.lag_crval2[mi[1]] == pytest.approx(jrh.TRUE_SHIFT[1])


@pytest.mark.parametrize("name", ["cunit_deg", "cunit_mixed", "cd_matrix",
                                  "crota2_only", "bscale_int16",
                                  "rice_window", "gzip"])
def test_helioprojective_archetype_matches_jax(tmp_path, name):
    p_large, p_small, window, extra = write_archetype(tmp_path, name)
    ja, ta = both(JAlignment, Alignment, p_large, p_small, window)
    assert_hypercubes_agree(ja, ta)
    if extra is None:
        return
    ds, bscale = extra
    read = fits.open(p_small)[0].data
    finite = np.isfinite(ds)
    assert np.isnan(read[6, 6])
    np.testing.assert_allclose(read[finite], ds[finite], atol=bscale)
    np.testing.assert_array_equal(read, jfits.open(p_small)[0].data)
    out_j = str(tmp_path / "corrected_jax.fits")
    out_t = str(tmp_path / "corrected_torch.fits")
    ja.align_using_helioprojective(method="correlation") \
        .write_corrected_fits(window_list_to_apply_shift=[0],
                              path_to_l3_output=out_j)
    ta.align_using_helioprojective(method="correlation") \
        .write_corrected_fits(window_list_to_apply_shift=[0],
                              path_to_l3_output=out_t)
    back, back_j = fits.open(out_t)[0], jfits.open(out_j)[0]
    np.testing.assert_allclose(back.data[finite], read[finite], rtol=1e-6)
    np.testing.assert_array_equal(back.data, back_j.data)
    assert set(back.header.keys()) == set(back_j.header.keys())
    for key in back_j.header.keys():
        if key in POINTING_KEYS:
            assert back.header[key] == pytest.approx(back_j.header[key],
                                                     abs=SHIFT_ATOL), key
        else:
            assert back.header[key] == back_j.header[key], key


def test_spice_4d_cube_matches_jax(tmp_path):
    """The 4-D SPICE L2 cube (WAVE and UTC axes on disk) through
    ``AlignmentSpice`` in both packages."""
    p_imager, p_spice = fx.make_spice_pair(tmp_path,
                                           true_shift_arcsec=jrh.TRUE_SHIFT)
    hdu = fits.open(p_spice)[0]
    assert hdu.data.ndim == 4
    assert (hdu.header["CTYPE3"], hdu.header["CTYPE4"]) == ("WAVE", "UTC")
    ja, ta = both(JAlignmentSpice, AlignmentSpice, p_imager, p_spice, 0)
    assert_hypercubes_agree(ja, ta)
