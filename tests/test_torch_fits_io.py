"""The port's FITS I/O (``euispice_coreg_tpu_torch.io``) against the JAX
package's: plain HDUs, RICE/GZIP tile compression, quantized floats under
every dither method, the committed cfitsio-written files, and byte-identical
output of the two writers.  One test per case of ``tests/test_fits_io.py``
(the codec cases are in ``test_torch_fits_io_codecs.py``), plus the parity
cases."""
import pathlib

import numpy as np
import pytest

from euispice_coreg_tpu.core.header import Header as JHeader
from euispice_coreg_tpu.io import fits as jfits
from euispice_coreg_tpu_torch.core.header import Header
from euispice_coreg_tpu_torch.io import fits
from euispice_coreg_tpu_torch.io import tile_compression as tc
from euispice_coreg_tpu_torch.io.native import rice_decode, rice_encode

DATA = pathlib.Path(__file__).parent / "data"


def assert_same_arrays(a, b):
    """Equal arrays, NaN where the other has NaN, same dtype."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def read_both(path):
    """Open ``path`` with both packages; every HDU's data equal, NaN-aware,
    and the same HDU classes.  Returns the port's HDUList."""
    t, j = fits.open(str(path)), jfits.open(str(path))
    assert [type(h).__name__ for h in t] == [type(h).__name__ for h in j]
    for ht, hj in zip(t, j):
        if hj.data is None:
            assert ht.data is None
        else:
            assert_same_arrays(ht.data, hj.data)
        assert dict(ht.header.items()) == dict(hj.header.items())
    return t


def _smooth_float_image(ny=37, nx=53, seed=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:ny, 0:nx]
    img = (100.0 + 10.0 * np.sin(x / 7.0) * np.cos(y / 5.0)
           + rng.normal(0, 0.5, size=(ny, nx)))
    return img.astype(np.float32)


def test_primary_roundtrip(tmp_path):
    data = np.arange(120, dtype=np.float32).reshape(10, 12) * 1.5
    hdr = Header({
        "CRVAL1": 12.5, "CUNIT1": "arcsec", "DATE-OBS": "2022-03-17T09:50:45.281",
        "WAVELNTH": 174, "FLAG": True, "NOTE": "it's a test",
    })
    path = tmp_path / "x.fits"
    fits.write(path, [fits.PrimaryHDU(data=data, header=hdr)])
    hdul = read_both(path)
    assert len(hdul) == 1
    got = hdul[0]
    np.testing.assert_array_equal(got.data, data)
    assert got.header["CRVAL1"] == 12.5
    assert got.header["CUNIT1"] == "arcsec"
    assert got.header["DATE-OBS"] == "2022-03-17T09:50:45.281"
    assert got.header["WAVELNTH"] == 174
    assert got.header["FLAG"] is True
    assert got.header["NOTE"] == "it's a test"


def test_multi_hdu_and_extname(tmp_path):
    d0 = np.zeros((4, 4), dtype=np.int16)
    d1 = np.ones((3, 5), dtype=np.float64)
    d2 = np.full((2, 2), 7, dtype=np.int32)
    path = tmp_path / "m.fits"
    fits.write(path, [
        fits.PrimaryHDU(data=d0),
        fits.ImageHDU(data=d1, name="He II 304"),
        fits.ImageHDU(data=d2, name="OTHER"),
    ])
    hdul = read_both(path)
    assert len(hdul) == 3
    np.testing.assert_array_equal(hdul["He II 304"].data, d1)
    np.testing.assert_array_equal(hdul[-1].data, d2)
    assert hdul[1].header["EXTNAME"] == "He II 304"


def test_bscale_bzero_blank():
    raw = np.array([[0, 100], [200, -5]], dtype=">i2")
    cards = [fits._make_card(k, v) for k, v in (
        ("SIMPLE", True), ("BITPIX", 16), ("NAXIS", 2), ("NAXIS1", 2),
        ("NAXIS2", 2), ("BSCALE", 0.5), ("BZERO", 10.0), ("BLANK", -5))]
    blob = fits._serialize_header(cards)
    payload = raw.tobytes()
    blob += payload + b"\x00" * ((-len(payload)) % fits.BLOCK)
    got = fits.open(blob)[0].data
    assert_same_arrays(got, jfits.open(blob)[0].data)
    assert got[0, 0] == pytest.approx(10.0)
    assert got[0, 1] == pytest.approx(60.0)
    assert np.isnan(got[1, 1])


def test_3d_and_4d_cubes(tmp_path):
    cube = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    path = tmp_path / "c.fits"
    fits.write(path, [fits.PrimaryHDU(data=cube)])
    got = read_both(path)[0].data
    np.testing.assert_array_equal(got, cube)
    assert got.shape == (2, 3, 4, 5)


def test_rice_roundtrip_random():
    from euispice_coreg_tpu.io.native import rice_encode as jrice_encode

    rng = np.random.default_rng(0)
    for n in [1, 5, 32, 33, 1000, 4096]:
        a = rng.integers(-30000, 30000, size=n).astype(np.int32)
        comp = rice_encode(a)
        assert comp.tobytes() == jrice_encode(a).tobytes()
        np.testing.assert_array_equal(rice_decode(comp, n), a)


def test_rice_compresses_smooth_data():
    x = np.linspace(0, 10, 10000)
    a = (1000 * np.sin(x) + 5).astype(np.int32)
    assert rice_encode(a).size < a.nbytes / 3


def test_rice_constant_and_extreme():
    a = np.zeros(100, dtype=np.int32)
    np.testing.assert_array_equal(rice_decode(rice_encode(a), 100), a)
    b = np.array([2**31 - 1, -2**31, 0, 1, -1] * 20, dtype=np.int32)
    np.testing.assert_array_equal(rice_decode(rice_encode(b), b.size), b)


def test_compressed_hdu_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 4000, size=(64, 48)).astype(np.int32)
    hdr = Header({"DATE-OBS": "2022-03-17T00:00:00", "DETECTOR": "FSI"})
    path = tmp_path / "comp.fits"
    fits.write(path, [
        fits.PrimaryHDU(),
        fits.CompImageHDU(data=img, header=hdr, name="IMG"),
    ])
    got = read_both(path)["IMG"]
    assert isinstance(got, fits.CompImageHDU)
    np.testing.assert_array_equal(got.data, img)
    assert got.header["DETECTOR"] == "FSI"
    assert got.header["ZNAXIS1"] == 48
    assert got.header["ZNAXIS2"] == 64


def test_compressed_hdu_tiled(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(-100, 100, size=(33, 21)).astype(np.int32)
    path = tmp_path / "tiled.fits"
    fits.write(path, [fits.PrimaryHDU(),
                      fits.CompImageHDU(data=img, name="T", tile_shape=(8, 16))])
    np.testing.assert_array_equal(read_both(path)["T"].data, img)


def test_compressed_hdu_first_gets_an_empty_primary(tmp_path):
    """A ``CompImageHDU`` written first follows an empty primary, as in the
    JAX writer (a compressed image cannot be the primary HDU)."""
    img = np.arange(6 * 7, dtype=np.int32).reshape(6, 7)
    path = tmp_path / "first.fits"
    fits.write(path, [fits.CompImageHDU(data=img, name="C")])
    hdul = read_both(path)
    assert hdul[0].data is None and len(hdul) == 2
    np.testing.assert_array_equal(hdul["C"].data, img)


def test_bytesio_and_bytes_input(tmp_path):
    d = np.eye(3, dtype=np.float32)
    path = tmp_path / "b.fits"
    fits.write(path, [fits.PrimaryHDU(data=d)])
    np.testing.assert_array_equal(fits.open(path.read_bytes())[0].data, d)


def test_gzip1_gzip2_integer_roundtrip(tmp_path):
    data = (np.arange(35 * 41).reshape(35, 41) % 251).astype(np.int32)
    for ctype in ("GZIP_1", "GZIP_2"):
        path = tmp_path / f"g_{ctype}.fits"
        fits.write(path, [fits.PrimaryHDU(),
                          fits.CompImageHDU(data=data, name="W",
                                            compression_type=ctype,
                                            tile_shape=(8, 16))])
        got = read_both(path)[1]
        assert isinstance(got, fits.CompImageHDU)
        np.testing.assert_array_equal(got.data, data)


@pytest.mark.parametrize("method", ["NO_DITHER", "SUBTRACTIVE_DITHER_1",
                                    "SUBTRACTIVE_DITHER_2"])
def test_quantized_float_rice_roundtrip(tmp_path, method):
    data = _smooth_float_image()
    data[5, 7] = np.nan
    data[20, 30] = np.nan
    if method == "SUBTRACTIVE_DITHER_2":
        data[3, 3] = 0.0
    path = tmp_path / "q.fits"
    fits.write(path, [fits.PrimaryHDU(),
                      fits.CompImageHDU(data=data, name="W", quantize_level=32.0,
                                        quantize_method=method, dither_seed=7,
                                        tile_shape=(4, 53))])
    got = read_both(path)[1].data
    assert got.dtype == np.float32
    assert np.isnan(got[5, 7]) and np.isnan(got[20, 30])
    fin = np.isfinite(data)
    assert np.abs(got[fin] - data[fin]).max() < 0.15
    if method == "SUBTRACTIVE_DITHER_2":
        assert got[3, 3] == 0.0


def test_quantized_float_gzip_tiles(tmp_path):
    data = _smooth_float_image(seed=11)
    path = tmp_path / "qg.fits"
    fits.write(path, [fits.PrimaryHDU(),
                      fits.CompImageHDU(data=data, name="W",
                                        compression_type="GZIP_2",
                                        quantize_level=64.0,
                                        quantize_method="SUBTRACTIVE_DITHER_1",
                                        tile_shape=(7, 53))])
    assert np.abs(read_both(path)[1].data - data).max() < 0.1


def test_flat_tile_lossless_fallback(tmp_path):
    data = _smooth_float_image(ny=24, nx=32, seed=5)
    data[8:16, :] = 42.125
    path = tmp_path / "fb.fits"
    fits.write(path, [fits.PrimaryHDU(),
                      fits.CompImageHDU(data=data, name="W", tile_shape=(8, 32))])
    got = read_both(path)[1].data
    np.testing.assert_array_equal(got[8:16, :], np.float32(42.125))
    assert np.abs(got - data).max() < 0.1


def test_dither_sequence_matches_convention():
    from euispice_coreg_tpu.io import tile_compression as jtc

    rv = tc._dither_randoms()
    m = 2147483647.0
    np.testing.assert_allclose(rv[0], 16807.0 / m, rtol=1e-12)
    np.testing.assert_allclose(rv[1], 282475249.0 / m, rtol=1e-12)
    np.testing.assert_allclose(rv[2], 1622650073.0 / m, rtol=1e-12)
    assert rv.shape == (10000,)
    assert (rv > 0).all() and (rv < 1).all()
    np.testing.assert_array_equal(rv, jtc._dither_randoms())


def test_whole_file_gzip(tmp_path):
    import gzip

    data = np.arange(64, dtype=np.int16).reshape(8, 8)
    plain = tmp_path / "p.fits"
    fits.write(plain, [fits.PrimaryHDU(data=data)])
    gz = tmp_path / "p.fits.gz"
    gz.write_bytes(gzip.compress(plain.read_bytes()))
    np.testing.assert_array_equal(read_both(gz)[0].data, data)


def _write_corrected_both(tmp_path, src):
    from euispice_coreg_tpu.hdrshift import AlignmentResults as JResults
    from euispice_coreg_tpu_torch.hdrshift import AlignmentResults

    corr = np.zeros((3, 3, 1, 1, 1, 1))
    corr[2, 1] = 1.0
    outs = []
    for name, cls in (("t", AlignmentResults), ("j", JResults)):
        res = cls(corr, [-1, 0, 1], [-1, 0, 1], None, None, None,
                  unit_lag="arcsec", image_to_align_path=str(src),
                  image_to_align_window=1)
        outs.append(tmp_path / f"out_{name}.fits")
        res.write_corrected_fits(window_list_to_apply_shift=["W"],
                                 path_to_l3_output=str(outs[-1]))
    return outs


@pytest.mark.parametrize("settings", [
    {},
    dict(compression_type="GZIP_2", quantize_method="SUBTRACTIVE_DITHER_1",
         quantize_level=32.0, dither_seed=9, tile_shape=(4, 16)),
])
def test_corrected_fits_preserves_compression(tmp_path, settings):
    """``write_corrected_fits`` re-wraps a compressed window as compressed
    (reference Util.py:143-150), float32, with the corrected CRVAL and the
    input's ZCMPTYPE, ZQUANTIZ, ZDITHER0, NOISEBIT and tiles, within one
    quantization step of the input's decode.  With the writer's defaults
    the file is byte for byte the JAX package's; with other settings the
    JAX package writes its defaults (a deliberate difference)."""
    data = _smooth_float_image(ny=16, nx=16, seed=9) * 10
    hdr = Header({"CRVAL1": 10.0, "CRVAL2": 5.0, "CRPIX1": 8.0, "CRPIX2": 8.0,
                  "CDELT1": 1.0, "CDELT2": 1.0, "CUNIT1": "arcsec",
                  "CUNIT2": "arcsec", "CROTA": 0.0, "NAXIS1": 16, "NAXIS2": 16})
    src = tmp_path / "in.fits"
    fits.write(src, [fits.PrimaryHDU(),
                     fits.CompImageHDU(data=data, header=hdr, name="W",
                                       **settings)])
    out_t, out_j = _write_corrected_both(tmp_path, src)
    inp, got = fits.open(src)["W"], read_both(out_t)["W"]
    assert isinstance(got, fits.CompImageHDU)
    assert got.data.dtype == np.float32
    assert got.header["CRVAL1"] == pytest.approx(11.0)
    assert got.header["CRVAL2"] == pytest.approx(5.0)
    for k in ("ZCMPTYPE", "ZQUANTIZ", "ZTILE1", "ZTILE2", "ZVAL3"):
        assert got.header[k] == inp.header[k], k
    assert got.header.get("ZDITHER0") == inp.header.get("ZDITHER0")
    step = tc.quantization_steps(str(out_t), 1)
    assert (np.abs(got.data - inp.data) <= step).all()
    if settings:
        jgot = jfits.open(str(out_j))["W"].header
        assert (jgot["ZCMPTYPE"], jgot["ZQUANTIZ"]) == ("RICE_1", "NO_DITHER")
    else:
        assert out_t.read_bytes() == out_j.read_bytes()


def test_rewrite_preserves_compression_settings(tmp_path):
    data = _smooth_float_image(ny=24, nx=40, seed=2)
    p1 = tmp_path / "a.fits"
    fits.write(p1, [fits.PrimaryHDU(),
                    fits.CompImageHDU(data=data, name="W",
                                      compression_type="GZIP_1",
                                      quantize_level=64.0,
                                      quantize_method="SUBTRACTIVE_DITHER_1",
                                      dither_seed=11, tile_shape=(6, 40))])
    hdu = fits.open(p1)[1]
    jhdu = jfits.open(str(p1))[1]
    for attr in ("compression_type", "quantize_method", "quantize_level",
                 "dither_seed", "tile_shape"):
        assert getattr(hdu, attr) == getattr(jhdu, attr), attr
    assert (hdu.compression_type, hdu.quantize_method) == \
        ("GZIP_1", "SUBTRACTIVE_DITHER_1")
    assert hdu.quantize_level == 64.0 and hdu.dither_seed == 11
    assert tuple(hdu.tile_shape) == (6, 40)
    p2 = tmp_path / "b.fits"
    fits.write(p2, [fits.PrimaryHDU(), hdu])
    hdr2 = read_both(p2)[1].header
    assert str(hdr2["ZCMPTYPE"]).strip() == "GZIP_1"
    assert str(hdr2["ZQUANTIZ"]).strip() == "SUBTRACTIVE_DITHER_1"
    assert int(hdr2["ZDITHER0"]) == 11
    assert np.abs(fits.open(p2)[1].data - data).max() < 0.1


def test_quantize_level_zero_is_lossless(tmp_path):
    data = _smooth_float_image(ny=16, nx=32, seed=4)
    p = tmp_path / "l.fits"
    fits.write(p, [fits.PrimaryHDU(),
                   fits.CompImageHDU(data=data, name="W", quantize_level=0.0,
                                     tile_shape=(4, 32))])
    np.testing.assert_array_equal(read_both(p)[1].data, data)


def test_column_descr_bit_array():
    from euispice_coreg_tpu.io import tile_compression as jtc

    spec = {"TFIELDS": 3, "TTYPE1": "COMPRESSED_DATA", "TFORM1": "1PB(99)",
            "TTYPE2": "FLAGS", "TFORM2": "16X", "TTYPE3": "ZSCALE",
            "TFORM3": "1D"}
    cols, rowsize = tc._column_descr(Header(spec))
    assert cols["COMPRESSED_DATA"] == (0, "PB")
    assert cols["FLAGS"] == (8, "X")
    assert cols["ZSCALE"] == (10, "D")
    assert rowsize == 18
    assert (cols, rowsize) == jtc._column_descr(JHeader(spec))


def test_tile_randoms_match_scalar_reference():
    rv = tc._dither_randoms()

    def scalar(row, dither0, npix):
        iseed = int((dither0 - 1 + row) % tc.N_RANDOM)
        irand = int(rv[iseed] * 500.0)
        out = np.empty(npix)
        for i in range(npix):
            out[i] = rv[irand]
            irand += 1
            if irand == tc.N_RANDOM:
                iseed = (iseed + 1) % tc.N_RANDOM
                irand = int(rv[iseed] * 500.0)
        return out

    for row, d0, n in [(0, 1, 7), (3, 42, 25_000), (9999, 9999, 12_345)]:
        np.testing.assert_array_equal(tc._tile_randoms(row, d0, n),
                                      scalar(row, d0, n))


def test_rice_truncated_stream_raises():
    rng = np.random.default_rng(3)
    vals = rng.integers(-30000, 30000, size=1024).astype(np.int32)
    comp = rice_encode(vals, 32, 4)
    np.testing.assert_array_equal(rice_decode(comp, 1024, 32, 4), vals)
    with pytest.raises(RuntimeError):
        rice_decode(comp[: len(comp) // 2], 1024, 32, 4)
    with pytest.raises(RuntimeError):
        rice_decode(np.zeros(0, dtype=np.uint8), 16, 32, 4)


# ---------------------------------------------------------------------------
# parity: the committed files read alike, the two writers write alike
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(p.name for p in DATA.glob("*.fits")))
def test_reads_committed_files_like_jax(name):
    """Every FITS file of ``tests/data`` reads to the JAX package's arrays
    (NaN-aware) and headers; the cfitsio-written ones also to cfitsio's own
    decode (``*_expected.npy``)."""
    hdu = read_both(DATA / name)[1]
    assert isinstance(hdu, fits.CompImageHDU)
    expected = DATA / name.replace(".fits", "_expected.npy")
    if expected.exists():
        want = np.load(expected)
        got = np.asarray(hdu.data, dtype=np.float32)
        assert np.array_equal(np.isfinite(got), np.isfinite(want))
        fin = np.isfinite(want)
        np.testing.assert_array_equal(got[fin], want[fin])


_FLOAT_CASES = [(c, m) for c in ("RICE_1", "GZIP_1", "GZIP_2", "HCOMPRESS_1")
                for m in ("NO_DITHER", "SUBTRACTIVE_DITHER_1",
                          "SUBTRACTIVE_DITHER_2")]


@pytest.mark.parametrize("ctype,method", _FLOAT_CASES + [
    (c, None) for c in ("RICE_1", "GZIP_1", "GZIP_2", "HCOMPRESS_1",
                        "PLIO_1")])
def test_writes_bytes_identical_to_jax(tmp_path, ctype, method):
    """The same image and header through both packages' ``fits.write`` give
    the same file, byte for byte: float32 quantized under ``method`` (NaNs,
    exact zeros, a flat tile that falls back to gzip, partial edge tiles),
    or int32 (``method`` None)."""
    rng = np.random.default_rng(5)
    if method is None:
        hi = 12 if ctype == "PLIO_1" else 3000
        data = rng.integers(0, hi, size=(29, 41)).astype(np.int32)
    else:
        data = _smooth_float_image(ny=29, nx=41, seed=6)
        data[12:16, :] = 7.5
        data[3, 3] = 0.0
        if ctype != "HCOMPRESS_1":
            data[20, 5] = np.nan
    kw = dict(name="W", compression_type=ctype, tile_shape=(8, 20),
              quantize_level=16.0, quantize_method=method or "NO_DITHER",
              dither_seed=4242)
    spec = {"DATE-OBS": "2022-03-17T09:50:45.281", "CRVAL1": -8.0,
            "CDELT1": 0.492, "DETECTOR": "HRI_EUV"}
    p_t, p_j = tmp_path / "t.fits", tmp_path / "j.fits"
    fits.write(p_t, [fits.PrimaryHDU(),
                     fits.CompImageHDU(data=data, header=Header(spec), **kw)])
    jfits.write(str(p_j), [jfits.PrimaryHDU(),
                           jfits.CompImageHDU(data=data, header=JHeader(spec),
                                              **kw)])
    assert p_t.read_bytes() == p_j.read_bytes()
    got = read_both(p_t)["W"].data
    fin = np.isfinite(data)
    assert np.array_equal(np.isfinite(got), fin)
    step = tc.quantization_steps(str(p_t), 1)
    assert (np.abs(got[fin] - data[fin]) <= 0.5 * step[fin] + 1e-5).all()
    assert (step > 0).any() == (method is not None)
