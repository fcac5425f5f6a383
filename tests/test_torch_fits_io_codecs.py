"""The port's tile codecs (``euispice_coreg_tpu_torch.io.native``: RICE_1,
HCOMPRESS_1 and PLIO_1, built with g++ from the port's own sources) and its
compressed-HDU reader and writer on them: the codec cases of
``tests/test_fits_io.py``, one port test per case, with libcfitsio as the
canonical codec where it is installed, and an HCOMPRESS alignment end to
end against the JAX package's."""
import pathlib

import numpy as np
import pytest

from euispice_coreg_tpu_torch.io import fits
from test_torch_fits_io import _smooth_float_image


# ---------------------------------------------------------------------------
# HCOMPRESS_1 (native codec, io/native/hcompress.cpp)
# ---------------------------------------------------------------------------

def test_hcompress_codec_roundtrip_shapes():
    from euispice_coreg_tpu_torch.io.native import hcomp_decode, hcomp_encode

    rng = np.random.default_rng(5)
    for shape in [(64, 64), (37, 53), (5, 9), (1, 16), (31, 1)]:
        a = (rng.normal(size=shape) * 500).astype(np.int32)
        comp = hcomp_encode(a, scale=0)
        dec, nx, ny = hcomp_decode(comp, a.size)
        assert (nx, ny) == shape
        np.testing.assert_array_equal(dec, a)


def test_hcompress_lossy_scale_bounded():
    from euispice_coreg_tpu_torch.io.native import hcomp_decode, hcomp_encode

    rng = np.random.default_rng(6)
    y, x = np.mgrid[0:96, 0:96]
    a = (800 * np.exp(-((x - 40) ** 2 + (y - 50) ** 2) / 500)
         + rng.normal(0, 2, size=(96, 96))).astype(np.int32)
    lossless = hcomp_encode(a, scale=0)
    lossy = hcomp_encode(a, scale=16)
    assert len(lossy) < len(lossless)
    dec, _, _ = hcomp_decode(lossy, a.size)
    assert np.abs(dec.astype(np.int64) - a).max() <= 16


def test_hcompress_integer_hdu_roundtrip(tmp_path):
    rng = np.random.default_rng(7)
    img = rng.integers(-500, 3000, size=(48, 40)).astype(np.int32)
    path = tmp_path / "hc.fits"
    fits.write(path, [fits.PrimaryHDU(),
                      fits.CompImageHDU(data=img, name="W",
                                        compression_type="HCOMPRESS_1")])
    got = fits.open(path)["W"]
    assert got.header["ZCMPTYPE"] == "HCOMPRESS_1"
    np.testing.assert_array_equal(got.data, img)


def test_hcompress_tiled_hdu_roundtrip(tmp_path):
    rng = np.random.default_rng(8)
    img = rng.integers(0, 1000, size=(50, 35)).astype(np.int32)
    path = tmp_path / "hct.fits"
    fits.write(path, [fits.PrimaryHDU(),
                      fits.CompImageHDU(data=img, name="W",
                                        compression_type="HCOMPRESS_1",
                                        tile_shape=(16, 35))])
    np.testing.assert_array_equal(fits.open(path)["W"].data, img)


def test_hcompress_quantized_float_roundtrip(tmp_path):
    data = _smooth_float_image(seed=13)
    data[4, 6] = np.nan
    path = tmp_path / "hcq.fits"
    fits.write(path, [fits.PrimaryHDU(),
                      fits.CompImageHDU(data=data, name="W",
                                        compression_type="HCOMPRESS_1",
                                        quantize_level=32.0,
                                        tile_shape=(8, 53))])
    got = fits.open(path)["W"].data
    assert got.dtype == np.float32
    assert np.isnan(got[4, 6])
    fin = np.isfinite(data)
    assert np.abs(got[fin] - data[fin]).max() < 0.15


def test_hcompress_alignment_end_to_end(tmp_path):
    """An HCOMPRESS window through the full public API of both packages on
    the CPU: the same hypercube within the float32 tolerances of
    ``tests/test_torch_alignment.py`` (1e-4, fitted shift 2e-2"), argmax
    equal, at the injected (+8", -4")."""
    import fixtures as fx
    from euispice_coreg_tpu.hdrshift.alignment import Alignment as JAlignment
    from euispice_coreg_tpu_torch import Alignment

    dl, hl, ds, hs = fx.make_helioprojective_pair(true_shift_arcsec=(8.0, -4.0))
    p_large = str(tmp_path / "large.fits")
    p_small = str(tmp_path / "small_hc.fits")
    fits.write(p_large, [fits.PrimaryHDU(data=dl.astype(np.float32),
                                         header=hl)])
    comp = fits.CompImageHDU(data=ds.astype(np.float32), header=hs,
                             name="HRI", compression_type="HCOMPRESS_1")
    comp.quantize_level = 64.0
    fits.write(p_small, [fits.PrimaryHDU(), comp])
    kw = dict(large_fov_known_pointing=p_large, small_fov_to_correct=p_small,
              lag_crval1=np.arange(-2, 19, 2.0),
              lag_crval2=np.arange(-14, 7, 2.0),
              lag_cdelt1=None, lag_cdelt2=None, lag_crota=None,
              small_fov_window="HRI", large_fov_window=0)
    res_t = Alignment(**kw, device="cpu").align_using_helioprojective()
    res_j = JAlignment(**kw, use_device_mesh=False) \
        .align_using_helioprojective()
    np.testing.assert_allclose(res_t.corr, res_j.corr, atol=1e-4)
    assert res_t.max_index == res_j.max_index
    mi = res_t.max_index
    assert kw["lag_crval1"][mi[0]] == pytest.approx(8.0)
    assert kw["lag_crval2"][mi[1]] == pytest.approx(-4.0)
    np.testing.assert_allclose(res_t.shift_arcsec, res_j.shift_arcsec,
                               atol=2e-2)


def test_hcompress_dither2_zero_pixels_roundtrip(tmp_path):
    """SUBTRACTIVE_DITHER_2's ZERO_VALUE sentinel cannot ride the
    H-transform: tiles with exact zeros must fall back losslessly instead
    of silently corrupting."""
    data = _smooth_float_image(seed=17)
    data[3, 3] = 0.0
    data[10, 20] = 0.0
    path = tmp_path / "hcz.fits"
    fits.write(path, [fits.PrimaryHDU(),
                      fits.CompImageHDU(data=data, name="W",
                                        compression_type="HCOMPRESS_1",
                                        quantize_level=32.0,
                                        quantize_method="SUBTRACTIVE_DITHER_2",
                                        tile_shape=(8, 53))])
    got = fits.open(path)["W"].data
    assert got[3, 3] == 0.0 and got[10, 20] == 0.0
    fin = np.isfinite(data)
    assert np.abs(got[fin] - data[fin]).max() < 0.15


def test_hcompress_int_dynamic_range_guard(tmp_path):
    """Integer images beyond the H-transform's int32 range must fail loudly
    at write time, not corrupt silently."""
    big = (np.arange(33 * 65, dtype=np.int64).reshape(33, 65) % 3
           * (1 << 27)).astype(np.int32)
    with pytest.raises(ValueError, match="HCOMPRESS_1 cannot"):
        fits.write(tmp_path / "hcbig.fits",
                   [fits.PrimaryHDU(),
                    fits.CompImageHDU(data=big, name="W",
                                      compression_type="HCOMPRESS_1")])


def test_hcompress_truncated_stream_rejected():
    """A stream shorter than the 25-byte header must error, not overread."""
    from euispice_coreg_tpu_torch.io.native import hcomp_decode, hcomp_encode

    comp = hcomp_encode(np.arange(64, dtype=np.int32).reshape(8, 8))
    with pytest.raises(ValueError):
        hcomp_decode(comp[:23], 64)


# ---------------------------------------------------------------------------
# PLIO_1 (IRAF line-list masks, native codec io/native/plio.cpp)
# ---------------------------------------------------------------------------

def _plio_cases():
    rng = np.random.default_rng(21)
    return [
        np.array([0, 0, 0, 5, 5, 5, 0, 0, 1, 2, 3], dtype=np.int32),
        np.zeros(100, dtype=np.int32),
        np.full(300, 7, dtype=np.int32),
        np.arange(5000, dtype=np.int32),              # long increasing ramp
        np.concatenate([np.zeros(9000, np.int32), [3]]),   # >4095 zero run
        np.concatenate([np.full(9000, 9, np.int32), [0]]),  # >4095 hi run
        np.array([(1 << 24) - 1, (1 << 24) - 1, 0, 1], dtype=np.int32),
        np.array([100, 90, 90, 80, 0, 5], dtype=np.int32),  # decrements
        # (np.concatenate above promotes to int64; normalized below)
        rng.integers(0, 5, size=4096).astype(np.int32),     # mask-like
        rng.integers(0, 1 << 20, size=513).astype(np.int32),  # wide range
    ]


def _plio_cases_i32():
    return [np.ascontiguousarray(a, dtype=np.int32) for a in _plio_cases()]


def test_plio_codec_roundtrip():
    from euispice_coreg_tpu_torch.io.native import plio_decode, plio_encode

    for a in _plio_cases():
        ll = plio_encode(a)
        np.testing.assert_array_equal(plio_decode(ll, a.size), a)


def test_plio_golden_cfitsio_streams():
    """Byte-exact decode of streams captured from libcfitsio's pl_p2li
    (the canonical PLIO encoder) — hermetic: vectors embedded here."""
    from euispice_coreg_tpu_torch.io.native import plio_decode

    goldens = [
        ([0, 7, -100, 14, 0, 0, 0, 8196, 3, 16387, 12292, 20483, 24577,
          24577],
         [0, 0, 0, 5, 5, 5, 0, 0, 1, 2, 3]),
        ([0, 7, -100, 9, 0, 0, 0, 8198, 16387], [7, 7, 7]),
        ([0, 7, -100, 8, 0, 0, 0, 10], [0] * 10),
        ([0, 7, -100, 16, 0, 0, 0, 16386, 8193, 16387, 5792, 24, 16386,
          4138, 0, 20484],
         [1, 1, 2, 2, 2, 100000, 100000, 0, 0, 0, 42]),
        ([0, 7, -100, 13, 0, 0, 0, 8191, 4095, 16386, 4097, 0, 20482],
         [(1 << 24) - 1, (1 << 24) - 1, 0, 1]),
        ([0, 7, -100, 13, 0, 0, 0, 24675, 12298, 16386, 28682, 12363,
          20482],
         [100, 90, 90, 80, 0, 5]),
    ]
    for ll, expect in goldens:
        got = plio_decode(np.array(ll, dtype=np.int16), len(expect))
        np.testing.assert_array_equal(got, np.array(expect, dtype=np.int32))


def test_plio_cross_validate_against_cfitsio():
    """When libcfitsio is present, fuzz both directions against the
    canonical codec: cfitsio decodes our streams, we decode cfitsio's."""
    import ctypes

    from euispice_coreg_tpu_torch.io.native import plio_decode, plio_encode

    lib = None
    for name in ("libcfitsio.so", "libcfitsio.so.10", "libcfitsio.so.9"):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    if lib is None or not hasattr(lib, "pl_p2li"):
        pytest.skip("libcfitsio not available")
    lib.pl_p2li.restype = ctypes.c_int
    lib.pl_p2li.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_int]
    lib.pl_l2pi.restype = ctypes.c_int
    lib.pl_l2pi.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_int]

    for a in _plio_cases_i32():
        # theirs -> ours
        buf = np.zeros(a.size * 4 + 64, dtype=np.int16)
        n = lib.pl_p2li(a.ctypes.data, 1, buf.ctypes.data, a.size)
        assert n > 0
        np.testing.assert_array_equal(plio_decode(buf[:n], a.size), a)
        # ours -> theirs
        ll = plio_encode(a)
        out = np.zeros(a.size, dtype=np.int32)
        m = lib.pl_l2pi(np.ascontiguousarray(ll).ctypes.data, 1,
                        out.ctypes.data, a.size)
        assert m == a.size
        np.testing.assert_array_equal(out, a)


def test_plio_hdu_roundtrip(tmp_path):
    rng = np.random.default_rng(22)
    img = rng.integers(0, 8, size=(57, 43)).astype(np.int32)  # mask-like
    path = tmp_path / "plio.fits"
    fits.write(path, [fits.PrimaryHDU(),
                      fits.CompImageHDU(data=img, name="MASK",
                                        compression_type="PLIO_1")])
    got = fits.open(path)["MASK"]
    assert got.header["ZCMPTYPE"] == "PLIO_1"
    np.testing.assert_array_equal(got.data, img)


def test_plio_tiled_hdu_roundtrip(tmp_path):
    rng = np.random.default_rng(23)
    img = (rng.random(size=(50, 37)) < 0.2).astype(np.int32) * 4095
    path = tmp_path / "pliot.fits"
    fits.write(path, [fits.PrimaryHDU(),
                      fits.CompImageHDU(data=img, name="MASK",
                                        compression_type="PLIO_1",
                                        tile_shape=(16, 20))])
    np.testing.assert_array_equal(fits.open(path)["MASK"].data, img)


def test_plio_range_and_float_guards(tmp_path):
    from euispice_coreg_tpu_torch.io.native import plio_encode

    with pytest.raises(ValueError, match=r"PLIO_1"):
        plio_encode(np.array([-1], dtype=np.int32))
    with pytest.raises(ValueError, match=r"PLIO_1"):
        plio_encode(np.array([1 << 24], dtype=np.int32))
    with pytest.raises(ValueError, match="integer mask"):
        fits.write(tmp_path / "bad.fits",
                   [fits.PrimaryHDU(),
                    fits.CompImageHDU(data=np.ones((8, 8), np.float32),
                                      name="W", compression_type="PLIO_1")])


# ---------------------------------------------------------------------------
# HCOMPRESS_1 cross-validation against libcfitsio (the canonical codec)
# ---------------------------------------------------------------------------

def _load_cfitsio():
    import ctypes

    for name in ("libcfitsio.so", "libcfitsio.so.10", "libcfitsio.so.9"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


def test_hcompress_golden_cfitsio_stream():
    """Byte-exact parity with a stream captured from a genuine
    cfitsio-written FITS file (5x8 NON-square tile, the case where the
    dim-word convention matters) — hermetic: vector embedded here.
    Dims are embedded (rows, cols) and the decoded flat order is the
    tile's row-major pixel order."""
    from euispice_coreg_tpu_torch.io.native import hcomp_decode, hcomp_encode

    img = (np.arange(40, dtype=np.int32).reshape(5, 8) * 3 % 17)
    stream = bytes.fromhex(
        "dd990000000500000008000000000000000000000090060505f47ef9a0170801"
        "6c0ffbfeffbee087fe606e667fde986a07f86a7fc047ff7fdff0118020574"
        "0ad00")
    arr2d, nx, ny = hcomp_decode(np.frombuffer(stream, dtype=np.uint8), 40)
    assert (nx, ny) == (5, 8)  # (rows, cols), cfitsio convention
    np.testing.assert_array_equal(np.asarray(arr2d).reshape(5, 8), img)
    assert np.asarray(hcomp_encode(img, 0)).tobytes() == stream


def test_hcompress_cross_validate_against_cfitsio():
    """Fuzz both directions against cfitsio's raw codec entry points:
    cfitsio decodes our streams, we decode cfitsio's, many shapes incl.
    odd/odd and extreme aspect ratios.  ctypes traps learned the hard
    way: fits_hcompress H-transforms its input IN PLACE (pass a copy),
    and *nbytes is in/out (the output buffer size on input — 0 hangs)."""
    import ctypes

    from euispice_coreg_tpu_torch.io.native import hcomp_decode, hcomp_encode

    lib = _load_cfitsio()
    if lib is None or not hasattr(lib, "fits_hcompress"):
        pytest.skip("libcfitsio not available")
    c_int, byref = ctypes.c_int, ctypes.byref
    lib.fits_hcompress.restype = c_int
    lib.fits_hcompress.argtypes = [ctypes.c_void_p, c_int, c_int, c_int,
                                   ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_long),
                                   ctypes.POINTER(c_int)]
    lib.fits_hdecompress.restype = c_int
    lib.fits_hdecompress.argtypes = [ctypes.c_void_p, c_int, ctypes.c_void_p,
                                     ctypes.POINTER(c_int),
                                     ctypes.POINTER(c_int),
                                     ctypes.POINTER(c_int),
                                     ctypes.POINTER(c_int)]

    def cf_enc(tile):
        # cfitsio's tile writer (imcomp_compress_tile) passes the tile's
        # dims in this order for a row-major buffer — verified against a
        # real fits_set_compression_type-written file.
        a = np.array(tile, dtype=np.int32)  # fresh copy: mutated in place
        buf = ctypes.create_string_buffer(a.size * 8 + 1024)
        nb = ctypes.c_long(len(buf))
        st = c_int(0)
        r = lib.fits_hcompress(a.ctypes.data, a.shape[1], a.shape[0], 0,
                               buf, byref(nb), byref(st))
        assert r == 0 and st.value == 0, (r, st.value)
        return bytes(buf.raw[:nb.value])

    def cf_dec(stream, npix):
        out = np.zeros(npix, dtype=np.int32)
        ny = c_int(0)
        nx = c_int(0)
        sc = c_int(0)
        st = c_int(0)
        r = lib.fits_hdecompress(stream, 0, out.ctypes.data, byref(ny),
                                 byref(nx), byref(sc), byref(st))
        assert r == 0 and st.value == 0, (r, st.value)
        return out

    rng = np.random.default_rng(31)
    shapes = [(4, 6), (5, 5), (5, 8), (7, 64), (64, 7), (17, 32), (33, 33),
              (13, 21), (128, 5), (9, 9), (30, 45), (16, 128)]
    for shape in shapes:
        lo, hi = sorted(rng.integers(-60000, 60000, size=2))
        a = rng.integers(lo, hi + 1, size=shape).astype(np.int32)
        # theirs -> ours
        s = cf_enc(a)
        dec, nx, ny = hcomp_decode(np.frombuffer(s, dtype=np.uint8), a.size)
        assert (nx, ny) == shape
        np.testing.assert_array_equal(np.asarray(dec).reshape(shape), a)
        # ours -> theirs, and byte-identity
        mine = np.asarray(hcomp_encode(a.copy(), 0)).tobytes()
        assert mine == s, f"stream not byte-identical for {shape}"
        np.testing.assert_array_equal(cf_dec(mine, a.size).reshape(shape), a)


def test_hcompress_real_cfitsio_file_bidirectional(tmp_path):
    """Full-file interop both ways: a FITS written through cfitsio's own
    tile-compression path (non-square tiles with partial edge tiles) reads
    back exactly through our reader, and a file written by the port's
    CompImageHDU writer reads back exactly through cfitsio."""
    import ctypes

    lib = _load_cfitsio()
    if lib is None or not hasattr(lib, "ffinit"):
        pytest.skip("libcfitsio not available")
    c_int, byref = ctypes.c_int, ctypes.byref
    lib.ffinit.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p,
                           ctypes.POINTER(c_int)]
    lib.ffopen.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p,
                           c_int, ctypes.POINTER(c_int)]
    lib.fits_set_compression_type.argtypes = [ctypes.c_void_p, c_int,
                                              ctypes.POINTER(c_int)]
    lib.fits_set_tile_dim.argtypes = [ctypes.c_void_p, c_int, ctypes.c_void_p,
                                      ctypes.POINTER(c_int)]
    lib.fits_set_hcomp_scale.argtypes = [ctypes.c_void_p, ctypes.c_float,
                                         ctypes.POINTER(c_int)]
    lib.ffcrim.argtypes = [ctypes.c_void_p, c_int, c_int, ctypes.c_void_p,
                           ctypes.POINTER(c_int)]
    lib.ffpprk.argtypes = [ctypes.c_void_p, c_int, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_void_p,
                           ctypes.POINTER(c_int)]
    lib.ffgpvk.argtypes = [ctypes.c_void_p, c_int, ctypes.c_longlong,
                           ctypes.c_longlong, c_int, ctypes.c_void_p,
                           ctypes.POINTER(c_int), ctypes.POINTER(c_int)]
    lib.ffclos.argtypes = [ctypes.c_void_p, ctypes.POINTER(c_int)]

    rows, cols = 37, 52
    rng = np.random.default_rng(41)
    img = rng.integers(-2000, 3000, size=(rows, cols)).astype(np.int32)

    # --- cfitsio writes, we read ---
    path_cf = str(tmp_path / "cf_hcomp.fits").encode()
    f = ctypes.c_void_p()
    st = c_int(0)
    lib.ffinit(byref(f), b"!" + path_cf, byref(st))
    assert st.value == 0
    lib.fits_set_compression_type(f, 41, byref(st))  # HCOMPRESS_1
    assert st.value == 0
    tdim = (ctypes.c_long * 2)(20, 16)  # ZTILE1=20 cols, ZTILE2=16 rows
    lib.fits_set_tile_dim(f, 2, tdim, byref(st))
    assert st.value == 0
    lib.fits_set_hcomp_scale(f, ctypes.c_float(0.0), byref(st))
    assert st.value == 0
    naxes = (ctypes.c_long * 2)(cols, rows)
    lib.ffcrim(f, 32, 2, naxes, byref(st))
    assert st.value == 0
    lib.ffpprk(f, 0, 1, rows * cols, img.ctypes.data, byref(st))
    assert st.value == 0
    lib.ffclos(f, byref(st))
    assert st.value == 0

    hdu = fits.open(path_cf.decode())[1]
    assert hdu.header["ZCMPTYPE"] == "HCOMPRESS_1"
    np.testing.assert_array_equal(np.asarray(hdu.data, dtype=np.int64), img)

    # --- we write, cfitsio reads ---
    path_us = str(tmp_path / "us_hcomp.fits")
    fits.write(path_us, [fits.PrimaryHDU(),
                         fits.CompImageHDU(data=img, name="IMG",
                                           compression_type="HCOMPRESS_1")])
    lib.ffmahd.argtypes = [ctypes.c_void_p, c_int, ctypes.POINTER(c_int),
                           ctypes.POINTER(c_int)]
    f2 = ctypes.c_void_p()
    st = c_int(0)
    lib.ffopen(byref(f2), path_us.encode(), 0, byref(st))
    assert st.value == 0, st.value
    hdutype = c_int(0)
    lib.ffmahd(f2, 2, byref(hdutype), byref(st))  # the compressed image HDU
    assert st.value == 0, st.value
    out = np.zeros(rows * cols, dtype=np.int32)
    anynul = c_int(0)
    lib.ffgpvk(f2, 0, 1, rows * cols, 0, out.ctypes.data, byref(anynul),
               byref(st))
    assert st.value == 0, st.value
    lib.ffclos(f2, byref(st))
    np.testing.assert_array_equal(out.reshape(rows, cols), img)


@pytest.mark.parametrize("ctype", ["RICE_1", "GZIP_1", "GZIP_2", "PLIO_1"])
def test_cfitsio_reads_our_compressed_files(tmp_path, ctype):
    """Every ZCMPTYPE our writer emits must be readable by cfitsio (the
    engine under astropy) — guards the mandated BINTABLE keyword order
    (TFIELDS 8th) and the per-codec stream conventions."""
    import ctypes

    lib = _load_cfitsio()
    if lib is None or not hasattr(lib, "ffopen"):
        pytest.skip("libcfitsio not available")
    c_int, byref = ctypes.c_int, ctypes.byref
    lib.ffopen.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p,
                           c_int, ctypes.POINTER(c_int)]
    lib.ffmahd.argtypes = [ctypes.c_void_p, c_int, ctypes.POINTER(c_int),
                           ctypes.POINTER(c_int)]
    lib.ffgpvk.argtypes = [ctypes.c_void_p, c_int, ctypes.c_longlong,
                           ctypes.c_longlong, c_int, ctypes.c_void_p,
                           ctypes.POINTER(c_int), ctypes.POINTER(c_int)]
    lib.ffclos.argtypes = [ctypes.c_void_p, ctypes.POINTER(c_int)]

    rows, cols = 29, 41
    rng = np.random.default_rng(43)
    if ctype == "PLIO_1":
        img = rng.integers(0, 12, size=(rows, cols)).astype(np.int32)
    else:
        img = rng.integers(-900, 1200, size=(rows, cols)).astype(np.int32)
    path = str(tmp_path / f"us_{ctype.lower()}.fits")
    fits.write(path, [fits.PrimaryHDU(),
                      fits.CompImageHDU(data=img, name="IMG",
                                        compression_type=ctype)])
    f = ctypes.c_void_p()
    st = c_int(0)
    lib.ffopen(byref(f), path.encode(), 0, byref(st))
    assert st.value == 0, st.value
    hdutype = c_int(0)
    lib.ffmahd(f, 2, byref(hdutype), byref(st))
    assert st.value == 0, st.value
    out = np.zeros(rows * cols, dtype=np.int32)
    anynul = c_int(0)
    lib.ffgpvk(f, 0, 1, rows * cols, 0, out.ctypes.data, byref(anynul),
               byref(st))
    assert st.value == 0, st.value
    lib.ffclos(f, byref(st))
    np.testing.assert_array_equal(out.reshape(rows, cols), img)


def test_native_decoders_survive_malformed_streams():
    """Fuzz the C++ decoders with garbage, truncations, and bit flips:
    they must raise (or decode to something) — never crash or scribble.
    A longer 18k-case run of this generator passed during development;
    this is the fast regression slice."""
    from euispice_coreg_tpu_torch.io.native import (hcomp_decode, hcomp_encode,
                                              plio_decode, plio_encode,
                                              rice_decode, rice_encode)

    rng = np.random.default_rng(0)

    def try_dec(fn, *args):
        try:
            fn(*args)
        except Exception:
            pass  # clean rejection is the expected path

    for _ in range(120):
        npix = int(rng.integers(1, 513))
        junk = rng.integers(0, 256,
                            size=int(rng.integers(1, 400))).astype(np.uint8)
        try_dec(rice_decode, junk, npix, 32, 4)
        try_dec(hcomp_decode, junk, npix)
        try_dec(plio_decode, junk[: (junk.size // 2) * 2].view(np.int16), npix)

    for _ in range(60):
        n = int(rng.integers(4, 200))
        a = rng.integers(-3000, 3000, size=n).astype(np.int32)
        r = rice_encode(a, 32, 4)
        try_dec(rice_decode, r[: int(rng.integers(0, r.size))], n, 32, 4)
        rf = r.copy()
        rf[int(rng.integers(0, rf.size))] ^= 1 << int(rng.integers(0, 8))
        try_dec(rice_decode, rf, n, 32, 4)

        rows, cols = int(rng.integers(2, 20)), int(rng.integers(2, 20))
        h = hcomp_encode(
            rng.integers(-500, 500, size=(rows, cols)).astype(np.int32), 0)
        try_dec(hcomp_decode, h[: int(rng.integers(0, h.size))], rows * cols)
        hf = h.copy()
        hf[int(rng.integers(0, hf.size))] ^= 1 << int(rng.integers(0, 8))
        try_dec(hcomp_decode, hf, rows * cols)

        m = rng.integers(0, 9, size=int(rng.integers(1, 300))).astype(np.int32)
        p = plio_encode(m)
        try_dec(plio_decode, p[: int(rng.integers(0, p.size))], m.size)
        pf = np.array(p, dtype=np.int16)
        pf[int(rng.integers(0, pf.size))] ^= np.int16(
            1 << int(rng.integers(0, 15)))
        try_dec(plio_decode, pf, m.size)


def test_fits_open_survives_corrupted_files():
    """Whole-file fuzz: truncations, bit flips, and garbage through
    fits.open + data decode must raise cleanly (or tolerate benign pixel
    corruption) — never crash or hang.  Fast slice of a 1000-case run."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 1000, size=(24, 31)).astype(np.int32)
    f32 = rng.normal(size=(16, 18)).astype(np.float32)
    buf = fits.serialize([fits.PrimaryHDU(data=f32),
                          fits.CompImageHDU(data=img, name="C",
                                            compression_type="RICE_1",
                                            tile_shape=(8, 16))]) \
        if hasattr(fits, "serialize") else None
    if buf is None:
        import tempfile
        import os
        with tempfile.TemporaryDirectory() as td:
            p = os.path.join(td, "v.fits")
            fits.write(p, [fits.PrimaryHDU(data=f32),
                           fits.CompImageHDU(data=img, name="C",
                                             compression_type="RICE_1",
                                             tile_shape=(8, 16))])
            buf = open(p, "rb").read()

    def attempt(blob):
        try:
            for h in fits.open(blob):
                _ = h.data
        except Exception:
            pass

    for _ in range(40):
        attempt(buf[: int(rng.integers(0, len(buf)))])
    for _ in range(40):
        b = bytearray(buf)
        for _k in range(int(rng.integers(1, 8))):
            b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
        attempt(bytes(b))
    for _ in range(20):
        attempt(bytes(rng.integers(0, 256, size=int(
            rng.integers(0, 6000))).astype(np.uint8)))


def test_hcompress_dims_mismatch_rejected():
    """A stream whose embedded dims multiply to npix but disagree with the
    tile shape must raise, not reshape to silently garbled pixels."""
    from euispice_coreg_tpu_torch.io.native import hcomp_encode
    from euispice_coreg_tpu_torch.io.tile_compression import _decode_tile_ints

    a = np.arange(4 * 6, dtype=np.int32).reshape(4, 6)
    s = np.asarray(hcomp_encode(a, 0)).tobytes()  # embeds (4, 6)
    # correct tile shape decodes
    got = _decode_tile_ints(s, 24, "HCOMPRESS_1", 32, 4, zbitpix=32,
                            quantized=False, tile_hw=(4, 6))
    np.testing.assert_array_equal(got.reshape(4, 6), a)
    # swapped tile shape is a loud error
    with pytest.raises(ValueError, match="dims"):
        _decode_tile_ints(s, 24, "HCOMPRESS_1", 32, 4, zbitpix=32,
                          quantized=False, tile_hw=(6, 4))


# ---------------------------------------------------------------------------
# committed cfitsio fixtures: float quantization interop pinned across rounds
# (written by tools/gen_fits_fixtures.py where libcfitsio exists)
# ---------------------------------------------------------------------------

_FIXDIR = pathlib.Path(__file__).parent / "data"


@pytest.mark.parametrize("stem", ["cfitsio_hcomp_float_d1",
                                  "cfitsio_rice_float_d1"])
def test_float_quantized_cfitsio_fixture(stem):
    """Bit-exact decode of cfitsio-written float32 images (HCOMPRESS_1 and
    RICE_1, quantize level 16, SUBTRACTIVE_DITHER_1, ZDITHER0=4242, one
    all-NaN tile, partial edge tiles) against cfitsio's OWN decode of the
    same file, both committed.  Hermetic: pins the full quantized-float
    read path — dither RNG sequence, per-tile ZSCALE/ZZERO, gzip fallback
    for the unquantizable all-NaN tile — with no libcfitsio at runtime.

    The scene deliberately has NO isolated in-tile NaNs: under
    SUBTRACTIVE_DITHER_1 cfitsio's writer dithers the NULL code along with
    the data (NULL_VALUE + rand - 0.5 rounds to INT32_MIN for rand < 0.5),
    so even cfitsio's own reader returns garbage at such pixels — there is
    no interop ground truth for that case (see tools/gen_fits_fixtures.py).
    Mirrors the reference's reliance on astropy/cfitsio for compressed
    files (euispice_coreg/utils/Util.py)."""
    hdu = fits.open(str(_FIXDIR / f"{stem}.fits"))[1]
    expected = np.load(_FIXDIR / f"{stem}_expected.npy")
    got = np.asarray(hdu.data, dtype=np.float32)
    fin = np.isfinite(expected)
    assert np.array_equal(fin, np.isfinite(got))
    np.testing.assert_array_equal(got[fin], expected[fin])
    assert hdu.header["ZDITHER0"] == 4242


@pytest.mark.parametrize("ctype", ["HCOMPRESS_1", "RICE_1"])
def test_float_quantized_write_bytes_stable(tmp_path, ctype):
    """The port's compressed float output is byte for byte the golden the
    JAX writer committed (quantization decisions, dither sequence, codec
    streams, header serialization).  The golden is only read here."""
    rng = np.random.default_rng(23)
    y, x = np.mgrid[0:37, 0:52]
    img = (1500.0 + 80.0 * np.sin(x / 7.0) * np.cos(y / 5.0)
           + rng.normal(scale=4.0, size=(37, 52))).astype(np.float32)
    img[0:16, 20:40] = np.nan      # all-NaN tile -> lossless fallback
    img[20, 5] = np.nan            # in-tile NaN: the writer handles it
    path = tmp_path / f"w_{ctype}.fits"
    fits.write(path, [fits.PrimaryHDU(),
                      fits.CompImageHDU(data=img, name="W",
                                        compression_type=ctype,
                                        tile_shape=(16, 20),
                                        quantize_level=16.0,
                                        quantize_method="SUBTRACTIVE_DITHER_1",
                                        dither_seed=4242)])
    got = path.read_bytes()

    golden = _FIXDIR / f"writer_{ctype.lower()}_float_golden.fits"
    assert got == golden.read_bytes(), f"{ctype}: differs from {golden.name}"

    # and the round-trip keeps exact NaN footprint incl. the in-tile NaN
    back = np.asarray(fits.open(str(path))[1].data)
    assert np.array_equal(np.isfinite(back), np.isfinite(img))
    fin = np.isfinite(img)
    assert np.abs(back[fin] - img[fin]).max() < 1.5
