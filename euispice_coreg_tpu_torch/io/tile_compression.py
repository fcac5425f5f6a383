"""Tile-compressed FITS image support
(RICE_1, GZIP_1, GZIP_2, HCOMPRESS_1, PLIO_1, NOCOMPRESS — the full set of
ZCMPTYPEs astropy's CompImageHDU reads).

This fills the role cfitsio's compiled codecs play underneath astropy's
``CompImageHDU`` in the reference stack (the reference opens RICE-compressed
EUI L2 files and re-wraps corrected windows as ``CompImageHDU`` with <f4 data,
``euispice_coreg/utils/Util.py:143-150``).  Implements the
FITS Tiled Image Compression Convention (White et al. 2013):

- integer images: lossless RICE_1 (native C++ codec in ``io/native/rice.cpp``
  bound through ctypes), HCOMPRESS_1 (native codec in
  ``io/native/hcompress.cpp``), PLIO_1 (IRAF line lists for mask images,
  ``io/native/plio.cpp``), GZIP_1, GZIP_2 (byte-plane shuffled gzip);
- floating-point images: per-tile linear quantization with ZSCALE/ZZERO
  table columns, ``NO_DITHER`` / ``SUBTRACTIVE_DITHER_1`` /
  ``SUBTRACTIVE_DITHER_2`` (the cfitsio Park-Miller random sequence),
  ZBLANK NaN encoding, and the lossless GZIP_COMPRESSED_DATA per-tile
  fallback for tiles that cannot be quantized;
- lossless float GZIP_1/GZIP_2 (no quantization columns).
"""
from __future__ import annotations

import zlib

import numpy as np

from ..core.header import Header
from . import native

BLOCK = 2880
CARD = 80

# cfitsio's integer substitute for NaN in quantized tiles (quantize.c NULL_VALUE)
NULL_VALUE = -2147483647
# SUBTRACTIVE_DITHER_2 reserved code for exact float zeros (ZERO_VALUE)
ZERO_VALUE = -2147483646

N_RANDOM = 10000

_rand_cache = None


def _dither_randoms() -> np.ndarray:
    """cfitsio ``fits_init_randoms``: 10000 Park-Miller (a=16807, m=2^31-1)
    uniforms from seed 1.  This exact sequence is mandated by the tiled-image
    convention so any compliant reader inverts the dither bit-exactly."""
    global _rand_cache
    if _rand_cache is None:
        a, m = 16807.0, 2147483647.0
        seed = 1.0
        vals = np.empty(N_RANDOM, dtype=np.float64)
        for i in range(N_RANDOM):
            temp = a * seed
            seed = temp - m * np.floor(temp / m)
            vals[i] = seed / m
        _rand_cache = vals
    return _rand_cache


def _tile_randoms(row: int, dither0: int, npix: int) -> np.ndarray:
    """The dither uniforms for 0-based tile ``row`` with seed ZDITHER0.

    The sequence is runs of consecutive ``rv`` values: start at
    ``rv[int(rv[iseed]*500)]``, walk forward, and on every wrap past 10000
    re-seed from the next ``iseed`` — vectorized as per-run slice copies
    (a per-pixel Python loop took seconds per 2048^2 image)."""
    rv = _dither_randoms()
    iseed = int((dither0 - 1 + row) % N_RANDOM)
    irand = int(rv[iseed] * 500.0)
    out = np.empty(npix, dtype=np.float64)
    filled = 0
    while filled < npix:
        run = min(N_RANDOM - irand, npix - filled)
        out[filled: filled + run] = rv[irand: irand + run]
        filled += run
        irand += run
        if irand == N_RANDOM:
            iseed = (iseed + 1) % N_RANDOM
            irand = int(rv[iseed] * 500.0)
    return out


def _hcomp_range_ok(max_abs: float, nx: int, ny: int) -> bool:
    """True when |codes| <= max_abs survive the H-transform in int32.

    Coefficients grow coherently up to ~2^(log2n + 1) x the pixel scale on
    constant fields (each of the log2n reduction levels can double the
    odd-edge terms), so require max_abs * 2^(log2n + 1) < 2^31."""
    import math

    nmax = max(int(nx), int(ny), 1)
    log2n = max(int(math.ceil(math.log2(nmax))), 0) if nmax > 1 else 0
    return float(max_abs) < 2.0 ** (30 - log2n)


def _nint(x: np.ndarray) -> np.ndarray:
    """cfitsio NINT: round half away from zero (NaN -> 0; callers mask)."""
    x = np.nan_to_num(x, nan=0.0)
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)).astype(np.int64)


def _tile_grid(hdr: Header):
    znaxis = int(hdr["ZNAXIS"])
    dims = [int(hdr[f"ZNAXIS{i}"]) for i in range(1, znaxis + 1)]  # FITS order
    tiles = []
    for i in range(1, znaxis + 1):
        default = dims[i - 1] if i == 1 else 1
        tiles.append(int(hdr.get(f"ZTILE{i}", default)))
    return dims, tiles


_TFORM_SIZE = {"L": 1, "X": 1, "B": 1, "I": 2, "J": 4, "K": 8,
               "A": 1, "E": 4, "D": 8, "C": 8, "M": 16}


def _column_descr(hdr: Header):
    """Binary-table column layout: ``{TTYPE: (byte offset, kind)}``.

    ``kind`` is ``"PB"``/``"QB"`` for variable-length byte arrays, otherwise
    the TFORM type letter (fixed-size repeat)."""
    tfields = int(hdr["TFIELDS"])
    offset = 0
    cols = {}
    for i in range(1, tfields + 1):
        tform = str(hdr[f"TFORM{i}"]).strip().upper()
        ttype = str(hdr.get(f"TTYPE{i}", f"col{i}")).strip()
        base = tform.lstrip("0123456789")
        rep = tform[: len(tform) - len(base)]
        rep = int(rep) if rep else 1
        if base.startswith("P") and len(base) >= 2 and base[1] in _TFORM_SIZE:
            size, kind = 8 * rep, "P" + base[1]  # 32-bit (count, offset) pair
        elif base.startswith("Q") and len(base) >= 2 and base[1] in _TFORM_SIZE:
            size, kind = 16 * rep, "Q" + base[1]  # 64-bit pair
        elif base.startswith("X"):
            size, kind = -(-rep // 8), "X"  # bit array: ceil(n/8) bytes
        elif base and base[0] in _TFORM_SIZE:
            size, kind = _TFORM_SIZE[base[0]] * rep, base[0]
        else:
            raise NotImplementedError(f"TFORM {tform!r} in compressed HDU")
        cols[ttype.upper()] = (offset, kind)
        offset += size
    return cols, offset


def _read_heap_bytes(rows, heap, row, col):
    """Heap payload of a variable-length column.  The descriptor's count is
    in ELEMENTS; the byte length is count x element size (1 for B, 2 for the
    I shorts PLIO_1 uses, ...)."""
    off, kind = col
    if kind.startswith("P") and len(kind) == 2:
        n, hoff = np.frombuffer(rows[row, off: off + 8].tobytes(), dtype=">i4")
    elif kind.startswith("Q") and len(kind) == 2:
        n, hoff = np.frombuffer(rows[row, off: off + 16].tobytes(), dtype=">i8")
    else:
        raise ValueError("not a variable-length column")
    nbytes = int(n) * _TFORM_SIZE[kind[1]]
    return heap[int(hoff): int(hoff) + nbytes]


def _read_scalar(rows, row, col, dtype_letter_map={"D": ">f8", "E": ">f4",
                                                   "J": ">i4", "K": ">i8",
                                                   "I": ">i2"}):
    off, kind = col
    dt = np.dtype(dtype_letter_map[kind])
    return np.frombuffer(rows[row, off: off + dt.itemsize].tobytes(), dtype=dt)[0]


def _gzip2_shuffle(raw_be: bytes, itemsize: int) -> bytes:
    """GZIP_2 byte-plane shuffle: all MSBs first, then next byte, ..."""
    a = np.frombuffer(raw_be, dtype=np.uint8).reshape(-1, itemsize)
    return a.T.tobytes()


def _gzip2_unshuffle(raw: bytes, itemsize: int) -> bytes:
    a = np.frombuffer(raw, dtype=np.uint8).reshape(itemsize, -1)
    return a.T.tobytes()


def _gzip_compress(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, 31)  # gzip wrapper, mtime-free
    return co.compress(data) + co.flush()


def _gzip_decompress(data: bytes) -> bytes:
    return zlib.decompressobj(47).decompress(bytes(data))  # auto gzip/zlib


_ZBITPIX_BE = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8", -32: ">f4", -64: ">f8"}


def _decode_tile_ints(comp, npix, zcmptype, blocksize, bytepix, zbitpix,
                      quantized, tile_hw=None):
    """Decode one COMPRESSED_DATA payload into integer (or raw float) pixels.

    HCOMPRESS_1 streams embed their own 2-D dims as (rows, cols) — the
    convention of real cfitsio-written files (our encoder is byte-identical
    to cfitsio's, verified on genuine ``fits_set_compression_type``-written
    files incl. non-square tiles; see the cfitsio cross-validation tests in
    tests/test_fits_io.py).  The inverse H-transform recovers the tile's
    original flat row-major pixel order directly, so the decoded stream is
    returned flat — no transposition (an earlier swapped-dims heuristic
    here would have CORRUPTED data on any stream it fired on).  Embedded
    dims that disagree with ``tile_hw`` (rows, cols) raise instead of
    reshaping to garbled pixels."""
    if zcmptype == "RICE_1":
        return native.rice_decode(np.frombuffer(bytes(comp), dtype=np.uint8),
                                  npix, blocksize, bytepix).astype(np.int64)
    if zcmptype == "HCOMPRESS_1":
        arr2d, nx, ny = native.hcomp_decode(
            np.frombuffer(bytes(comp), dtype=np.uint8), npix)
        if tile_hw is not None and (nx, ny) != tuple(tile_hw):
            # dims that multiply to npix but don't match the tile would
            # reshape to silently garbled pixels — fail loudly instead
            raise ValueError(
                f"HCOMPRESS stream dims {(nx, ny)} != tile {tuple(tile_hw)}")
        return np.asarray(arr2d).reshape(-1).astype(np.int64)
    if zcmptype == "PLIO_1":
        ll = np.frombuffer(bytes(comp), dtype=">i2").astype(np.int16)
        return native.plio_decode(ll, npix).astype(np.int64)
    if zcmptype in ("GZIP_1", "GZIP_2"):
        raw = _gzip_decompress(comp)
        itemsize = len(raw) // npix
        if zcmptype == "GZIP_2":
            raw = _gzip2_unshuffle(raw, itemsize)
        # Quantized-float tiles gzip the quantized int32 codes; lossless
        # float tiles gzip the IEEE bytes themselves.
        if zbitpix < 0 and not quantized:
            dt = _ZBITPIX_BE[zbitpix]
            return np.frombuffer(raw, dtype=dt).astype(
                np.float32 if zbitpix == -32 else np.float64)
        dt = {1: ">u1", 2: ">i2", 4: ">i4", 8: ">i8"}[itemsize]
        return np.frombuffer(raw, dtype=dt).astype(np.int64)
    if zcmptype in ("NOCOMPRESS", "NONE", ""):
        dt = np.dtype(_ZBITPIX_BE[zbitpix])
        return np.frombuffer(bytes(comp), dtype=dt).astype(
            np.int64 if zbitpix > 0 else np.float64)
    raise NotImplementedError(f"compression {zcmptype!r} not supported")


def hdu_settings_from_header(hdr: Header) -> dict:
    """Recover the compression settings of an existing tile-compressed HDU
    (ZCMPTYPE / ZQUANTIZ / ZDITHER0 / NOISEBIT / ZTILE) so a re-write keeps
    the file's format instead of silently reverting to writer defaults."""
    out = {
        "compression_type": str(hdr.get("ZCMPTYPE", "RICE_1")).strip().upper()
        or "RICE_1",
        "quantize_method": str(hdr.get("ZQUANTIZ", "NO_DITHER")).strip().upper()
        or "NO_DITHER",
        "dither_seed": int(hdr.get("ZDITHER0", 1)),
        "quantize_level": 16.0,
        "tile_shape": None,
    }
    for i in range(1, 10):
        if str(hdr.get(f"ZNAME{i}", "")).strip().upper() == "NOISEBIT":
            out["quantize_level"] = float(hdr[f"ZVAL{i}"])
    if "ZTILE1" in hdr and "ZTILE2" in hdr:
        out["tile_shape"] = (int(hdr["ZTILE2"]), int(hdr["ZTILE1"]))
    if out["quantize_method"] not in ("NO_DITHER", "SUBTRACTIVE_DITHER_1",
                                      "SUBTRACTIVE_DITHER_2"):
        out["quantize_method"] = "NO_DITHER"
    return out


def decompress_hdu(hdr: Header, raw: bytes) -> np.ndarray:
    """Decode a tile-compressed binary-table payload to an image.

    Covers everything astropy's CompImageHDU reader handles for 2-D images:
    RICE_1 / HCOMPRESS_1 / PLIO_1 / GZIP_1 / GZIP_2 / NOCOMPRESS payloads,
    per-tile ZSCALE/ZZERO
    quantization columns with all three ZQUANTIZ modes, ZBLANK (header card or
    column), and the GZIP_COMPRESSED_DATA / UNCOMPRESSED_DATA fallback
    columns for unquantizable tiles.
    """
    zcmptype = str(hdr.get("ZCMPTYPE", "")).strip().upper()
    dims, tiles = _tile_grid(hdr)
    if len(dims) == 3 and dims[2] == 1:
        dims, tiles = dims[:2], tiles[:2]
    if len(dims) != 2:
        raise NotImplementedError("only 2-D compressed images supported")
    width, height = dims[0], dims[1]
    tw, th = tiles[0], tiles[1]

    zbitpix = int(hdr["ZBITPIX"])
    blocksize, bytepix = 32, 4
    for i in range(1, 10):
        zname = str(hdr.get(f"ZNAME{i}", "")).strip().upper()
        if zname == "BLOCKSIZE":
            blocksize = int(hdr[f"ZVAL{i}"])
        elif zname == "BYTEPIX":
            bytepix = int(hdr[f"ZVAL{i}"])

    zquantiz = str(hdr.get("ZQUANTIZ", "")).strip().upper()
    dither0 = int(hdr.get("ZDITHER0", 1))

    naxis1 = int(hdr["NAXIS1"])
    nrows = int(hdr["NAXIS2"])
    theap = int(hdr.get("THEAP", naxis1 * nrows))
    cols, rowsize = _column_descr(hdr)
    if rowsize != naxis1:
        raise ValueError("binary table row size mismatch")

    rows = np.frombuffer(raw[: naxis1 * nrows], dtype=np.uint8).reshape(nrows, naxis1)
    heap = raw[theap:]

    ntx = -(-width // tw)
    nty = -(-height // th)
    if nrows != ntx * nty:
        raise ValueError("tile count mismatch")

    hdr_zscale = hdr.get("ZSCALE", hdr.get("BSCALE", 1))
    hdr_zzero = hdr.get("ZZERO", hdr.get("BZERO", 0))
    hdr_zblank = hdr.get("ZBLANK", hdr.get("BLANK"))
    # float payloads carrying integer codes => quantized (per-tile columns,
    # or legacy whole-image ZSCALE/ZZERO cards, or a RICE payload which is
    # integer by construction)
    quantized = zbitpix < 0 and (
        "ZSCALE" in cols or "ZZERO" in cols
        or "ZSCALE" in hdr or "ZZERO" in hdr
        or zcmptype in ("RICE_1", "HCOMPRESS_1", "PLIO_1")
    )

    if zbitpix == -32:
        out = np.empty((height, width), dtype=np.float32)
    elif zbitpix == -64 or quantized or hdr_zscale != 1 or hdr_zzero != 0 \
            or hdr_zblank is not None:
        out = np.empty((height, width), dtype=np.float64)
    else:
        out = np.empty((height, width), dtype=np.int64)

    c_comp = cols.get("COMPRESSED_DATA")
    c_gzfb = cols.get("GZIP_COMPRESSED_DATA")
    c_unc = cols.get("UNCOMPRESSED_DATA")

    for r in range(nrows):
        ty, tx = divmod(r, ntx)
        cur_w = min(tw, width - tx * tw)
        cur_h = min(th, height - ty * th)
        npix = cur_w * cur_h

        comp = _read_heap_bytes(rows, heap, r, c_comp) if c_comp else b""
        if len(comp):
            vals = _decode_tile_ints(comp, npix, zcmptype, blocksize,
                                     bytepix, zbitpix, quantized,
                                     tile_hw=(cur_h, cur_w))
        elif c_gzfb is not None and len(pay := _read_heap_bytes(rows, heap, r, c_gzfb)):
            # lossless fallback tile: gzip of the IEEE bytes, no quantization
            rawt = _gzip_decompress(pay)
            dt = np.dtype(_ZBITPIX_BE[zbitpix])
            if len(rawt) != npix * dt.itemsize:  # GZIP_2-style shuffled variant
                raise ValueError("fallback tile size mismatch")
            tile = np.frombuffer(rawt, dtype=dt).astype(out.dtype)
            out[ty * th: ty * th + cur_h, tx * tw: tx * tw + cur_w] = \
                tile.reshape(cur_h, cur_w)
            continue
        elif c_unc is not None and len(pay := _read_heap_bytes(rows, heap, r, c_unc)):
            dt = np.dtype(_ZBITPIX_BE[zbitpix])
            tile = np.frombuffer(bytes(pay), dtype=dt).astype(out.dtype)
            out[ty * th: ty * th + cur_h, tx * tw: tx * tw + cur_w] = \
                tile.reshape(cur_h, cur_w)
            continue
        else:
            raise ValueError(f"tile {r}: no compressed payload")

        if quantized:
            zscale = float(_read_scalar(rows, r, cols["ZSCALE"])) \
                if "ZSCALE" in cols else float(hdr_zscale)
            zzero = float(_read_scalar(rows, r, cols["ZZERO"])) \
                if "ZZERO" in cols else float(hdr_zzero)
            zblank = int(_read_scalar(rows, r, cols["ZBLANK"])) \
                if "ZBLANK" in cols else (int(hdr_zblank)
                                          if hdr_zblank is not None else NULL_VALUE)
            ints = vals.astype(np.int64)
            if zquantiz in ("SUBTRACTIVE_DITHER_1", "SUBTRACTIVE_DITHER_2"):
                rand = _tile_randoms(r, dither0, npix)
                ftile = (ints.astype(np.float64) - rand + 0.5) * zscale + zzero
            else:  # NO_DITHER / legacy linear scaling
                ftile = ints.astype(np.float64) * zscale + zzero
            ftile = np.where(ints == zblank, np.nan, ftile)
            if zquantiz == "SUBTRACTIVE_DITHER_2":
                ftile = np.where(ints == ZERO_VALUE, 0.0, ftile)
            out[ty * th: ty * th + cur_h, tx * tw: tx * tw + cur_w] = \
                ftile.reshape(cur_h, cur_w).astype(out.dtype)
        elif zbitpix < 0:
            out[ty * th: ty * th + cur_h, tx * tw: tx * tw + cur_w] = \
                vals.reshape(cur_h, cur_w).astype(out.dtype)
        else:
            tile = vals.astype(np.float64) if out.dtype.kind == "f" else vals
            if out.dtype.kind == "f":
                tile = tile * float(hdr_zscale) + float(hdr_zzero)
                if hdr_zblank is not None:
                    tile[vals == int(hdr_zblank)] = np.nan
            out[ty * th: ty * th + cur_h, tx * tw: tx * tw + cur_w] = \
                tile.reshape(cur_h, cur_w)

    if out.dtype.kind == "f":
        return out
    return out.astype({8: np.uint8, 16: np.int16, 32: np.int32, 64: np.int64}[zbitpix])


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _encode_tile_ints(arr_i4: np.ndarray, zcmptype: str, blocksize: int,
                      bytepix: int, tile_hw=None, hscale: int = 0) -> bytes:
    if zcmptype == "RICE_1":
        return native.rice_encode(arr_i4.ravel(), blocksize, bytepix).tobytes()
    if zcmptype == "HCOMPRESS_1":
        return native.hcomp_encode(
            np.asarray(arr_i4).reshape(tile_hw), hscale).tobytes()
    if zcmptype == "PLIO_1":
        return native.plio_encode(np.asarray(arr_i4).ravel()) \
            .astype(">i2").tobytes()
    if zcmptype == "GZIP_1":
        return _gzip_compress(arr_i4.astype(">i4").tobytes())
    if zcmptype == "GZIP_2":
        return _gzip_compress(_gzip2_shuffle(arr_i4.astype(">i4").tobytes(), 4))
    raise NotImplementedError(f"compression {zcmptype!r} for writing")


def _quantize_tile(tile: np.ndarray, row: int, quantize_level: float,
                   zquantiz: str, dither0: int, anchor: str = "bottom"):
    """Per-tile linear quantization following cfitsio ``fits_quantize_float``.

    Returns ``(ints, zscale, zzero)`` or ``None`` when the tile cannot be
    represented in the 32-bit integer range at the requested level (callers
    fall back to the lossless GZIP_COMPRESSED_DATA column, as cfitsio does).

    ``anchor="bottom"`` places codes at the bottom of the int32 range
    (RICE/GZIP convention); ``anchor="zero"`` starts codes near 0 —
    required for HCOMPRESS_1, whose H-transform sums coefficients and
    overflows on |codes| ~ 2^31.  NaN tiles under ``anchor="zero"`` return
    None (lossless fallback) since the NULL sentinel cannot ride through
    the transform.
    """
    flat = tile.ravel().astype(np.float64)
    finite = np.isfinite(flat)
    if anchor == "zero" and not finite.all():
        return None  # no transform-safe NULL code: lossless fallback
    if anchor == "zero" and zquantiz == "SUBTRACTIVE_DITHER_2" \
            and (flat == 0.0).any():
        # the ZERO_VALUE sentinel (-2^31+2) cannot ride the H-transform
        return None
    if not finite.any():
        return np.full(flat.shape, NULL_VALUE, dtype=np.int64), 1.0, 0.0
    vals = flat[finite]
    if quantize_level == 0:
        return None  # cfitsio semantics: qlevel 0 = lossless (gzip fallback)
    if quantize_level < 0:
        zscale = -float(quantize_level)
    else:
        # cfitsio noise3: sigma of the background from median absolute
        # third-order differences (FnNoise3 in quantize.c), over the tile.
        if vals.size >= 5:
            d = np.abs(2.0 * vals[2:-2] - vals[:-4] - vals[4:])
            noise3 = 0.6052697 * np.median(d)
        else:
            noise3 = 0.0
        if noise3 == 0.0:
            return None  # flat/noiseless tile: don't quantize (lossless path)
        zscale = noise3 / float(quantize_level)

    vmin, vmax = vals.min(), vals.max()
    if zquantiz == "SUBTRACTIVE_DITHER_2":
        nonzero = vals[vals != 0.0]
        if nonzero.size == 0:
            ints = np.full(flat.shape, ZERO_VALUE, dtype=np.int64)
            ints[~finite] = NULL_VALUE
            return ints, 1.0, 0.0
        vmin, vmax = nonzero.min(), nonzero.max()

    if anchor == "zero":
        # codes start near 0; guard the whole H-transform against int32
        # overflow (coherent coefficient growth ~2^(log2(max dim)+1))
        if not _hcomp_range_ok((vmax - vmin) / zscale + 10.0,
                               tile.shape[0], tile.shape[1]):
            return None
        zzero = vmin - zscale * 10.0  # q(vmin) = 10
    else:
        # anchor the integer range at the bottom of int32 like cfitsio
        # (N_RESERVED_VALUES = 10 codes below it kept for NULL/ZERO markers)
        if (vmax - vmin) / zscale > 4294967283.0:
            return None
        zzero = vmin - zscale * (NULL_VALUE + 10)  # q(vmin) = NULL_VALUE + 10

    q = (flat - zzero) / zscale
    if zquantiz in ("SUBTRACTIVE_DITHER_1", "SUBTRACTIVE_DITHER_2"):
        rand = _tile_randoms(row, dither0, flat.size)
        q = q + rand - 0.5
    ints = _nint(q)
    if zquantiz == "SUBTRACTIVE_DITHER_2":
        ints = np.where(flat == 0.0, ZERO_VALUE, ints)
    ints = np.where(finite, ints, NULL_VALUE)
    used = ints[finite & (ints != ZERO_VALUE)]
    if used.size and (used.min() < -2147483645 or used.max() > 2147483646):
        return None
    return ints, float(zscale), float(zzero)


def compress_hdu_bytes(hdu, compression_type: str | None = None,
                       quantize_level: float = 16.0,
                       quantize_method: str = "NO_DITHER",
                       dither_seed: int = 1) -> bytes:
    """Serialize a CompImageHDU as a tile-compressed BINTABLE.

    Integer data is stored losslessly (RICE_1 by default).  Floating-point
    data is quantized per tile with ZSCALE/ZZERO columns exactly as astropy
    writes the reference's corrected CompImageHDU windows
    (``euispice_coreg/utils/Util.py:143-150``); tiles that
    cannot be quantized (flat/noiseless) fall back to the lossless
    GZIP_COMPRESSED_DATA column.  ``quantize_method`` is one of
    ``NO_DITHER`` / ``SUBTRACTIVE_DITHER_1`` / ``SUBTRACTIVE_DITHER_2``.
    """
    from . import fits as fitsio

    data = np.asarray(hdu.data)
    if data.ndim != 2:
        raise NotImplementedError("only 2-D compressed images supported")
    zcmptype = (compression_type or getattr(hdu, "compression_type", None)
                or "RICE_1").upper()
    is_float = data.dtype.kind == "f"
    if zcmptype == "PLIO_1" and is_float:
        # quantized codes anchor at the bottom of int32, far outside the
        # PLIO [0, 2^24) range — cfitsio rejects this combination too
        raise ValueError("PLIO_1 stores integer mask data only; "
                         "use RICE_1/GZIP for floating-point images")
    zbitpix = (-32 if data.dtype.itemsize <= 4 else -64) if is_float else 32

    height, width = data.shape
    th_opt = getattr(hdu, "tile_shape", None)
    if zcmptype == "HCOMPRESS_1" and not th_opt:
        # hcompress needs 2-D tiles; default to the whole image (cfitsio
        # requires >= 4 rows per tile and whole rows)
        th_opt = (height, width)
    tile_h = th_opt[0] if th_opt else 1
    tile_w = th_opt[1] if th_opt else width
    blocksize, bytepix = 32, 4
    zquantiz = quantize_method.upper()
    if zquantiz not in ("NO_DITHER", "SUBTRACTIVE_DITHER_1",
                        "SUBTRACTIVE_DITHER_2"):
        raise ValueError(f"quantize_method {quantize_method!r}")

    ntx = -(-width // tile_w)
    nty = -(-height // tile_h)
    # PLIO payloads are int16 line-list words ('PI' column, counts in
    # elements); every other codec stores raw bytes ('PB')
    comp_tform, comp_esize = (("1PI", 2) if zcmptype == "PLIO_1"
                              else ("1PB", 1))
    comp_descs, gzfb_descs = [], []
    zscales, zzeros = [], []
    heap = bytearray()
    any_fallback = False
    for r in range(ntx * nty):
        ty, tx = divmod(r, ntx)
        tile = data[ty * tile_h: min((ty + 1) * tile_h, height),
                    tx * tile_w: min((tx + 1) * tile_w, width)]
        if is_float:
            qres = _quantize_tile(tile, r, quantize_level, zquantiz,
                                  dither_seed,
                                  anchor=("zero"
                                          if zcmptype == "HCOMPRESS_1"
                                          else "bottom"))
            if qres is None:
                be = tile.astype(">f4" if zbitpix == -32 else ">f8").tobytes()
                payload = _gzip_compress(be)
                gzfb_descs.append((len(payload), len(heap)))
                comp_descs.append((0, 0))
                zscales.append(1.0)
                zzeros.append(0.0)
                any_fallback = True
                heap.extend(payload)
                continue
            ints, zs, zz = qres
            zscales.append(zs)
            zzeros.append(zz)
            arr_i4 = ints.astype(np.int32)
        else:
            if zcmptype == "HCOMPRESS_1" and tile.size:
                amax = float(np.max(np.abs(tile.astype(np.int64))))
                if not _hcomp_range_ok(amax, tile.shape[0], tile.shape[1]):
                    raise ValueError(
                        "HCOMPRESS_1 cannot losslessly encode this integer "
                        f"dynamic range (max |value| {amax:.3g} on a "
                        f"{tile.shape} tile would overflow the int32 "
                        "H-transform); use RICE_1 or GZIP compression")
            arr_i4 = tile.astype(np.int32).ravel()
        payload = _encode_tile_ints(arr_i4, zcmptype, blocksize, bytepix,
                                    tile_hw=tile.shape)
        comp_descs.append((len(payload) // comp_esize, len(heap)))
        gzfb_descs.append((0, 0))
        heap.extend(payload)

    # row layout: COMPRESSED_DATA 1PB|1PI [, GZIP_COMPRESSED_DATA 1PB]
    #             [, ZSCALE 1D, ZZERO 1D]  (quantized float only)
    fields = [("COMPRESSED_DATA", comp_tform)]
    if is_float and any_fallback:
        fields.append(("GZIP_COMPRESSED_DATA", "1PB"))
    if is_float:
        fields += [("ZSCALE", "1D"), ("ZZERO", "1D")]
    naxis1 = 8 * len(fields)  # P-type descriptor pairs (1PB/1PI) and 1D doubles: 8 bytes each
    nrows = ntx * nty
    rows = np.zeros((nrows, naxis1), dtype=np.uint8)
    for r in range(nrows):
        off = 0
        for name, tform in fields:
            if name == "COMPRESSED_DATA":
                n, ho = comp_descs[r]
                rows[r, off: off + 8] = np.frombuffer(
                    np.array([n, ho], dtype=">i4").tobytes(), dtype=np.uint8)
                off += 8
            elif name == "GZIP_COMPRESSED_DATA":
                n, ho = gzfb_descs[r]
                rows[r, off: off + 8] = np.frombuffer(
                    np.array([n, ho], dtype=">i4").tobytes(), dtype=np.uint8)
                off += 8
            elif name == "ZSCALE":
                rows[r, off: off + 8] = np.frombuffer(
                    np.array([zscales[r]], dtype=">f8").tobytes(), dtype=np.uint8)
                off += 8
            elif name == "ZZERO":
                rows[r, off: off + 8] = np.frombuffer(
                    np.array([zzeros[r]], dtype=">f8").tobytes(), dtype=np.uint8)
                off += 8

    hdr = hdu.header
    cards_src = Header({
        "ZIMAGE": True,
        "ZCMPTYPE": zcmptype,
        "ZBITPIX": zbitpix,
        "ZNAXIS": 2,
        "ZNAXIS1": width,
        "ZNAXIS2": height,
        "ZTILE1": tile_w,
        "ZTILE2": tile_h,
    })
    if zcmptype == "HCOMPRESS_1":
        cards_src["ZNAME1"] = "SCALE"
        cards_src["ZVAL1"] = 0.0  # lossless H-transform (ints exact)
        cards_src["ZNAME2"] = "SMOOTH"
        cards_src["ZVAL2"] = 0
    elif zcmptype == "PLIO_1":
        pass  # PLIO has no codec parameters
    else:
        cards_src["ZNAME1"] = "BLOCKSIZE"
        cards_src["ZVAL1"] = blocksize
        cards_src["ZNAME2"] = "BYTEPIX"
        cards_src["ZVAL2"] = bytepix
    for i, (name, tform) in enumerate(fields, start=1):
        cards_src[f"TTYPE{i}"] = name
        cards_src[f"TFORM{i}"] = tform
    if is_float:
        cards_src["ZQUANTIZ"] = zquantiz
        cards_src["ZNAME3"] = "NOISEBIT"
        cards_src["ZVAL3"] = float(quantize_level)
        if zquantiz != "NO_DITHER":
            cards_src["ZDITHER0"] = int(dither_seed)
        if np.isnan(np.asarray(data, dtype=np.float64)).any():
            cards_src["ZBLANK"] = NULL_VALUE
    cards = [
        fitsio._make_card("XTENSION", "BINTABLE", "binary table extension"),
        fitsio._make_card("BITPIX", 8),
        fitsio._make_card("NAXIS", 2),
        fitsio._make_card("NAXIS1", naxis1),
        fitsio._make_card("NAXIS2", nrows),
        fitsio._make_card("PCOUNT", len(heap)),
        fitsio._make_card("GCOUNT", 1),
        # TFIELDS is MANDATED to be the 8th keyword of a BINTABLE
        # (FITS 4.0 §7.3.1); cfitsio/astropy refuse the HDU otherwise.
        fitsio._make_card("TFIELDS", len(fields)),
    ]
    for k, v in cards_src.items():
        cards.append(fitsio._make_card(k, v))
    skip = {"XTENSION", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2", "PCOUNT",
            "GCOUNT", "SIMPLE", "EXTEND", "BSCALE", "BZERO", "ZQUANTIZ",
            "ZDITHER0", "ZBLANK", "THEAP"} | set(cards_src.keys())
    skip |= {f"TTYPE{i}" for i in range(1, 10)} | {f"TFORM{i}" for i in range(1, 10)}
    skip |= {f"ZNAME{i}" for i in range(1, 10)} | {f"ZVAL{i}" for i in range(1, 10)}
    skip |= {f"ZNAXIS{i}" for i in range(1, 4)} | {f"ZTILE{i}" for i in range(1, 4)}
    skip |= {"ZIMAGE", "ZCMPTYPE", "ZBITPIX", "ZNAXIS", "TFIELDS", "ZSCALE",
             "ZZERO"}
    for k, v in hdr.items():
        if k in skip:
            continue
        cards.append(fitsio._make_card(k, v, hdr.comment(k)))
    out = fitsio._serialize_header(cards)
    payload = rows.tobytes() + bytes(heap)
    out += payload + b"\x00" * ((-len(payload)) % BLOCK)
    return out


def quantization_steps(path, index: int = 1) -> np.ndarray:
    """Each pixel's quantization step in HDU ``index`` of a tile-compressed
    file: its tile's ZSCALE, as a (height, width) float64 array, 0 where the
    tile is stored without quantization (integer data, the lossless gzip
    fallback).  A quantized pixel decodes within half a step of the value
    written (``NO_DITHER`` and both subtractive dithers)."""
    import io as _io

    from . import fits as fitsio

    with open(path, "rb") as f:
        fobj = _io.BytesIO(f.read())
    for i in range(index + 1):
        hdr = fitsio._parse_header_blocks(fobj)
        if str(hdr.get("XTENSION", "")).strip() == "BINTABLE":
            raw, naxis1, nrows = fitsio._read_bintable_raw(fobj, hdr)
        else:
            fitsio._read_data(fobj, hdr)
    if not hdr.get("ZIMAGE"):
        raise ValueError(f"HDU {index} of {path} is not tile-compressed")
    dims, tiles = _tile_grid(hdr)
    width, height = dims[0], dims[1]
    tw, th = tiles[0], tiles[1]
    cols, _ = _column_descr(hdr)
    rows = np.frombuffer(raw[: naxis1 * nrows], dtype=np.uint8).reshape(
        nrows, naxis1)
    heap = raw[int(hdr.get("THEAP", naxis1 * nrows)):]
    steps = np.zeros((height, width), dtype=np.float64)
    if int(hdr["ZBITPIX"]) > 0:
        return steps
    ntx = -(-width // tw)
    for r in range(nrows):
        ty, tx = divmod(r, ntx)
        if "ZSCALE" not in cols or not len(
                _read_heap_bytes(rows, heap, r, cols["COMPRESSED_DATA"])):
            continue
        steps[ty * th: (ty + 1) * th, tx * tw: (tx + 1) * tw] = \
            float(_read_scalar(rows, r, cols["ZSCALE"]))
    return steps
