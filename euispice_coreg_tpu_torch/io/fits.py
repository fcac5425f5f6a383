"""Self-contained FITS reader/writer (numpy only).

The reference relies on ``astropy.io.fits`` for all file access
(``euispice_coreg/hdrshift/alignment.py:299-300`` etc.).
astropy is not a dependency of this package, so this module implements the
FITS 4.0 byte format directly:

* 2880-byte header blocks of 80-char cards, END-terminated
* BITPIX 8/16/32/64/-32/-64 big-endian data, BSCALE/BZERO/BLANK scaling
* primary + IMAGE extensions, EXTNAME lookup, negative indexing
* tile-compressed (ZIMAGE binary-table) image extensions via the native
  C++ codecs in :mod:`euispice_coreg_tpu_torch.io.native` and
  :mod:`euispice_coreg_tpu_torch.io.tile_compression`
* ``http(s)://`` paths fetched with requests (like astropy's remote open)

Headers parse into :class:`euispice_coreg_tpu_torch.core.header.Header`;
data into numpy arrays.
"""
from __future__ import annotations

import io as _io
import os
import re

import numpy as np

from ..core.header import Header

BLOCK = 2880
CARD = 80

_BITPIX_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}
_DTYPE_BITPIX = {
    np.dtype("uint8"): 8,
    np.dtype("int16"): 16,
    np.dtype("int32"): 32,
    np.dtype("int64"): 64,
    np.dtype("float32"): -32,
    np.dtype("float64"): -64,
}

_NUMERIC_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([EDed][+-]?\d+)?$")


class HDU:
    """A header-data unit: :class:`Header` + numpy array (or None)."""

    def __init__(self, data=None, header: Header | None = None, name: str | None = None):
        self.header = header.copy() if header is not None else Header()
        self.data = data
        if name is not None:
            self.header["EXTNAME"] = name

    @property
    def name(self):
        return self.header.get("EXTNAME", "")


class PrimaryHDU(HDU):
    pass


class ImageHDU(HDU):
    pass


class CompImageHDU(HDU):
    """Tile-compressed image HDU (RICE_1 / GZIP_1 / GZIP_2 binary table).

    Integer data is compressed losslessly; float data is quantized per tile
    with ZSCALE/ZZERO columns (``quantize_level`` in background-noise sigmas,
    ``quantize_method`` of NO_DITHER / SUBTRACTIVE_DITHER_1 / _2), matching
    what astropy's CompImageHDU does underneath the reference."""

    def __init__(self, data=None, header=None, name=None, tile_shape=None,
                 compression_type="RICE_1", quantize_level=16.0,
                 quantize_method="NO_DITHER", dither_seed=1):
        super().__init__(data=data, header=header, name=name)
        self.tile_shape = tile_shape
        self.compression_type = compression_type
        self.quantize_level = quantize_level
        self.quantize_method = quantize_method
        self.dither_seed = dither_seed


class HDUList(list):
    """List of HDUs with astropy-style int / EXTNAME indexing."""

    def __getitem__(self, key):
        if isinstance(key, str):
            for hdu in self:
                if str(hdu.header.get("EXTNAME", "")).strip() == key:
                    return hdu
            raise KeyError(f"no HDU with EXTNAME {key!r}")
        return super().__getitem__(key)

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def writeto(self, path, overwrite=True):
        write(path, self, overwrite=overwrite)


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------

def _parse_value(raw: str):
    raw = raw.strip()
    if raw == "":
        return None
    if raw.startswith("'"):
        # FITS string: '' escapes a quote; value ends at the closing quote
        out = []
        i = 1
        while i < len(raw):
            if raw[i] == "'":
                if i + 1 < len(raw) and raw[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(raw[i])
            i += 1
        return "".join(out).rstrip()
    if raw == "T":
        return True
    if raw == "F":
        return False
    if _NUMERIC_RE.match(raw):
        if re.search(r"[.EDed]", raw):
            return float(raw.replace("D", "E").replace("d", "e"))
        return int(raw)
    return raw


def _parse_header_blocks(fobj) -> Header:
    hdr = Header()
    pending_key = None  # CONTINUE support
    while True:
        block = fobj.read(BLOCK)
        if len(block) < BLOCK:
            raise EOFError("truncated FITS header")
        text = block.decode("latin-1")
        done = False
        for i in range(0, BLOCK, CARD):
            card = text[i : i + CARD]
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if key in ("", "COMMENT", "HISTORY"):
                continue
            if key == "CONTINUE":
                if pending_key is not None:
                    rest = card[8:]
                    if "/" in rest:
                        rest = rest.split("/", 1)[0]
                    val = _parse_value(rest)
                    prev = hdr[pending_key]
                    if isinstance(prev, str) and prev.endswith("&"):
                        hdr[pending_key] = prev[:-1] + str(val)
                continue
            if card[8:10] != "= ":
                continue  # commentary card with value-less keyword
            body = card[10:]
            # split off inline comment (a '/' outside a quoted string)
            in_str = False
            cut = len(body)
            j = 0
            while j < len(body):
                ch = body[j]
                if ch == "'":
                    if in_str and j + 1 < len(body) and body[j + 1] == "'":
                        j += 2
                        continue
                    in_str = not in_str
                elif ch == "/" and not in_str:
                    cut = j
                    break
                j += 1
            value = _parse_value(body[:cut])
            comment = body[cut + 1 :].strip() if cut < len(body) else ""
            hdr[key] = value
            if comment:
                hdr.set_comment(key, comment)
            pending_key = key
        if done:
            break
    return hdr


def _data_shape(hdr: Header):
    naxis = int(hdr.get("NAXIS", 0))
    return tuple(int(hdr[f"NAXIS{i}"]) for i in range(naxis, 0, -1))


def _read_data(fobj, hdr: Header):
    shape = _data_shape(hdr)
    bitpix = int(hdr["BITPIX"])
    dtype = _BITPIX_DTYPE[bitpix]
    n = int(np.prod(shape)) if shape else 0
    pcount = int(hdr.get("PCOUNT", 0))
    gcount = int(hdr.get("GCOUNT", 1))
    nbytes = (n + pcount) * gcount * dtype.itemsize
    raw = fobj.read(nbytes)
    if len(raw) < nbytes:
        raise EOFError("truncated FITS data")
    # skip padding
    pad = (-nbytes) % BLOCK
    if pad:
        fobj.seek(pad, 1)
    if n == 0:
        return None
    arr = np.frombuffer(raw[: n * dtype.itemsize], dtype=dtype).reshape(shape)
    return _apply_scaling(arr, hdr)


def _apply_scaling(arr, hdr: Header):
    bscale = hdr.get("BSCALE", 1)
    bzero = hdr.get("BZERO", 0)
    blank = hdr.get("BLANK")
    if bscale == 1 and bzero == 0 and blank is None:
        return arr.astype(arr.dtype.newbyteorder("="))
    out = arr.astype(np.float64) * bscale + bzero
    if blank is not None and arr.dtype.kind in "iu":
        out[arr == blank] = np.nan
    # astropy keeps unsigned-int pseudo-types integral; float is fine for us
    return out


def _read_bintable_raw(fobj, hdr: Header):
    """Read the raw bytes of a binary table (rows + heap) without decoding."""
    naxis1 = int(hdr["NAXIS1"])
    naxis2 = int(hdr["NAXIS2"])
    pcount = int(hdr.get("PCOUNT", 0))
    nbytes = naxis1 * naxis2 + pcount
    raw = fobj.read(nbytes)
    if len(raw) < nbytes:
        raise EOFError("truncated FITS binary table")
    pad = (-nbytes) % BLOCK
    if pad:
        fobj.seek(pad, 1)
    return raw, naxis1, naxis2


def open(path_or_url, mode: str = "readonly") -> HDUList:  # noqa: A001
    """Open a FITS file (local path or http(s) URL) fully into memory."""
    if isinstance(path_or_url, (bytes, bytearray)):
        fobj = _io.BytesIO(path_or_url)
    elif hasattr(path_or_url, "read"):
        fobj = path_or_url
    elif str(path_or_url).startswith(("http://", "https://")):
        import requests

        resp = requests.get(str(path_or_url), timeout=120)
        resp.raise_for_status()
        fobj = _io.BytesIO(resp.content)
    else:
        fobj = _io.BytesIO(
            np.fromfile(os.fspath(path_or_url), dtype=np.uint8).tobytes()
        )

    # transparently handle gzip-compressed whole files (*.fits.gz), like
    # astropy.io.fits does for the reference
    head = fobj.read(2)
    fobj.seek(-len(head), 1)
    if head == b"\x1f\x8b":
        import gzip as _gzip

        fobj = _io.BytesIO(_gzip.decompress(fobj.read()))

    hdus = HDUList()
    first = True
    while True:
        pos = fobj.tell()
        probe = fobj.read(1)
        if not probe:
            break
        fobj.seek(pos)
        hdr = _parse_header_blocks(fobj)
        xtension = str(hdr.get("XTENSION", "")).strip()
        if first:
            hdus.append(PrimaryHDU(data=_read_data(fobj, hdr), header=hdr))
            first = False
        elif xtension == "IMAGE":
            hdus.append(ImageHDU(data=_read_data(fobj, hdr), header=hdr))
        elif xtension == "BINTABLE" and hdr.get("ZIMAGE"):
            raw, naxis1, naxis2 = _read_bintable_raw(fobj, hdr)
            from . import tile_compression

            data = tile_compression.decompress_hdu(hdr, raw)
            # carry the file's compression settings so a re-write keeps its
            # format (ZCMPTYPE/ZQUANTIZ/NOISEBIT/tiles) instead of reverting
            # to writer defaults
            hdus.append(CompImageHDU(
                data=data, header=hdr,
                **tile_compression.hdu_settings_from_header(hdr)))
        else:
            # unknown extension: skip payload, keep header only
            naxis1 = int(hdr.get("NAXIS1", 0))
            naxis2 = int(hdr.get("NAXIS2", 0))
            pcount = int(hdr.get("PCOUNT", 0))
            nbytes = naxis1 * naxis2 + pcount
            fobj.seek(nbytes + ((-nbytes) % BLOCK), 1)
            hdus.append(HDU(data=None, header=hdr))
    return hdus


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _format_value(value) -> str:
    if isinstance(value, bool):
        return "T".rjust(20) if value else "F".rjust(20)
    if isinstance(value, (int, np.integer)):
        return str(int(value)).rjust(20)
    if isinstance(value, (float, np.floating)):
        s = repr(float(value))
        if "e" in s:
            s = f"{float(value):.16E}"
        elif "." not in s and "inf" not in s and "nan" not in s:
            s += ".0"
        return s.rjust(20)
    s = str(value).replace("'", "''")
    return f"'{s:<8s}'"


def _make_card(key: str, value, comment: str = "") -> str:
    key = key.upper()[:8]
    if value is None:
        card = f"{key:<8s}"
    else:
        card = f"{key:<8s}= {_format_value(value)}"
        if comment:
            card += f" / {comment}"
    return card[:CARD].ljust(CARD)


_STRUCTURAL = (
    "SIMPLE", "XTENSION", "BITPIX", "NAXIS", "EXTEND", "PCOUNT", "GCOUNT",
    "BSCALE", "BZERO",
)


def _serialize_header(cards: list[str]) -> bytes:
    text = "".join(cards) + "END".ljust(CARD)
    pad = (-len(text)) % BLOCK
    text += " " * pad
    return text.encode("latin-1")


def _hdu_bytes(hdu: HDU, primary: bool) -> bytes:
    data = hdu.data
    hdr = hdu.header
    cards = []
    if data is None:
        bitpix, shape = 8, ()
        arr = None
    else:
        arr = np.asarray(data)
        if arr.dtype not in _DTYPE_BITPIX:
            arr = arr.astype(np.float32 if arr.dtype.kind == "f" else np.int64)
        bitpix = _DTYPE_BITPIX[arr.dtype]
        shape = arr.shape
    if primary:
        cards.append(_make_card("SIMPLE", True, "conforms to FITS standard"))
    else:
        cards.append(_make_card("XTENSION", "IMAGE", "Image extension"))
    cards.append(_make_card("BITPIX", bitpix))
    cards.append(_make_card("NAXIS", len(shape)))
    for i, n in enumerate(reversed(shape)):
        cards.append(_make_card(f"NAXIS{i + 1}", int(n)))
    if primary:
        cards.append(_make_card("EXTEND", True))
    else:
        cards.append(_make_card("PCOUNT", 0))
        cards.append(_make_card("GCOUNT", 1))
    skip = set(_STRUCTURAL) | {f"NAXIS{i}" for i in range(1, 10)}
    if arr is not None and arr.dtype.kind in "iu":
        # integer data may carry scale keys: keep them so reading applies
        # BSCALE/BZERO/BLANK (float data is always written unscaled)
        skip -= {"BSCALE", "BZERO"}
    for key, value in hdr.items():
        if key in skip:
            continue
        cards.append(_make_card(key, value, hdr.comment(key)))
    out = _serialize_header(cards)
    if arr is not None:
        raw = arr.astype(_BITPIX_DTYPE[bitpix]).tobytes()
        out += raw + b"\x00" * ((-len(raw)) % BLOCK)
    return out


def write(path, hdus, overwrite: bool = True):
    """Write an iterable of HDUs (first becomes the primary) to ``path``."""
    if not overwrite and os.path.exists(path):
        raise FileExistsError(path)
    blobs = []
    for i, hdu in enumerate(hdus):
        if isinstance(hdu, CompImageHDU):
            from . import tile_compression

            if i == 0:
                # compressed image cannot be primary: emit empty primary first
                blobs.append(_hdu_bytes(PrimaryHDU(), primary=True))
            blobs.append(tile_compression.compress_hdu_bytes(
                hdu,
                quantize_level=getattr(hdu, "quantize_level", 16.0),
                quantize_method=getattr(hdu, "quantize_method", "NO_DITHER"),
                dither_seed=getattr(hdu, "dither_seed", 1),
            ))
        else:
            blobs.append(_hdu_bytes(hdu, primary=(i == 0)))
    # atomic publish: a reader (or a resumed pipeline checking for finished
    # outputs, jitter_correction resume=True) must never see a truncated
    # file — write to a same-directory temp and rename into place
    path = str(path)
    tmp = os.path.join(os.path.dirname(path) or ".",
                       f".tmp-{os.getpid()}-{os.path.basename(path)}")
    try:
        with _io.open(tmp, "wb") as f:
            for b in blobs:
                f.write(b)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def writeto(path, data, header=None, overwrite=True):
    write(path, [PrimaryHDU(data=data, header=header)], overwrite=overwrite)
