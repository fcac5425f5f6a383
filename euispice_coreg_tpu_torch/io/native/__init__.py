"""ctypes bindings for the native C++ codecs (built on demand with g++).

The sources ``rice.cpp``, ``hcompress.cpp`` and ``plio.cpp`` beside this
file are compiled at first use into one shared library under the
git-ignored ``euispice_coreg_tpu_torch/build/``.  The library name carries
a hash of the three sources and the flags (as ``engine/_build.py`` keys the
CUDA builds), so a changed source rebuilds and an unchanged one is built
once per checkout.  The build writes a temporary file and renames it into
place, so concurrent processes never load a half-written library.  A
missing ``g++`` or a failed build raises: there is no other codec.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "rice.cpp"), os.path.join(_DIR, "hcompress.cpp"),
         os.path.join(_DIR, "plio.cpp")]
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def build_key() -> str:
    """Hash of the three sources and the flags: the library's name."""
    h = hashlib.sha256()
    for path in _SRCS:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(repr(GXX_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libeuicoreg_native-{build_key()}.so")


def _build(so: str):
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the FITS tile codecs are built "
                           "from io/native/*.cpp at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [gxx, *GXX_FLAGS, *_SRCS, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.isfile(so):
            _build(so)
        lib = ctypes.CDLL(so)
        lib.euicoreg_rice_encode.restype = ctypes.c_long
        lib.euicoreg_rice_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.euicoreg_rice_decode.restype = ctypes.c_int
        lib.euicoreg_rice_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.euicoreg_hcomp_info.restype = ctypes.c_int
        lib.euicoreg_hcomp_info.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.euicoreg_hcomp_decode.restype = ctypes.c_int
        lib.euicoreg_hcomp_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ]
        lib.euicoreg_hcomp_encode.restype = ctypes.c_long
        lib.euicoreg_hcomp_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_long,
        ]
        lib.euicoreg_plio_encode.restype = ctypes.c_long
        lib.euicoreg_plio_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ]
        lib.euicoreg_plio_decode.restype = ctypes.c_int
        lib.euicoreg_plio_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ]
        _lib = lib
        return lib


def rice_encode(pixels: np.ndarray, blocksize: int = 32, bytepix: int = 4) -> np.ndarray:
    """RICE_1-encode an int array; returns a uint8 array of compressed bytes."""
    lib = _load()
    a = np.ascontiguousarray(pixels, dtype=np.int32)
    npix = a.size
    # worst case: verbatim blocks + headers + first pixel + slack
    cap = npix * (bytepix + 1) + 64
    out = np.empty(cap, dtype=np.uint8)
    n = lib.euicoreg_rice_encode(
        a.ctypes.data, npix, out.ctypes.data, cap, blocksize, bytepix
    )
    if n < 0:
        raise RuntimeError("RICE encode buffer overflow")
    return out[:n].copy()


def hcomp_encode(tile: np.ndarray, scale: int = 0) -> np.ndarray:
    """HCOMPRESS-encode a 2-D int array; returns uint8 compressed bytes.

    ``scale=0``/1 is lossless; larger scales digitize the H-transform
    coefficients (lossy, error bounded by ~scale/2 per coefficient).
    Output is byte-identical to cfitsio's HCOMPRESS_1 tile streams
    (square and non-square tiles; the cfitsio-written files in
    ``tests/data/`` hold the codec to that)."""
    lib = _load()
    a = np.ascontiguousarray(tile, dtype=np.int32)
    if a.ndim != 2:
        raise ValueError("hcompress operates on 2-D tiles")
    cap = a.size * 8 + 1024
    out = np.empty(cap, dtype=np.uint8)
    n = lib.euicoreg_hcomp_encode(a.ctypes.data, a.shape[0], a.shape[1],
                                  int(scale), out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError(f"HCOMPRESS encode failed ({n})")
    return out[:n].copy()


def hcomp_decode(comp: np.ndarray, npix: int) -> tuple[np.ndarray, int, int]:
    """Decode an HCOMPRESS stream; returns (int32 array (nx, ny), nx, ny).

    ``nx`` is the slow axis (tile rows), ``ny`` the fast axis (tile cols) —
    the stream-embedded dims, matching real cfitsio-written files.  The
    flat element order of the returned array is the tile's original
    row-major pixel order."""
    lib = _load()
    c = np.ascontiguousarray(comp, dtype=np.uint8)
    nx = ctypes.c_int()
    ny = ctypes.c_int()
    scale = ctypes.c_int()
    rc = lib.euicoreg_hcomp_info(c.ctypes.data, c.size, ctypes.byref(nx),
                                 ctypes.byref(ny), ctypes.byref(scale))
    if rc != 0:
        raise ValueError(f"bad HCOMPRESS stream header (rc={rc})")
    nel = nx.value * ny.value
    if nel != npix:
        raise ValueError(
            f"HCOMPRESS tile holds {nel} pixels, expected {npix}")
    out = np.empty(nel, dtype=np.int32)
    rc = lib.euicoreg_hcomp_decode(c.ctypes.data, c.size, out.ctypes.data, nel)
    if rc != 0:
        raise ValueError(f"HCOMPRESS decode failed (rc={rc})")
    return out.reshape(nx.value, ny.value), nx.value, ny.value


def plio_encode(pixels: np.ndarray) -> np.ndarray:
    """PLIO_1-encode an int array; returns int16 line-list words.

    Valid pixel range is 0..2^24-1 (IRAF pixel lists are mask images);
    out-of-range values raise ``ValueError``."""
    lib = _load()
    a = np.ascontiguousarray(pixels, dtype=np.int32).ravel()
    # worst case: one SH pair + one HN per pixel, plus header and slack
    cap = a.size * 3 + 16
    out = np.empty(cap, dtype=np.int16)
    n = lib.euicoreg_plio_encode(a.ctypes.data, a.size, out.ctypes.data, cap)
    if n == -2:
        raise ValueError("PLIO_1 requires pixel values in [0, 2^24 - 1]")
    if n < 0:
        raise RuntimeError("PLIO encode buffer overflow")
    return out[:n].copy()


def plio_decode(ll: np.ndarray, npix: int) -> np.ndarray:
    """Decode PLIO_1 line-list shorts into an int32 array of ``npix``.

    A stream truncated mid-list decodes silently as trailing zeros rather
    than raising — this matches IRAF's implicit-trailing-zero semantics
    (and cfitsio's ``pl_l2pi``), so truncation of an all-zero tail is
    undetectable by design; keep for interop.
    """
    lib = _load()
    c = np.ascontiguousarray(ll, dtype=np.int16)
    out = np.empty(npix, dtype=np.int32)
    rc = lib.euicoreg_plio_decode(c.ctypes.data, c.size, out.ctypes.data, npix)
    if rc != 0:
        raise ValueError(f"PLIO decode failed (rc={rc})")
    return out


def rice_decode(comp: np.ndarray, npix: int, blocksize: int = 32, bytepix: int = 4) -> np.ndarray:
    """Decode RICE_1 bytes into an int32 array of ``npix`` pixels."""
    lib = _load()
    c = np.ascontiguousarray(comp, dtype=np.uint8)
    out = np.empty(npix, dtype=np.int32)
    rc = lib.euicoreg_rice_decode(
        c.ctypes.data, c.size, out.ctypes.data, npix, blocksize, bytepix
    )
    if rc != 0:
        raise RuntimeError(f"RICE decode failed (rc={rc})")
    return out
