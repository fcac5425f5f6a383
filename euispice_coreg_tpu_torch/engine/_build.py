"""Build and load the port's CUDA kernels.

Each kernel source in ``euispice_coreg_tpu_torch/csrc/`` is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
placed in ``euispice_coreg_tpu_torch/build/`` and loaded with ``ctypes``.
The library name carries a hash of the source and the flags, so a changed
source is rebuilt and an unchanged one is built once per checkout.  Nothing
is compiled or loaded at import time: the first launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no contraction into multiply-adds: every operation rounds like the
    # torch reference's (see the note in csrc/warp_score.cu)
    "-fmad=false",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0 when it was
# already on disk); read by chip_smoke.py
BUILD_SECONDS: dict[str, float] = {}


def find_nvcc() -> str:
    """``nvcc`` from CUDA_HOME/CUDA_PATH, PATH, or /usr/local/cuda."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; returns the CDLL."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(
                f.read() + repr(NVCC_FLAGS).encode()
            ).hexdigest()[:16]
        lib_path = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
        BUILD_SECONDS[name] = 0.0
        if not os.path.isfile(lib_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) building {src}:\n"
                        f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, lib_path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            BUILD_SECONDS[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(lib_path)
        _loaded[name] = lib
        return lib
