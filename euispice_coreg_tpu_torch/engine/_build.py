"""Build and load the port's CUDA kernels.

Each kernel source in ``euispice_coreg_tpu_torch/csrc/`` is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
placed in ``euispice_coreg_tpu_torch/build/`` and loaded with ``ctypes``.
The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a changed source or header is rebuilt
and an unchanged one is built once per checkout.  nvcc's report of each
kernel's registers, shared memory and spills (``-Xptxas -v``) is kept
beside the library (:func:`ptxas_report`).  Nothing is compiled or loaded
at import time: the first launch builds.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
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
    # registers, shared memory and spills of every kernel, kept in the log
    "-Xptxas", "-v",
)

# one lock per library, so that different kernels build concurrently
_locks_lock = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0 when it was
# already on disk), by name; read by chip_smoke.py
BUILD_SECONDS: dict[str, float] = {}
# path of each loaded library's nvcc report, by name
LOG_PATHS: dict[str, str] = {}


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


def build_key(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, every header ``csrc/*.cuh`` (the kernels
    share device code through them) and the flags: the library's name, so
    that a change to any of them rebuilds it."""
    h = hashlib.sha256()
    paths = [os.path.join(CSRC_DIR, f"{name}.cu")] + sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in paths:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(repr(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; returns the CDLL.
    Thread-safe; calls for different libraries build in parallel."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        stem = os.path.join(BUILD_DIR, f"lib{name}-{build_key(name)}")
        lib_path, log_path = stem + ".so", stem + ".ptxas.txt"
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
                with open(log_path, "w") as f:
                    f.write(proc.stdout + proc.stderr)
                os.replace(tmp, lib_path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            BUILD_SECONDS[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(lib_path)
        _loaded[name] = lib
        LOG_PATHS[name] = log_path
        return lib


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SPILLS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                     r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
# the main kernels' mangled template arguments: <T, ORDER, METHOD or KIND>
# and, since the lag tiles, LT
_KERNEL = re.compile(r"((?:quad|warp)_score_kernel)I([fd])Li(\d+)ELi(\d+)E"
                     r"(?:Li(\d+)E)?E")


def parse_ptxas(text: str) -> list[dict]:
    """Registers, shared memory and spills of each main kernel in nvcc's
    ``-Xptxas -v`` report: a list of ``{"kernel", "dtype", "order",
    "variant", "lag_tile", "registers", "smem", "stack", "spill_stores",
    "spill_loads"}`` (``variant``: the method or WCS kind; ``lag_tile``
    None for a kernel without lag tiles)."""
    out, cur = [], None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            k = _KERNEL.search(m.group(1))
            cur = None if k is None else {
                "kernel": k.group(1),
                "dtype": {"f": "float32", "d": "float64"}[k.group(2)],
                "order": int(k.group(3)), "variant": int(k.group(4)),
                "lag_tile": None if k.group(5) is None else int(k.group(5))}
            continue
        if cur is None:
            continue
        m = _SPILLS.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = _USED.search(line)
        if m:
            smem = _SMEM.search(line)
            cur.update(registers=int(m.group(1)),
                       smem=int(smem.group(1)) if smem else 0)
            out.append(cur)
            cur = None
    return out


def ptxas_report(name: str) -> list[dict]:
    """:func:`parse_ptxas` of a loaded library's nvcc report."""
    with open(LOG_PATHS[name]) as f:
        return parse_ptxas(f.read())
