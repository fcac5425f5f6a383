#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (an H100 is
the target).  It drives the port's main path, ``Alignment`` from
``euispice_coreg_tpu_torch``, once at the size of the repo's headline case
(a 2048^2 HRIEUV-like pair), and checks every hand-written kernel on that
path against its plain PyTorch version.  It imports nothing of JAX.
Phases (each prints its own lines; any failure exits nonzero):

1. device   -- requires torch.cuda.is_available(); prints the card's name
               and power limit (nvidia-smi), torch and CUDA versions.
2. build    -- builds K1 (csrc/warp_score.cu) with nvcc for sm_90a into
               euispice_coreg_tpu_torch/build/ and prints the seconds.
3. kernels  -- K1 against its plain version on the card: 512^2 and 2048^2,
               TAN and CAR, orders 0/1/2, lags with crota and cdelt parts,
               NaN holes.  Six sums within 1e-5 of each sum's largest
               magnitude over the lags, r within 1e-5, argmax equal.  Then
               both timed at the slice-B lag grid (21x21x3 = 1323 lags).
4. slice A  -- public API, lag_search_mode="auto", 121x121 CRVAL grid
               (0.5"): must take the FFT fast path and recover the injected
               +8" within 1"; rerun in float64 and compare.
5. slice B  -- public API, lag_search_mode="pallas", 21x21 CRVAL (1") x 3
               crota: must launch K1 and recover +8" within 1.5" on the
               crota=0 plane; AlignmentResults + write_corrected_fits, read
               back, corrected CRVAL1 checked.
6. summary  -- the kernels line (JSON), then {"ok": true, "device": ...}
               as the last line.
"""
from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N = 2048                      # headline pair size (HRIEUV-like)
TRUE_SHIFT = 8.0              # arcsec injected into CRVAL1
CDELT_ARCSEC = 0.492          # HRIEUV pixel
TOL = 1e-5                    # kernel vs plain: sums (normalised) and r
DEVICE = "cuda"


def log(msg):
    print(msg, flush=True)


def scene(u, v):
    """Smooth deterministic 'sun': Gaussian blobs over (u, v) in degrees."""
    import numpy as np

    out = np.full(u.shape, 100.0)
    rng = np.random.default_rng(7)
    for _ in range(40):
        cx, cy = rng.uniform(-0.1, 0.1, size=2)
        w = rng.uniform(0.004, 0.02)
        a = rng.uniform(0.5, 3.0)
        out += a * np.exp(-(((u - cx) ** 2) + ((v - cy) ** 2)) / (2 * w * w))
    return out


def cuda_ms(fn, repeat=3):
    """Mean milliseconds of ``fn`` on the card over ``repeat`` runs (CUDA
    events, after one warm-up run)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeat):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeat


class EngineLog(logging.Handler):
    """Collects the port's log lines (the engine logs which path ran)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    # float32 matmuls stay full precision (nothing here uses TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from euispice_coreg_tpu_torch.engine import _build

    t0 = time.perf_counter()
    _build.load("warp_score")
    log(f"[build] K1 csrc/warp_score.cu: nvcc "
        f"{_build.BUILD_SECONDS['warp_score']:.2f} s (load total "
        f"{time.perf_counter() - t0:.2f} s) into "
        f"{os.path.relpath(_build.BUILD_DIR, REPO)}/")
    return _build.BUILD_SECONDS["warp_score"]


# ---------------------------------------------------------------------------
# phase 3: K1 against its plain version
# ---------------------------------------------------------------------------

def kernel_operands(n, kind, device, seed):
    """Centred canvas/ref and lon/lat grids of an n x n case with NaN holes,
    plus the base WCS (degrees)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from euispice_coreg_tpu_torch.core import wcs
    from euispice_coreg_tpu_torch.core.header import pc_from_crota
    from euispice_coreg_tpu_torch.engine import warp_score
    from euispice_coreg_tpu_torch.utils import coords

    rng = np.random.default_rng(seed)
    x, y = coords.pixel_grid(n, n)
    if kind == "tan":
        cdelt = CDELT_ARCSEC * (N / n) / 3600.0
        crota = 0.75
        crval = (120.0 / 3600.0, 80.0 / 3600.0)
    else:
        cdelt = 0.3 * (N / n) / n  # ~0.3 deg across: a Carrington patch
        crota = 0.4
        crval = (120.0, 0.0)
    pc = pc_from_crota(crota, cdelt, cdelt)
    base = {"crval1": crval[0], "crval2": crval[1],
            "crpix1": (n + 1) / 2, "crpix2": (n + 1) / 2,
            "cdelt1": cdelt, "cdelt2": cdelt,
            "pc11": pc[0], "pc12": pc[1], "pc21": pc[2], "pc22": pc[3],
            "crota": crota}
    lon, lat = wcs.pixel_to_world(base, x, y, kind=kind, xp=np)
    u, v = (lon, lat) if kind == "tan" else (lon - crval[0], lat)
    shift = 3.0 * cdelt
    small = scene(u + shift, v) + rng.normal(0.0, 0.01, u.shape)
    ref = scene(u, v)
    for img in (small, ref):
        for _ in range(4):
            r0, c0 = rng.integers(0, n - n // 16, size=2)
            img[r0:r0 + n // 32, c0:c0 + n // 16] = np.nan

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    small_t = t(small)
    ref_t = t(ref)
    ref_c = (ref_t - torch.nanmean(ref_t.double()).float()).contiguous()
    small_c = small_t - torch.nanmean(small_t.double()).float()
    canvas = F.pad(small_c[None, None], (warp_score.PAD,) * 4,
                   mode="reflect")[0, 0].contiguous()
    return canvas, ref_c, t(lon), t(lat), base, cdelt


def check_lags(cdelt):
    """(L, 5) lags in degrees: crval, crota and cdelt parts, and a shift of
    tens of pixels."""
    import numpy as np

    c = cdelt
    return np.array([
        [0.0, 0.0, 0.0, 0.0, 0.0],
        [3.0 * c, 0.0, 0.0, 0.0, 0.0],
        [2.6 * c, -1.3 * c, 0.0, 0.0, 0.0],
        [3.0 * c, 0.5 * c, 0.0, 0.0, 0.05],
        [0.0, 0.0, 0.0, 0.0, -0.3],
        [1.0 * c, 0.0, 0.002 * c, 0.0, 0.0],
        [0.0, -2.0 * c, 0.0, -0.003 * c, 0.02],
        [-40.0 * c, 25.0 * c, 0.0, 0.0, 0.0],
    ])


def slice_b_lags():
    import numpy as np

    step = 1.0 / 3600.0
    l12 = (np.arange(21) - 10) * step
    g = np.meshgrid(l12, l12, [0.0], [0.0], [-0.05, 0.0, 0.05], indexing="ij")
    return np.stack([a.ravel() for a in g], axis=-1)


def phase_kernels(device):
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch.engine import warp_score

    max_err = 0.0
    for n in (512, N):
        for kind in ("tan", "car"):
            canvas, ref, lon, lat, base, cdelt = kernel_operands(
                n, kind, device, seed=n + len(kind))
            lags = check_lags(cdelt)
            table = torch.as_tensor(warp_score.lag_table(base, lags),
                                    dtype=torch.float32, device=device)
            for order in (0, 1, 2):
                kw = dict(pad=warp_score.PAD, order=order, kind=kind)
                got = warp_score.warp_score_sums(canvas, ref, lon, lat,
                                                 table, **kw)
                want = warp_score.warp_score_sums_reference(
                    canvas, ref, lon, lat, table, **kw)
                torch.cuda.synchronize()
                got, want = got.cpu().numpy(), want.cpu().numpy()
                scale = np.max(np.abs(want), axis=0)
                sum_err = float(np.max(np.abs(got - want) / scale))
                r_got = warp_score.pearson_from_sums(got)
                r_want = warp_score.pearson_from_sums(want)
                r_err = float(np.max(np.abs(r_got - r_want)))
                same_arg = int(np.nanargmax(r_got)) == int(np.nanargmax(r_want))
                log(f"[kernels] K1 {n}^2 {kind} order {order}: sums "
                    f"{sum_err:.2e} (tol {TOL:g} of each sum's max), |dr| "
                    f"{r_err:.2e} (tol {TOL:g}), argmax equal {same_arg}, "
                    f"n {int(want[0, 0])}..{int(want[-1, 0])}")
                if not (sum_err <= TOL and r_err <= TOL and same_arg):
                    raise AssertionError(
                        f"K1 disagrees with its plain version ({n}^2 {kind} "
                        f"order {order})")
                max_err = max(max_err, r_err)

    # timing at the slice shape: the slice-B grid (1323 lags), order 2
    times = {}
    lags = slice_b_lags()
    for n in (512, N):
        canvas, ref, lon, lat, base, _ = kernel_operands(n, "tan", device,
                                                         seed=1)
        table = torch.as_tensor(warp_score.lag_table(base, lags),
                                dtype=torch.float32, device=device)
        kw = dict(pad=warp_score.PAD, order=2, kind="tan")
        k_ms = cuda_ms(lambda: warp_score.warp_score_sums(
            canvas, ref, lon, lat, table, **kw))
        p_ms = cuda_ms(lambda: warp_score.warp_score_sums_reference(
            canvas, ref, lon, lat, table, **kw), repeat=1)
        got = warp_score.pearson_from_sums(
            warp_score.warp_score_sums(canvas, ref, lon, lat, table,
                                       **kw).cpu().numpy())
        want = warp_score.pearson_from_sums(
            warp_score.warp_score_sums_reference(
                canvas, ref, lon, lat, table, **kw).cpu().numpy())
        err = float(np.max(np.abs(got - want)))
        if not (err <= TOL and np.nanargmax(got) == np.nanargmax(want)):
            raise AssertionError(f"K1 timing run disagrees ({n}^2): {err}")
        max_err = max(max_err, err)
        times[n] = (k_ms, p_ms)
        log(f"[kernels] K1 {n}^2 x {len(lags)} lags, order 2, TAN: kernel "
            f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, |dr| {err:.2e}")
    return max_err, times


# ---------------------------------------------------------------------------
# phases 4-5: the public API
# ---------------------------------------------------------------------------

def write_pair(tmp_dir):
    """The headline pair: the small image rendered through its true
    pointing, handed over with CRVAL1 mispointed by -8"; the reference is
    the scene on the small header's own grid (correct under that WCS)."""
    import numpy as np

    from euispice_coreg_tpu_torch.core import wcs
    from euispice_coreg_tpu_torch.core.header import Header, pc_from_crota
    from euispice_coreg_tpu_torch.io import fits
    from euispice_coreg_tpu_torch.utils import coords

    cdelt = CDELT_ARCSEC / 3600.0
    pc = pc_from_crota(0.75, cdelt, cdelt)
    base = {"crval1": 120.0 / 3600.0, "crval2": 80.0 / 3600.0,
            "crpix1": (N + 1) / 2, "crpix2": (N + 1) / 2,
            "cdelt1": cdelt, "cdelt2": cdelt,
            "pc11": pc[0], "pc12": pc[1], "pc21": pc[2], "pc22": pc[3]}
    x, y = coords.pixel_grid(N, N)
    lon_t, lat_t = wcs.tan_pixel_to_world(base, x, y, xp=np)
    small = scene(lon_t, lat_t)
    given = dict(base, crval1=base["crval1"] - TRUE_SHIFT / 3600.0)
    lon, lat = wcs.tan_pixel_to_world(given, x, y, xp=np)
    ref = scene(lon, lat)

    hdr = Header({
        "NAXIS1": N, "NAXIS2": N,
        "CRVAL1": given["crval1"] * 3600.0, "CRVAL2": given["crval2"] * 3600.0,
        "CRPIX1": given["crpix1"], "CRPIX2": given["crpix2"],
        "CDELT1": CDELT_ARCSEC, "CDELT2": CDELT_ARCSEC,
        "CUNIT1": "arcsec", "CUNIT2": "arcsec",
        "CTYPE1": "HPLN-TAN", "CTYPE2": "HPLT-TAN", "CROTA": 0.75,
        "PC1_1": pc[0], "PC1_2": pc[1], "PC2_1": pc[2], "PC2_2": pc[3],
    })
    p_large = os.path.join(tmp_dir, "large.fits")
    p_small = os.path.join(tmp_dir, "small.fits")
    fits.write(p_large, [fits.PrimaryHDU(data=ref.astype(np.float32),
                                         header=hdr)])
    fits.write(p_small, [fits.PrimaryHDU(data=small.astype(np.float32),
                                         header=hdr)])
    return p_large, p_small, hdr


def top2_margin(corr):
    import numpy as np

    v = np.sort(corr[np.isfinite(corr)].ravel())
    return float(v[-1] - v[-2])


def phase_slice_a(p_large, p_small, engine_log):
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch import Alignment

    lag = (np.arange(121) - 60) * 0.5

    def run(dtype, return_type="AlignmentResults"):
        A = Alignment(p_large, p_small, lag_crval1=lag, lag_crval2=lag,
                      small_fov_window=0, large_fov_window=0,
                      compute_dtype=dtype, device=DEVICE)
        out = A.align_using_helioprojective(return_type=return_type)
        torch.cuda.synchronize()
        return out

    engine_log.lines.clear()
    t0 = time.perf_counter()
    res = run("float32")
    t_api = time.perf_counter() - t0
    if "engine path: FFT fast (crval grid)" not in engine_log.lines:
        raise AssertionError(f"slice A did not take the FFT fast path: "
                             f"{engine_log.lines}")
    mi = res.max_index
    if abs(lag[mi[0]] - TRUE_SHIFT) >= 1.0 or abs(res.shift_arcsec[0] - TRUE_SHIFT) >= 1.0:
        raise AssertionError(f"slice A missed +8\": argmax {lag[mi[0]]}, "
                             f"fit {res.shift_arcsec}")
    log(f"[slice A] {N}^2, 121x121 CRVAL grid, FFT fast path: argmax "
        f"{lag[mi[0]]:+.1f}\" / {lag[mi[1]]:+.1f}\", fit "
        f"{res.shift_arcsec[0]:+.3f}\" / {res.shift_arcsec[1]:+.3f}\", "
        f"first API call {t_api:.3f} s")
    return res.corr


def time_fast_path(p_large, p_small):
    """Warm wall time of the public API call and of the engine call alone
    (host clock around work ending in a synchronize), best of 3."""
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch import Alignment
    from euispice_coreg_tpu_torch.engine import lag_search

    lag = (np.arange(121) - 60) * 0.5
    A = Alignment(p_large, p_small, lag_crval1=lag, lag_crval2=lag,
                  small_fov_window=0, large_fov_window=0, device=DEVICE)

    def api():
        B = Alignment(p_large, p_small, lag_crval1=lag, lag_crval2=lag,
                      small_fov_window=0, large_fov_window=0, device=DEVICE)
        B.align_using_helioprojective(return_type="corr")

    A._load_pair()
    lon, lat, ref, base, kind = A._prepare_projected_operands(wrap=True)
    small = A._to_device(A.data_small)
    l1, l2, l3, l4, l5 = A._lags_deg()

    def engine():
        lag_search.evaluate_lag_grid(small, ref, lon, lat, base,
                                     l1, l2, l3, l4, l5, order=2, kind=kind,
                                     device=DEVICE, allow_fast=True)

    def best_of_3(fn):
        best = None
        for _ in range(4):  # first run warms
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return best

    out = {"engine": best_of_3(engine), "api": best_of_3(api)}
    log(f"[slice A] FFT path {N}^2 x 121x121 warm, best of 3: engine "
        f"{out['engine'] * 1e3:.1f} ms, full API (FITS load + submap + "
        f"search + fit) {out['api'] * 1e3:.1f} ms")
    log_stages("slice A", api)
    return out


def log_stages(label, fn):
    """One more warm run with the port's stage clocks on (host wall time;
    device work that no stage waits for lands in the next one that
    synchronises)."""
    import torch

    from euispice_coreg_tpu_torch.utils import obs

    with obs.collect_stages() as st:
        fn()
        torch.cuda.synchronize()
    log(f"[{label}] stages (ms): " + ", ".join(
        f"{k} {v * 1e3:.1f}" for k, v in st.items()))


def phase_precision(p_large, p_small, corr_default):
    """float32 vs float64 on the FFT path: the default run (float32
    operands, float64 surfaces) against an all-float64 run."""
    import numpy as np

    from euispice_coreg_tpu_torch import Alignment

    lag = (np.arange(121) - 60) * 0.5

    def run(dtype):
        A = Alignment(p_large, p_small, lag_crval1=lag, lag_crval2=lag,
                      small_fov_window=0, large_fov_window=0,
                      compute_dtype=dtype, device=DEVICE)
        return A.align_using_helioprojective(return_type="corr")

    corr64 = run("float64")
    same = (np.unravel_index(np.nanargmax(corr_default), corr_default.shape)
            == np.unravel_index(np.nanargmax(corr64), corr64.shape))
    log(f"[slice A] default (f32 operands, f64 surfaces) vs all-float64: "
        f"argmax equal {same}, max |dr| "
        f"{float(np.nanmax(np.abs(corr_default - corr64))):.3e}, top-2 margin "
        f"{top2_margin(corr_default):.6e} (float64 {top2_margin(corr64):.6e})")
    if not same:
        raise AssertionError("the default FFT path moves the argmax")


def phase_slice_b(p_large, p_small, hdr, tmp_dir):
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch import Alignment
    from euispice_coreg_tpu_torch.engine import warp_score
    from euispice_coreg_tpu_torch.io import fits

    lag = (np.arange(21) - 10) * 1.0

    def make():
        return Alignment(p_large, p_small, lag_crval1=lag, lag_crval2=lag,
                         lag_crota=[-0.05, 0.0, 0.05], small_fov_window=0,
                         large_fov_window=0, lag_search_mode="pallas",
                         device=DEVICE)

    before = warp_score.LAUNCHES
    t0 = time.perf_counter()
    res = make().align_using_helioprojective()
    torch.cuda.synchronize()
    t_api = time.perf_counter() - t0
    launched = warp_score.LAUNCHES - before
    if launched <= 0:
        raise AssertionError("slice B did not launch K1")
    plane = res.corr[:, :, 0, 0, 1, 0]
    mi = np.unravel_index(np.nanargmax(plane), plane.shape)
    if abs(lag[mi[0]] - TRUE_SHIFT) >= 1.5:
        raise AssertionError(f"slice B missed +8\": {lag[mi[0]]}")

    out_path = os.path.join(tmp_dir, "small_corrected.fits")
    res.write_corrected_fits([0], out_path)
    back = fits.open(out_path)[0].header
    want = hdr["CRVAL1"] + res.shift_arcsec[0]
    true_crval1 = hdr["CRVAL1"] + TRUE_SHIFT
    if not (abs(back["CRVAL1"] - want) < 1e-9
            and abs(back["CRVAL1"] - true_crval1) < 1.5):
        raise AssertionError(f"corrected CRVAL1 {back['CRVAL1']} (expected "
                             f"{want}, true {true_crval1})")
    log(f"[slice B] {N}^2, 21x21x3 grid, K1: {launched} launch(es), "
        f"crota=0 argmax {lag[mi[0]]:+.1f}\" / {lag[mi[1]]:+.1f}\", fit "
        f"{res.shift_arcsec[0]:+.3f}\", API call {t_api:.3f} s; corrected "
        f"CRVAL1 {back['CRVAL1']:.4f}\" (true {true_crval1:.4f}\")")
    log_stages("slice B", lambda: make().align_using_helioprojective(
        return_type="corr"))
    return launched


def main():
    card = phase_device()
    sys.path.insert(0, REPO)
    import torch

    from euispice_coreg_tpu_torch.engine import warp_score

    engine_log = EngineLog()
    port_logger = logging.getLogger("euispice_coreg_tpu_torch")
    port_logger.addHandler(engine_log)
    port_logger.setLevel(logging.INFO)

    build_s = phase_build()
    max_err, times = phase_kernels(torch.device(DEVICE))

    with tempfile.TemporaryDirectory() as tmp_dir:
        p_large, p_small, hdr = write_pair(tmp_dir)
        # the main path: every launch count starts at 0 here
        warp_score.LAUNCHES = 0
        corr32 = phase_slice_a(p_large, p_small, engine_log)
        launches = phase_slice_b(p_large, p_small, hdr, tmp_dir)
        main_launches = warp_score.LAUNCHES
        if main_launches <= 0 or launches <= 0:
            raise AssertionError("K1 was not launched on the main path")
        phase_precision(p_large, p_small, corr32)
        time_fast_path(p_large, p_small)

    k_ms, p_ms = times[N]
    log(f"[summary] card {card}; K1 build {build_s:.2f} s")
    print(json.dumps({"kernels": [{
        "name": "warp_score (K1)",
        "route": "cuda",
        "source": "euispice_coreg_tpu_torch/csrc/warp_score.cu",
        "replaces": "euispice_coreg_tpu/engine/pallas_warp.py:40",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
