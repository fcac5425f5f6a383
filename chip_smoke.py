#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (an H100 is
the target).  It drives the port's paths, ``Alignment`` from
``euispice_coreg_tpu_torch``, at the size of the repo's headline cases
(2048^2 pairs), and checks every hand-written kernel on those paths against
its plain PyTorch version.  It imports nothing of JAX.
Phases (each prints its own lines; any failure exits nonzero):

1. device   -- requires torch.cuda.is_available(); prints the card's name
               and power limit (nvidia-smi), torch and CUDA versions.
2. build    -- builds K1 (csrc/warp_score.cu) and K2 (csrc/quad_score.cu)
               with nvcc for sm_90a, in parallel, into
               euispice_coreg_tpu_torch/build/ and prints the seconds.
3. kernels  -- K1 against its plain version on the card: 512^2 and 2048^2,
               TAN and CAR, orders 0/1/2, lags with crota and cdelt parts,
               NaN holes.  Six sums within 1e-5 of each sum's largest
               magnitude over the lags, r within 1e-5, argmax equal.  Then
               both timed at the slice-B lag grid (21x21x3 = 1323 lags).
               K2 likewise: 512^2 and 2048^2, orders 0/1/2, correlation and
               residus_masked, shifts of +-140 px, affine and quadratic
               fields, a within-tile spread beyond the TPU kernel's bound,
               NaN holes; same tolerances (r or residue std within 1e-5).
               Then K2 and its plain version timed on one 21x21 = 441-lag
               set at 2048^2, and K2 alone at 121x121 = 14641 lags.
4. slice A  -- public API, lag_search_mode="auto", 121x121 CRVAL grid
               (0.5"): must take the FFT fast path and recover the injected
               +8" within 1"; rerun in float64 and compare.
5. slice B  -- public API, lag_search_mode="pallas", 21x21 CRVAL (1") x 3
               crota: must launch K1 and recover +8" within 1.5" on the
               crota=0 plane; AlignmentResults + write_corrected_fits, read
               back, corrected CRVAL1 checked.
6. slice C  -- public API align_using_carrington, "fa", on a 2048^2 pair
               (small 2"/px, CROTA 0.3, CRVAL1 mispointed by -8"; reference
               2.4"/px) over a 2048^2 Carrington grid, 121x121 CRVAL grid
               (0.5"): lag_search_mode="pallas" must launch K2 and recover
               +8" within 1" (argmax and fit), and the corrected CRVAL1
               must read back; "auto" must take the block FFT or the K2
               select path and recover the same.  Then the coarse grid at
               the engine level (121x121 at 2", +24" injected, "auto"): K2,
               +24" within 3".  Then the "sunpy" branch (121x121 0.5",
               "auto"): +8" within 1".
7. slice D  -- public API, "auto", 21x21 CRVAL (1") x 3 CDELT1 x 3 CDELT2
               (0.5 % of the pixel) x 3 CROTA = 11907 candidates on A's
               pair: must take the block path (27 combos) and recover +8"
               within 1.5"; the same grid under "pallas" (K1) must give
               the same CRVAL argmax on the central plane; 5 x 5 x 3 = 75
               combos must take the block path and recover the same.
8. slice E  -- align_movie_to_reference on 6 frames of A's scene (pointing
               errors within +-4", default 21x21 lags at 0.5"): every
               frame within 1"; jitter_correction_imagers
               (helioprojective, default 100x100 lags at 0.1", sublists of
               4 + 1) on the same frames: every corrected CRVAL within 1"
               of the anchor's; one Carrington jitter run (3 frames of C's
               scene, 1024^2 grid, 41x41 lags at 0.5", the default
               "carrington" mode), printing which engine path ran.
9. slice F  -- AlignmentPixels: a 3072^2 FSI-like frame at 4.44" and a
               1024^2 crop offset by (+7, -5) px, dx/dy in [-16, 16], drot
               in {-1, 0, +1} deg: argmax (7, -5, 0), r = 1 within 1e-6,
               pearson_integer_shifts against a direct float64 window
               Pearson at 3 offsets within 1e-6.
10. summary -- the kernels line (JSON, K1 and K2), then
               {"ok": true, "device": ...} as the last line.
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
    """Both kernels built at once (one nvcc each, started together)."""
    from concurrent.futures import ThreadPoolExecutor

    from euispice_coreg_tpu_torch.engine import _build

    names = {"warp_score": "K1", "quad_score": "K2"}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.load, names))
    total = time.perf_counter() - t0
    for name, kid in names.items():
        log(f"[build] {kid} csrc/{name}.cu: nvcc "
            f"{_build.BUILD_SECONDS[name]:.2f} s")
    log(f"[build] both loaded in {total:.2f} s (parallel) into "
        f"{os.path.relpath(_build.BUILD_DIR, REPO)}/")
    return {k: _build.BUILD_SECONDS[k] for k in names}


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


# ---------------------------------------------------------------------------
# phase 3b: K2 against its plain version
# ---------------------------------------------------------------------------

def k2_operands(n, device, seed):
    """Pre-warped image and reference of an n x n case (smooth, positive,
    NaN holes): the reference is the image moved by (dx, dy) = (5, -3)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n] * (512.0 / n)
    warped = (100.0 + np.sin(xx / 9.0) * np.cos(yy / 13.0)
              + 0.1 * rng.standard_normal((n, n)))
    ref = np.roll(warped, (3, -5), axis=(0, 1)) \
        + 0.05 * rng.standard_normal((n, n))
    for img in (warped, ref):
        for _ in range(4):
            r0, c0 = rng.integers(0, n - n // 8, size=2)
            img[r0:r0 + n // 32, c0:c0 + n // 16] = np.nan

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return t(warped), t(ref)


def k2_check_coeffs():
    """(8, 6, 2) lags after tests/test_pallas_quad.py: shifts of +-140 px,
    affine + quadratic fields, a cross term, a within-tile spread (0.1 px
    per px: 12.8 px over a 128-px tile) beyond the TPU kernel's max_m=6,
    and the true shift."""
    import numpy as np

    c = np.zeros((8, 6, 2))
    c[1, 2] = (37.3, -140.4)
    c[2, 2] = (-139.6, 8.2)
    c[3, 2] = (5.3, -2.1)
    c[3, 0, 0] = 4e-3
    c[3, 1, 1] = -6e-3
    c[3, 3, 0] = 3e-6
    c[3, 4, 1] = -4e-6
    c[4, 5] = (2e-6, -1.5e-6)
    c[5, 0, 0] = 0.1
    c[6, 2] = (5.0, -3.0)
    c[7, 2] = (5.4, -2.6)
    c[7, 4, 1] = 5e-6
    return c


def k2_grid_coeffs(n_side, step):
    """n_side^2 lags: shifts on a grid around the true (5, -3) with a small
    affine and quadratic part, like a Carrington select fit."""
    import numpy as np

    off = (np.arange(n_side) - n_side // 2) * step
    g1, g2 = np.meshgrid(off, off, indexing="ij")
    c = np.zeros((n_side * n_side, 6, 2))
    c[:, 2, 0] = 5.0 + g1.ravel()
    c[:, 2, 1] = -3.0 + g2.ravel()
    c[:, 0, 0] = 1e-4 * g1.ravel()
    c[:, 1, 1] = -1e-4 * g2.ravel()
    c[:, 3, 1] = 1e-7
    return c


def phase_k2_kernels(device):
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch.engine import quad_score, warp_score

    finish = {"correlation": warp_score.pearson_from_sums,
              "residus_masked": quad_score.residus_from_sums}
    max_err = 0.0
    for n in (512, N):
        warped, ref = k2_operands(n, device, seed=n)
        table = torch.as_tensor(quad_score.coeff_table(k2_check_coeffs()),
                                dtype=torch.float32, device=device)
        for method in ("correlation", "residus_masked"):
            canvas, ref_c = quad_score.quad_canvases(warped, ref,
                                                     method=method)
            for order in (0, 1, 2):
                kw = dict(pad=quad_score.PAD, order=order, method=method)
                got = quad_score.quad_score_sums(canvas, ref_c, table, **kw)
                want = quad_score.quad_score_sums_reference(
                    canvas, ref_c, table, **kw)
                torch.cuda.synchronize()
                got, want = got.cpu().numpy(), want.cpu().numpy()
                scale = np.max(np.abs(want), axis=0)
                sum_err = float(np.max(np.abs(got - want) / scale))
                s_got, s_want = finish[method](got), finish[method](want)
                s_err = float(np.max(np.abs(s_got - s_want)))
                pick = np.nanargmax if method == "correlation" else np.nanargmin
                same_arg = int(pick(s_got)) == int(pick(s_want))
                log(f"[kernels] K2 {n}^2 {method} order {order}: sums "
                    f"{sum_err:.2e} (tol {TOL:g} of each sum's max), |dscore| "
                    f"{s_err:.2e} (tol {TOL:g}), best lag equal {same_arg} "
                    f"({int(pick(s_want))}), n {int(want[0, 0])}..."
                    f"{int(want[5, 0])}")
                if not (sum_err <= TOL and s_err <= TOL and same_arg
                        and np.all(want[:, 0] > 0)):
                    raise AssertionError(
                        f"K2 disagrees with its plain version ({n}^2 "
                        f"{method} order {order})")
                max_err = max(max_err, s_err)

    # timing at 2048^2, order 2: one shared 441-lag set, then K2 at 14641
    warped, ref = k2_operands(N, device, seed=5)
    canvas, ref_c = quad_score.quad_canvases(warped, ref,
                                             method="correlation")
    kw = dict(pad=quad_score.PAD, order=2, method="correlation")
    table = torch.as_tensor(quad_score.coeff_table(k2_grid_coeffs(21, 1.0)),
                            dtype=torch.float32, device=device)
    k_ms = cuda_ms(lambda: quad_score.quad_score_sums(canvas, ref_c, table,
                                                      **kw))
    p_ms = cuda_ms(lambda: quad_score.quad_score_sums_reference(
        canvas, ref_c, table, **kw), repeat=1)
    got = warp_score.pearson_from_sums(quad_score.quad_score_sums(
        canvas, ref_c, table, **kw).cpu().numpy())
    want = warp_score.pearson_from_sums(quad_score.quad_score_sums_reference(
        canvas, ref_c, table, **kw).cpu().numpy())
    err = float(np.max(np.abs(got - want)))
    if not (err <= TOL and np.nanargmax(got) == np.nanargmax(want)):
        raise AssertionError(f"K2 timing run disagrees: {err}")
    max_err = max(max_err, err)
    log(f"[kernels] K2 {N}^2 x {table.shape[0]} lags, order 2, correlation: "
        f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, |dr| {err:.2e}")
    table = torch.as_tensor(quad_score.coeff_table(k2_grid_coeffs(121, 0.5)),
                            dtype=torch.float32, device=device)
    big_ms = cuda_ms(lambda: quad_score.quad_score_sums(canvas, ref_c, table,
                                                        **kw), repeat=2)
    log(f"[kernels] K2 {N}^2 x {table.shape[0]} lags, order 2, correlation: "
        f"kernel {big_ms:.3f} ms "
        f"({N * N * table.shape[0] / (big_ms * 1e-3):.3e} pixel-lags/s)")
    return max_err, (k_ms, p_ms, big_ms)


# ---------------------------------------------------------------------------
# phase 6: slice C, the Carrington path (align_using_carrington)
# ---------------------------------------------------------------------------

CARR_DATE = "2022-03-17T09:50:45"
CARR_GRID = dict(lonlims=(117.0, 123.0), latlims=(-1.0, 7.0), shape=(N, N))
CARR_LAGS = 121      # CRVAL lags per axis (bench.py GRID)
CARR_STEP = 0.5      # arcsec, slice C and the sunpy branch
CARR_N = 1024        # Carrington grid of slice E's jitter run
COARSE_STEP = 2.0    # arcsec, the coarse run


def carr_scene(lon_c, lat_c):
    """Deterministic smooth blob field on the Carrington sphere."""
    import numpy as np

    out = np.full(lon_c.shape, 100.0)
    rng = np.random.default_rng(11)
    for _ in range(30):
        cx = rng.uniform(116, 124)
        cy = rng.uniform(-3, 7)
        w = rng.uniform(0.3, 1.5)
        out += rng.uniform(0.5, 3) * np.exp(
            -(((lon_c - cx) ** 2) + ((lat_c - cy) ** 2)) / (2 * w * w))
    return out


def carr_header(cdelt, crval1, crval2, crota=0.3):
    """A 2048^2 helioprojective header at 0.5 au looking at Carrington
    (120, 3) deg; CRVAL/CDELT in arcsec."""
    from euispice_coreg_tpu_torch.core.header import Header, pc_from_crota

    cdelt = cdelt * 2048 / N  # the same field of view at any N
    pc = pc_from_crota(crota, cdelt, cdelt)
    return Header({
        "NAXIS1": N, "NAXIS2": N, "CRVAL1": crval1, "CRVAL2": crval2,
        "CRPIX1": (N + 1) / 2, "CRPIX2": (N + 1) / 2,
        "CDELT1": cdelt, "CDELT2": cdelt, "CUNIT1": "arcsec",
        "CUNIT2": "arcsec", "CROTA": crota, "PC1_1": pc[0], "PC1_2": pc[1],
        "PC2_1": pc[2], "PC2_2": pc[3], "DSUN_OBS": 0.5 * 1.496e11,
        "CRLN_OBS": 120.0, "CRLT_OBS": 3.0, "DATE-OBS": CARR_DATE,
        "WAVELNTH": 174,
    })


def carr_render(hdr, d_solar_r=1.004):
    """The Carrington scene as seen through a helioprojective header."""
    import numpy as np

    from euispice_coreg_tpu_torch.engine import carrington as carr

    sc = carr.header_spherical_scalars(hdr, d_solar_r)
    px, py = np.meshgrid(np.arange(N, dtype=np.float64),
                         np.arange(N, dtype=np.float64))
    lon_c, lat_c = carr.spherical_unproject(px, py, sc)
    return np.where(np.isfinite(lon_c),
                    carr_scene(np.nan_to_num(lon_c), np.nan_to_num(lat_c)),
                    np.nan)


def write_carr_pair(tmp_dir):
    """The small image rendered through its true pointing and handed over
    with CRVAL1 mispointed by -8"; the reference a second vantage of the
    scene (2.4"/px, no roll) with correct pointing."""
    import numpy as np

    from euispice_coreg_tpu_torch.io import fits

    small = carr_render(carr_header(2.0, 150.0, 100.0))
    hdr_given = carr_header(2.0, 150.0 - TRUE_SHIFT, 100.0)
    hdr_large = carr_header(2.4, 148.0, 98.0, crota=0.0)
    large = carr_render(hdr_large)
    p_large = os.path.join(tmp_dir, "carr_large.fits")
    p_small = os.path.join(tmp_dir, "carr_small.fits")
    fits.write(p_large, [fits.PrimaryHDU(data=large.astype(np.float32),
                                         header=hdr_large)])
    fits.write(p_small, [fits.PrimaryHDU(data=small.astype(np.float32),
                                         header=hdr_given)])
    return p_large, p_small, hdr_given


def carr_alignment(p_large, p_small, mode):
    import numpy as np

    from euispice_coreg_tpu_torch import Alignment

    lag = (np.arange(CARR_LAGS) - CARR_LAGS // 2) * CARR_STEP
    return lag, Alignment(p_large, p_small, lag_crval1=lag, lag_crval2=lag,
                          small_fov_window=0, large_fov_window=0,
                          lag_search_mode=mode, device=DEVICE)


def check_recovery(label, lag, res, want, tol):
    import numpy as np

    plane = res.corr[:, :, 0, 0, 0, 0]
    mi = np.unravel_index(np.nanargmax(plane), plane.shape)
    if abs(lag[mi[0]] - want) >= tol or abs(res.shift_arcsec[0] - want) >= tol:
        raise AssertionError(f"{label} missed {want:+.0f}\": argmax "
                             f"{lag[mi[0]]}, fit {res.shift_arcsec}")
    return (f"argmax {lag[mi[0]]:+.1f}\" / {lag[mi[1]]:+.1f}\", fit "
            f"{res.shift_arcsec[0]:+.3f}\" / {res.shift_arcsec[1]:+.3f}\"")


def phase_slice_c(p_large, p_small, hdr, tmp_dir, engine_log):
    """lag_search_mode="pallas": the select path on K2."""
    import torch

    from euispice_coreg_tpu_torch.engine import quad_score
    from euispice_coreg_tpu_torch.io import fits

    def run(return_type="AlignmentResults"):
        lag, A = carr_alignment(p_large, p_small, "pallas")
        out = A.align_using_carrington(reference_date=CARR_DATE,
                                       return_type=return_type, **CARR_GRID)
        torch.cuda.synchronize()
        return lag, out

    engine_log.lines.clear()
    before = quad_score.LAUNCHES
    t0 = time.perf_counter()
    lag, res = run()
    t_first = time.perf_counter() - t0
    launched = quad_score.LAUNCHES - before
    want_lines = ("engine path: carrington linearized select",
                  f"carrington select: K2 quad kernel ({CARR_LAGS ** 2} lags)")
    if launched <= 0 or not all(m in engine_log.lines for m in want_lines):
        raise AssertionError(f"slice C did not run K2 ({launched} launches): "
                             f"{engine_log.lines}")
    rec = check_recovery("slice C", lag, res, TRUE_SHIFT, 1.0)

    out_path = os.path.join(tmp_dir, "carr_small_corrected.fits")
    res.write_corrected_fits([0], out_path)
    back = fits.open(out_path)[0].header
    want = hdr["CRVAL1"] + res.shift_arcsec[0]
    true_crval1 = hdr["CRVAL1"] + TRUE_SHIFT
    if not (abs(back["CRVAL1"] - want) < 1e-9
            and abs(back["CRVAL1"] - true_crval1) < 1.0):
        raise AssertionError(f"corrected CRVAL1 {back['CRVAL1']} (expected "
                             f"{want}, true {true_crval1})")
    t0 = time.perf_counter()
    run("corr")
    t_warm = time.perf_counter() - t0
    log(f"[slice C] {N}^2 pair -> {N}^2 Carrington grid, {CARR_LAGS}^2 CRVAL "
        f"grid, pallas: K2 {launched} launch(es), {rec}; first API call "
        f"{t_first:.3f} s, warm {t_warm:.3f} s; corrected CRVAL1 "
        f"{back['CRVAL1']:.4f}\" (true {true_crval1:.4f}\")")
    log_stages("slice C", lambda: run("corr"))


def phase_slice_c_auto(p_large, p_small, engine_log):
    import torch

    engine_log.lines.clear()
    lag, A = carr_alignment(p_large, p_small, "auto")
    t0 = time.perf_counter()
    res = A.align_using_carrington(reference_date=CARR_DATE, **CARR_GRID)
    torch.cuda.synchronize()
    t_api = time.perf_counter() - t0
    paths = [m for m in ("engine path: carrington FFT fast",
                         "engine path: carrington linearized select")
             if m in engine_log.lines]
    if len(paths) != 1:
        raise AssertionError(f"slice C auto took neither the block FFT nor "
                             f"the K2 select path: {engine_log.lines}")
    rec = check_recovery("slice C auto", lag, res, TRUE_SHIFT, 1.0)
    log(f"[slice C auto] {paths[0]!r}, {rec}, API call {t_api:.3f} s")


def phase_coarse(engine_log):
    """bench.py run_carrington_coarse at the engine level: +24" injected,
    121x121 CRVAL grid at 2", "auto"."""
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch.engine import carrington as carr

    small = carr_render(carr_header(2.0, 150.0 + 24.0, 100.0))
    hdr_given = carr_header(2.0, 150.0, 100.0)
    lon_g, lat_g = carr.carrington_grid(CARR_GRID["lonlims"],
                                        CARR_GRID["latlims"],
                                        CARR_GRID["shape"])
    small_d = torch.as_tensor(small, dtype=torch.float32, device=DEVICE)
    ref_d = torch.as_tensor(carr_scene(lon_g, lat_g), dtype=torch.float32,
                            device=DEVICE)
    l1 = (np.arange(CARR_LAGS) - CARR_LAGS // 2) * COARSE_STEP / 3600.0

    def run():
        out = carr.evaluate_lag_grid_carrington(
            small_d, ref_d, hdr_given, CARR_GRID["lonlims"],
            CARR_GRID["latlims"], CARR_GRID["shape"], l1, l1, [0.0], [0.0],
            [0.0], d_solar_r=1.004, reference_date=CARR_DATE,
            rate_wave="171", order=2, device=DEVICE, lag_mode="auto")
        torch.cuda.synchronize()
        return out

    engine_log.lines.clear()
    t0 = time.perf_counter()
    corr = run()
    t_first = time.perf_counter() - t0
    if f"carrington select: K2 quad kernel ({CARR_LAGS ** 2} lags)" \
            not in engine_log.lines:
        raise AssertionError(f"coarse run did not take K2: {engine_log.lines}")
    mi = np.unravel_index(np.nanargmax(corr), corr.shape)
    got = l1[mi[0]] * 3600.0
    if abs(got - 24.0) >= 3.0:
        raise AssertionError(f"coarse run missed +24\": {got}")
    t0 = time.perf_counter()
    run()
    t_warm = time.perf_counter() - t0
    log(f"[coarse] {N}^2 grid, {CARR_LAGS}^2 at {COARSE_STEP}\", auto -> K2: argmax "
        f"{got:+.1f}\" / {l1[mi[1]] * 3600.0:+.1f}\", engine call first "
        f"{t_first:.3f} s, warm {t_warm:.3f} s")


def phase_sunpy(p_large, p_small):
    import torch

    def run():
        lag, A = carr_alignment(p_large, p_small, "auto")
        res = A.align_using_carrington(method_carrington_reprojection="sunpy")
        torch.cuda.synchronize()
        return lag, res

    t0 = time.perf_counter()
    lag, res = run()
    t_api = time.perf_counter() - t0
    rec = check_recovery("sunpy", lag, res, TRUE_SHIFT, 1.0)
    log(f"[sunpy] {N}^2, {CARR_LAGS}^2 CRVAL grid, auto: {rec}, API call "
        f"{t_api:.3f} s")
    log_stages("sunpy", run)


# ---------------------------------------------------------------------------
# phase 7: slice D, the block path for mixed grids ("auto")
# ---------------------------------------------------------------------------

MIXED_LAGS = 21      # CRVAL lags per axis at 1" (bench.py run_mixed_grid)


def mixed_lags(n_cdelt):
    """21x21 CRVAL at 1" x n_cdelt CDELT1 x n_cdelt CDELT2 (steps of 0.5 %
    of the pixel, arcsec) x 3 CROTA (bench.py:243)."""
    import numpy as np

    lag = (np.arange(MIXED_LAGS) - MIXED_LAGS // 2) * 1.0
    frac = (np.arange(n_cdelt) - n_cdelt // 2) * 0.005 * CDELT_ARCSEC
    return dict(lag_crval1=lag, lag_crval2=lag, lag_cdelt1=frac,
                lag_cdelt2=frac, lag_crota=[-0.05, 0.0, 0.05])


def central_argmax(corr):
    """CRVAL argmax of the (cdelt = 0, crota = 0) plane."""
    import numpy as np

    c3, c4, c5 = (n // 2 for n in corr.shape[2:5])
    plane = corr[:, :, c3, c4, c5, 0]
    return np.unravel_index(np.nanargmax(plane), plane.shape)


def phase_slice_d(p_large, p_small, engine_log):
    """auto on 11907 candidates (27 combos on the block path), the same grid
    under "pallas" (K1), and 75 combos on the block path."""
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch import Alignment
    from euispice_coreg_tpu_torch.engine import warp_score

    def run(n_cdelt, mode, return_type="AlignmentResults"):
        lags = mixed_lags(n_cdelt)
        A = Alignment(p_large, p_small, small_fov_window=0,
                      large_fov_window=0, lag_search_mode=mode,
                      device=DEVICE, **lags)
        out = A.align_using_helioprojective(return_type=return_type)
        torch.cuda.synchronize()
        return lags["lag_crval1"], out

    def check(label, lag, res, want_lines):
        missing = [m for m in want_lines
                   if not any(line.startswith(m) for line in engine_log.lines)]
        if missing:
            raise AssertionError(f"{label}: no log line {missing}: "
                                 f"{engine_log.lines}")
        mi = central_argmax(res.corr)
        if abs(lag[mi[0]] - TRUE_SHIFT) >= 1.5 \
                or abs(res.shift_arcsec[0] - TRUE_SHIFT) >= 1.5:
            raise AssertionError(f"{label} missed +8\": central argmax "
                                 f"{lag[mi[0]]}, fit {res.shift_arcsec}")
        return mi

    block_lines = ("engine path: FFT block fast (mixed grid)",)
    engine_log.lines.clear()
    t0 = time.perf_counter()
    lag, res = run(3, "auto")
    t_first = time.perf_counter() - t0
    n_cand = res.corr[..., 0].size
    mi = check("slice D", lag, res, block_lines)
    t0 = time.perf_counter()
    run(3, "auto", "corr")
    t_warm = time.perf_counter() - t0
    log(f"[slice D] {N}^2, {n_cand} candidates (27 combos), auto: block "
        f"path, central argmax {lag[mi[0]]:+.1f}\" / "
        f"{lag[mi[1]]:+.1f}\", fit {res.shift_arcsec[0]:+.3f}\" / "
        f"{res.shift_arcsec[1]:+.3f}\"; API call first {t_first:.3f} s, "
        f"warm {t_warm:.3f} s")
    log_stages("slice D", lambda: run(3, "auto", "corr"))

    warp_score.LAUNCHES = 0
    t0 = time.perf_counter()
    _, res_k1 = run(3, "pallas")
    t_k1 = time.perf_counter() - t0
    if warp_score.LAUNCHES <= 0:
        raise AssertionError("slice D pallas did not launch K1")
    mi_k1 = central_argmax(res_k1.corr)
    arg5 = np.unravel_index(np.nanargmax(res.corr[..., 0]),
                            res.corr.shape[:5])
    arg5_k1 = np.unravel_index(np.nanargmax(res_k1.corr[..., 0]),
                               res.corr.shape[:5])
    dcorr = float(np.nanmax(np.abs(res.corr - res_k1.corr)))
    log(f"[slice D] same grid, pallas (K1, {warp_score.LAUNCHES} launch(es)):"
        f" central argmax {lag[mi_k1[0]]:+.1f}\" / {lag[mi_k1[1]]:+.1f}\"; "
        f"5-D argmax block {tuple(int(i) for i in arg5)}, K1 "
        f"{tuple(int(i) for i in arg5_k1)}; max |dcorr| block vs K1 "
        f"{dcorr:.3e}; API call {t_k1:.3f} s")
    if tuple(mi_k1) != tuple(mi):
        raise AssertionError(f"slice D: block central argmax {mi} != K1 "
                             f"{mi_k1}")

    engine_log.lines.clear()
    t0 = time.perf_counter()
    lag, res75 = run(5, "auto")
    t_75 = time.perf_counter() - t0
    mi = check("slice D 75 combos", lag, res75, block_lines)
    log(f"[slice D] {N}^2, {res75.corr[..., 0].size} candidates (75 combos):"
        f" block path, central argmax {lag[mi[0]]:+.1f}\" / "
        f"{lag[mi[1]]:+.1f}\", fit {res75.shift_arcsec[0]:+.3f}\"; API call "
        f"{t_75:.3f} s ({t_75 / 75 * 1e3:.1f} ms a combo, against "
        f"{t_warm / 27 * 1e3:.1f} at 27 combos)")


# ---------------------------------------------------------------------------
# phase 8: slice E, movies (align_movie_to_reference, jitter correction)
# ---------------------------------------------------------------------------

# per-frame pointing errors (arcsec), within +-4"; frame 0's is small so
# that every jitter offset relative to it stays inside the default lags
JITTER = [(0.4, -0.3), (-2.6, 1.9), (3.4, 2.2), (-1.1, -3.3), (0.6, 3.7),
          (-3.5, -1.5)]


def write_movie(tmp_dir, data, hdr, jitter, stem):
    """Frames sharing ``data`` (rendered through the header's true
    pointing), headers mispointed by ``jitter``; DATE-AVG on each."""
    import numpy as np

    from euispice_coreg_tpu_torch.io import fits

    paths = []
    for k, (jx, jy) in enumerate(jitter):
        h = hdr.copy()
        h["CRVAL1"] = hdr["CRVAL1"] - jx
        h["CRVAL2"] = hdr["CRVAL2"] - jy
        h["DATE-AVG"] = CARR_DATE
        path = os.path.join(tmp_dir, f"{stem}_{k}.fits")
        fits.write(path, [fits.PrimaryHDU(data=data.astype(np.float32),
                                          header=h)])
        paths.append(path)
    return paths


def read_crval(path):
    from euispice_coreg_tpu_torch.io import fits

    h = fits.open(path)[0].header
    return h["CRVAL1"], h["CRVAL2"]


def phase_slice_e(p_small, c_small, tmp_dir, engine_log):
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch.engine import quad_score
    from euispice_coreg_tpu_torch.io import fits
    from euispice_coreg_tpu_torch.jitter_correction import (
        align_movie_to_reference, jitter_correction_imagers)

    hdu = fits.open(p_small)[0]
    data = np.asarray(hdu.data)
    hdr = hdu.header.copy()
    hdr["CRVAL1"] += TRUE_SHIFT  # the true pointing of the rendered scene
    p_ref = os.path.join(tmp_dir, "movie_ref.fits")
    fits.write(p_ref, [fits.PrimaryHDU(data=data, header=hdr)])
    paths = write_movie(tmp_dir, data, hdr, JITTER, "movie")

    out = os.path.join(tmp_dir, "movie_out")
    os.makedirs(out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = align_movie_to_reference(paths, p_ref, path_files_output=out,
                                   window_files_input=0, reference_window=0,
                                   device=DEVICE)
    torch.cuda.synchronize()
    t_movie = (time.perf_counter() - t0) / len(paths)
    errs = []
    for k, (jx, jy) in enumerate(JITTER):
        got = np.array(res[k].shift_arcsec[:2])
        crval = np.array(read_crval(os.path.join(out, f"movie_{k}.fits")))
        errs.append(max(np.max(np.abs(got - (jx, jy))),
                        np.max(np.abs(crval - (hdr["CRVAL1"], hdr["CRVAL2"])))))
    log(f"[slice E] align_movie_to_reference, {len(paths)} frames of {N}^2, "
        f"21x21 lags at 0.5\": worst |fit - jitter| or |corrected - true| "
        f"{max(errs):.3f}\" (tol 1\"), {t_movie * 1e3:.1f} ms per frame "
        f"(warm: slice A compiled nothing new)")
    if not max(errs) < 1.0:
        raise AssertionError(f"slice E movie missed a frame: {errs}")

    out = os.path.join(tmp_dir, "jitter_out")
    os.makedirs(out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    jitter_correction_imagers(paths, out, window_files_input=0,
                              sublist_length=4, overlap=1,
                              alignement_method="helioprojective",
                              device=DEVICE)
    torch.cuda.synchronize()
    t_jit = (time.perf_counter() - t0) / (len(paths) - 1)
    anchor = np.array(read_crval(paths[0]))
    crvals = np.array([read_crval(os.path.join(out, f"movie_{k}.fits"))
                       for k in range(len(paths))])
    err = float(np.max(np.abs(crvals - anchor)))
    log(f"[slice E] jitter_correction_imagers helioprojective, "
        f"{len(paths)} frames, 100x100 lags at 0.1\", sublists of 4 + 1: "
        f"corrected CRVAL1 " + ", ".join(f"{c:.3f}" for c in crvals[:, 0])
        + f"\" (anchor {anchor[0]:.3f}\"), worst |corrected - anchor| "
        f"{err:.3f}\" (tol 1\"), {t_jit * 1e3:.1f} ms per aligned frame")
    if not err < 1.0:
        raise AssertionError(f"slice E jitter correction off by {err}")

    # Carrington mode (the default) on slice C's scene, 1024^2 grid
    hdu = fits.open(c_small)[0]
    c_hdr = hdu.header.copy()
    c_hdr["CRVAL1"] += TRUE_SHIFT
    c_paths = write_movie(tmp_dir, np.asarray(hdu.data), c_hdr, JITTER[:3],
                          "carr_movie")
    out = os.path.join(tmp_dir, "carr_jitter_out")
    os.makedirs(out)
    lag = (np.arange(41) - 20) * 0.5
    engine_log.lines.clear()
    quad_score.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    jitter_correction_imagers(
        c_paths, out, lonlims=CARR_GRID["lonlims"],
        latlims=CARR_GRID["latlims"], shape=(CARR_N, CARR_N),
        lag_crval1=lag, lag_crval2=lag, window_files_input=0,
        device=DEVICE)
    torch.cuda.synchronize()
    t_carr = (time.perf_counter() - t0) / (len(c_paths) - 1)
    paths_run = [m for m in ("engine path: carrington FFT fast",
                             "engine path: carrington linearized select")
                 if m in engine_log.lines]
    k2_launches = quad_score.LAUNCHES
    anchor = np.array(read_crval(c_paths[0]))
    crvals = np.array([read_crval(os.path.join(out, f"carr_movie_{k}.fits"))
                       for k in range(len(c_paths))])
    err = float(np.max(np.abs(crvals - anchor)))
    log(f"[slice E] jitter_correction_imagers carrington, 3 frames on a "
        f"{CARR_N}^2 Carrington grid, 41x41 lags at 0.5\": engine "
        f"{paths_run}, K2 {k2_launches} launch(es), worst |corrected - "
        f"anchor| {err:.3f}\" (tol 1\"), {t_carr * 1e3:.1f} ms per aligned "
        f"frame")
    k2_ran = paths_run == ["engine path: carrington linearized select"]
    if len(paths_run) != 1 or not err < 1.0 or k2_ran != (k2_launches > 0):
        raise AssertionError(f"slice E Carrington jitter: {paths_run}, K2 "
                             f"{k2_launches} launch(es), {err}")


# ---------------------------------------------------------------------------
# phase 9: slice F, pxlshift (AlignmentPixels)
# ---------------------------------------------------------------------------

FSI_N = 3072         # FSI-like large frame, 4.44" pixels
FSI_CROP = 1024      # the small image: a crop of it
FSI_SHIFT = (7, -5)  # (dx, dy) px of the crop


def fsi_scene(n, seed=3):
    """Smoothed white noise (Gaussian filter of 6 px through an FFT on the
    card) plus a constant: texture at every scale a crop can hold."""
    import numpy as np
    import torch

    noise = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (n, n)), device=DEVICE)
    f = torch.fft.fftfreq(n, device=DEVICE, dtype=torch.float64)
    g = torch.exp(-2.0 * (np.pi * 6.0) ** 2 * (f[:, None] ** 2 + f ** 2))
    smooth = torch.fft.ifft2(torch.fft.fft2(noise) * g).real
    return (100.0 + 20.0 * smooth / smooth.std()).float().cpu().numpy()


def phase_slice_f(tmp_dir):
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch.core.header import Header
    from euispice_coreg_tpu_torch.io import fits
    from euispice_coreg_tpu_torch.pxlshift import AlignmentPixels

    large = fsi_scene(FSI_N)
    corner = int((FSI_N - FSI_CROP - 1) / 2)
    dx, dy = FSI_SHIFT
    small = large[corner + dy:corner + dy + FSI_CROP,
                  corner + dx:corner + dx + FSI_CROP]
    paths = []
    for name, img in (("fsi", large), ("crop", small)):
        n = img.shape[0]
        hdr = Header({"NAXIS1": n, "NAXIS2": n, "CRVAL1": 0.0,
                      "CRVAL2": 0.0, "CRPIX1": (n + 1) / 2,
                      "CRPIX2": (n + 1) / 2, "CDELT1": 4.44, "CDELT2": 4.44,
                      "CUNIT1": "arcsec", "CUNIT2": "arcsec",
                      "CTYPE1": "HPLN-TAN", "CTYPE2": "HPLT-TAN"})
        paths.append(os.path.join(tmp_dir, f"{name}.fits"))
        fits.write(paths[-1], [fits.PrimaryHDU(data=img, header=hdr)])

    lag_d = np.arange(-16, 17)
    drot = [-1.0, 0.0, 1.0]
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A = AlignmentPixels(paths[0], 0, paths[1], 0, device=DEVICE)
        corr = A.find_best_parameters(lag_d, lag_d, drot)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    mi = np.unravel_index(np.nanargmax(corr), corr.shape)
    best = (int(lag_d[mi[0]]), int(lag_d[mi[1]]), drot[mi[2]])
    r_true = float(corr[mi])
    # pearson_integer_shifts against a direct float64 sliding window
    slc = A.slc_small_ref
    errs = []
    for i, j in ((mi[0], mi[1]), (0, 0), (30, 4)):
        win = A.data_large[slc[0].start + lag_d[j]:slc[0].stop + lag_d[j],
                           slc[1].start + lag_d[i]:slc[1].stop + lag_d[i]]
        ca = A.data_small - A.data_small.mean()
        cb = win - win.mean()
        direct = np.sum(ca * cb) / np.sqrt(np.sum(ca ** 2) * np.sum(cb ** 2))
        errs.append(abs(float(corr[i, j, 1]) - direct))
    log(f"[slice F] AlignmentPixels {FSI_N}^2 at 4.44\" vs a {FSI_CROP}^2 "
        f"crop at {FSI_SHIFT}, 33x33 shifts x 3 rotations: argmax {best}, "
        f"r {r_true:.9f}, pearson_integer_shifts vs direct float64 at 3 "
        f"offsets {max(errs):.2e} (tol 1e-6); find_best_parameters (FITS "
        f"load included) {times[0]:.3f} s first, {times[1]:.3f} s second")
    if best != (dx, dy, 0.0) or abs(r_true - 1.0) > 1e-6 \
            or not max(errs) <= 1e-6:
        raise AssertionError(f"slice F: argmax {best}, r {r_true}, "
                             f"direct {errs}")


def main():
    card = phase_device()
    sys.path.insert(0, REPO)
    import torch

    from euispice_coreg_tpu_torch.engine import quad_score, warp_score

    engine_log = EngineLog()
    port_logger = logging.getLogger("euispice_coreg_tpu_torch")
    port_logger.addHandler(engine_log)
    port_logger.setLevel(logging.INFO)

    build_s = phase_build()
    max_err, times = phase_kernels(torch.device(DEVICE))
    k2_err, k2_times = phase_k2_kernels(torch.device(DEVICE))

    with tempfile.TemporaryDirectory() as tmp_dir:
        p_large, p_small, hdr = write_pair(tmp_dir)
        # slices A and B: every launch count starts at 0 here
        warp_score.LAUNCHES = 0
        quad_score.LAUNCHES = 0
        corr32 = phase_slice_a(p_large, p_small, engine_log)
        launches = phase_slice_b(p_large, p_small, hdr, tmp_dir)
        main_launches = warp_score.LAUNCHES
        if main_launches <= 0 or launches <= 0:
            raise AssertionError("K1 was not launched on the main path")
        phase_precision(p_large, p_small, corr32)
        time_fast_path(p_large, p_small)

        # slice C: the Carrington path, counts from 0 again
        c_large, c_small, c_hdr = write_carr_pair(tmp_dir)
        warp_score.LAUNCHES = 0
        quad_score.LAUNCHES = 0
        phase_slice_c(c_large, c_small, c_hdr, tmp_dir, engine_log)
        k2_launches = quad_score.LAUNCHES
        if k2_launches <= 0:
            raise AssertionError("K2 was not launched on the Carrington path")
        phase_slice_c_auto(c_large, c_small, engine_log)
        phase_coarse(engine_log)
        phase_sunpy(c_large, c_small)

        # slices D-F: the block path, movies, pxlshift (each phase sets the
        # count of the kernel it drives to 0 just before that run)
        phase_slice_d(p_large, p_small, engine_log)
        phase_slice_e(p_small, c_small, tmp_dir, engine_log)
        phase_slice_f(tmp_dir)

    k_ms, p_ms = times[N]
    k2_ms, k2_plain_ms, k2_big_ms = k2_times
    log(f"[summary] card {card}; nvcc K1 {build_s['warp_score']:.2f} s, "
        f"K2 {build_s['quad_score']:.2f} s; K2 at 14641 lags "
        f"{k2_big_ms:.3f} ms")
    print(json.dumps({"kernels": [{
        "name": "warp_score (K1)",
        "route": "cuda",
        "source": "euispice_coreg_tpu_torch/csrc/warp_score.cu",
        "replaces": "euispice_coreg_tpu/engine/pallas_warp.py:40",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "quad_score (K2)",
        "route": "cuda",
        "source": "euispice_coreg_tpu_torch/csrc/quad_score.cu",
        "replaces": "euispice_coreg_tpu/engine/pallas_quad.py:39",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
