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
               euispice_coreg_tpu_torch/build/ and prints the seconds and
               each kernel's registers, shared memory and spills (nvcc's
               -Xptxas -v report, kept by engine/_build.py).
3. kernels  -- K1 against its plain version on the card: 512^2 and 2048^2,
               TAN and CAR, orders 0/1/2, lags with crota and cdelt parts,
               NaN holes.  Six sums within 1e-5 of each sum's largest
               magnitude over the lags, r within 1e-5, argmax equal.  Then
               the plain version timed at the slice-B lag grid (21x21x3 =
               1323 lags), and K1 at 2048^2 against its bound at 1323 lags
               and at the slice-D grid (11907 lags).
               K2 likewise: 512^2 and 2048^2, orders 0/1/2, correlation and
               residus_masked, shifts of +-140 px, affine and quadratic
               fields, a within-tile spread beyond the TPU kernel's bound,
               NaN holes; same tolerances (r or residue std within 1e-5).
               Then the plain version timed on one 21x21 = 441-lag set at
               2048^2, and K2 against its bound at 441 and at 121x121 =
               14641 lags, and at 14641 lags 20 px apart (shifts up to
               1200 px, most pixel-lags off the grid).  Each timing against
               the bound prints ms, pixel-lags/s, the bound (operations or
               bytes, from the published H100 peaks) and the share, and
               holds the timed launch against the plain version at every
               37th lag and its best lag (sums and r within 1e-5, best lag
               equal).
               Ragged tiles: K1 (TAN, CAR) and K2 (both methods) on a
               517x301 grid with NaN holes, at 1, LT + 1, 13 and 441 lags,
               float32 and float64: the same tolerances, and two launches
               bit-identical.
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
10. summary -- the kernels line (JSON, K1 and K2, with every timing against
               its bound), then
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

# published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): float32
# and float64 outside the tensor cores (an FMA counts two operations), HBM3
PEAK_F32 = 67e12
PEAK_F64 = 34e12
PEAK_BYTES = 3.35e12
# operations of K1 and K2 at order 2, counted from csrc/*.cu (a division, a
# sine or a cosine counts one): "pixel", float32 once per pixel whose ref
# passes the kernel's test (K1 TAN: lon*rad, lat*rad, its sine and cosine);
# "lag", float32 per such pixel and lag (K2: the field 26, x and y 2, the
# range test 4; K1 TAN: the projection 17, the inverse CDELT/PC step 14,
# the range test 4; K1 CAR: 2 + 14 + 4); "sum_f32" and "sum_f64" per
# pixel-lag that is summed (order-2 taps 22, the 9-tap sample 27, the
# finiteness test 1; float64 Sa, Saa, Sb, and Sbb, Sab as FMAs)
OPS = {"K2": {"pixel": 0, "lag": 32, "sum_f32": 50, "sum_f64": 7},
       "K1 tan": {"pixel": 4, "lag": 35, "sum_f32": 50, "sum_f64": 7},
       "K1 car": {"pixel": 0, "lag": 20, "sum_f32": 50, "sum_f64": 7}}


def log(msg):
    print(msg, flush=True)


def kernel_bound(kernel, n_ref, n_lags, n_summed, nbytes):
    """(bound_ms, bound_by) of one launch: the larger of its operations
    (:data:`OPS`, for the ``n_ref`` pixels that pass the ref test, the lags,
    and the ``n_summed`` pixel-lags that were summed) over the float32 or
    float64 peak and its bytes (each input read once, the output written
    once) over the memory rate."""
    ops = OPS[kernel]
    f32 = n_ref * (ops["pixel"] + n_lags * ops["lag"]) \
        + n_summed * ops["sum_f32"]
    t_ops = max(f32 / PEAK_F32, n_summed * ops["sum_f64"] / PEAK_F64)
    t_bytes = nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


CHECK_STRIDE = 37  # a timed launch is checked on every 37th lag


def time_against_bound(label, kernel, launch, plain, operands, n_ref,
                       repeat):
    """Times ``launch`` (CUDA events), logs ms, pixel-lags/s, the bound and
    the share on a line of their own, and returns them.  ``operands``: the
    launch's input tensors (the table last, its rows are the lags).

    Then holds the timed launch's Pearson sums against ``plain(table)``,
    the plain version on the same card tensors, at every
    :data:`CHECK_STRIDE`-th lag and the kernel's best lag: sums (counts
    included) within TOL of each sum's largest magnitude, r within TOL and
    undefined at the same lags, and the kernel's best lag the best of
    those lags under the plain version too."""
    import numpy as np

    from euispice_coreg_tpu_torch.engine import warp_score

    ms = cuda_ms(launch, repeat=repeat)
    sums = launch()
    table = operands[-1]
    n_lags = table.shape[0]
    pixels = operands[1].numel()
    nbytes = sum(t.numel() * t.element_size() for t in operands) \
        + sums.numel() * sums.element_size()
    bound, by = kernel_bound(kernel, n_ref, n_lags,
                             float(sums[:, 0].sum()), nbytes)
    out = {"lags": n_lags, "ms": ms, "pixel_lags_per_s":
           pixels * n_lags / (ms * 1e-3), "bound_ms": bound, "bound_by": by,
           "share": bound / ms}
    log(f"[kernels] {label}: kernel {ms:.3f} ms, "
        f"{out['pixel_lags_per_s']:.3e} pixel-lags/s, bound {bound:.3f} ms "
        f"({by}), share {out['share']:.3f}")

    got = sums.cpu().numpy()
    best = int(np.nanargmax(warp_score.pearson_from_sums(got)))
    rows = sorted(set(range(0, n_lags, CHECK_STRIDE)) | {best})
    want = plain(table[rows]).cpu().numpy()
    got = got[rows]
    sum_err = float(np.max(np.abs(got - want) / np.max(np.abs(want), axis=0)))
    r_got = warp_score.pearson_from_sums(got)
    r_want = warp_score.pearson_from_sums(want)
    same_nan = np.array_equal(np.isnan(r_got), np.isnan(r_want))
    r_err = float(np.nanmax(np.abs(r_got - r_want)))
    same_best = int(np.nanargmax(r_want)) == rows.index(best)
    log(f"[kernels] {label}: {len(rows)} lags against the plain version "
        f"({int(np.sum(want[:, 0] > 0))} with pixels): sums {sum_err:.2e}, "
        f"|dr| {r_err:.2e} (tol {TOL:g}), best lag {best} best there too "
        f"{same_best}")
    if not (sum_err <= TOL and r_err <= TOL and same_best and same_nan):
        raise AssertionError(f"{label}: the timed launch disagrees with the "
                             f"plain version")
    out.update(checked_lags=len(rows), max_abs_err=r_err)
    return out


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


def log_ptxas(prefix, report):
    """One line per main kernel of an nvcc -Xptxas -v report
    (``_build.parse_ptxas``)."""
    variant = {"quad_score_kernel": ("method", "correlation",
                                     "residus_masked"),
               "warp_score_kernel": ("kind", "tan", "car")}
    for r in report:
        what, *names = variant[r["kernel"]]
        log(f"{prefix} {r['kernel']}<{r['dtype']}, order {r['order']}, "
            f"{what} {names[r['variant']]}, LT {r['lag_tile']}>: "
            f"{r['registers']} registers, {r['smem']} B smem, "
            f"{r['spill_stores']} B spill stores, {r['spill_loads']} B "
            f"spill loads")


def phase_build():
    """Both kernels built at once (one nvcc each, started together); each
    kernel's registers, shared memory and spills from nvcc's report."""
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
        log_ptxas(f"[build] {kid}", _build.ptxas_report(name))
    log(f"[build] both loaded in {total:.2f} s (parallel) into "
        f"{os.path.relpath(_build.BUILD_DIR, REPO)}/")
    return {k: _build.BUILD_SECONDS[k] for k in names}


# ---------------------------------------------------------------------------
# phase 3: K1 against its plain version
# ---------------------------------------------------------------------------

def kernel_operands(n, kind, device, seed, shape=None, dtype=None):
    """Centred canvas/ref and lon/lat grids of an n x n case (or of
    ``shape`` = (rows, columns) at n x n's pixel size) with NaN holes, in
    ``dtype`` (float32 by default), plus the base WCS (degrees)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from euispice_coreg_tpu_torch.core import wcs
    from euispice_coreg_tpu_torch.core.header import pc_from_crota
    from euispice_coreg_tpu_torch.engine import warp_score
    from euispice_coreg_tpu_torch.utils import coords

    h, w = shape or (n, n)
    dtype = dtype or torch.float32
    rng = np.random.default_rng(seed)
    x, y = coords.pixel_grid(w, h)
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
            "crpix1": (w + 1) / 2, "crpix2": (h + 1) / 2,
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
            r0 = rng.integers(0, h - h // 16)
            c0 = rng.integers(0, w - w // 16)
            img[r0:r0 + h // 32, c0:c0 + w // 16] = np.nan

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    small_t = t(small)
    ref_t = t(ref)
    ref_c = (ref_t - torch.nanmean(ref_t.double()).to(dtype)).contiguous()
    small_c = small_t - torch.nanmean(small_t.double()).to(dtype)
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


def slice_d_lags():
    """The slice-D grid (:func:`mixed_lags` with 3 CDELT steps) as
    (11907, 5) lags in degrees."""
    import numpy as np

    m = mixed_lags(3)
    axes = [np.asarray(m[k], dtype=np.float64) / 3600.0
            for k in ("lag_crval1", "lag_crval2", "lag_cdelt1", "lag_cdelt2")]
    g = np.meshgrid(*axes, np.asarray(m["lag_crota"]), indexing="ij")
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

    # the slice-B grid (1323 lags), order 2: the plain version timed and
    # every lag checked at 512^2 and 2048^2; then the kernel at 2048^2
    # timed against its bound there and at the slice-D grid (11907 lags),
    # each timed launch checked against the plain version on a subset
    plain_ms = {}
    lags = slice_b_lags()
    kw = dict(pad=warp_score.PAD, order=2, kind="tan")
    for n in (512, N):
        canvas, ref, lon, lat, base, _ = kernel_operands(n, "tan", device,
                                                         seed=1)
        table = torch.as_tensor(warp_score.lag_table(base, lags),
                                dtype=torch.float32, device=device)
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
        plain_ms[n] = p_ms
        log(f"[kernels] K1 {n}^2 x {len(lags)} lags, order 2, TAN: plain "
            f"{p_ms:.3f} ms, |dr| {err:.2e}")
    n_ref = int(torch.isfinite(ref).sum())
    timings = []
    for grid in (slice_b_lags(), slice_d_lags()):
        table = torch.as_tensor(warp_score.lag_table(base, grid),
                                dtype=torch.float32, device=device)
        timings.append(time_against_bound(
            f"K1 {N}^2 x {len(grid)} lags, order 2, TAN", "K1 tan",
            lambda: warp_score.warp_score_sums(canvas, ref, lon, lat, table,
                                               **kw),
            lambda t: warp_score.warp_score_sums_reference(
                canvas, ref, lon, lat, t, **kw),
            (canvas, ref, lon, lat, table), n_ref, repeat=3))
        max_err = max(max_err, timings[-1]["max_abs_err"])
    return max_err, plain_ms[N], timings


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

def k2_operands(n, device, seed, shape=None, dtype=None):
    """Pre-warped image and reference of an n x n case (or of ``shape`` =
    (rows, columns) at n x n's scale; smooth, positive, NaN holes), in
    ``dtype`` (float32 by default): the reference is the image moved by
    (dx, dy) = (5, -3)."""
    import numpy as np
    import torch

    h, w = shape or (n, n)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] * (512.0 / n)
    warped = (100.0 + np.sin(xx / 9.0) * np.cos(yy / 13.0)
              + 0.1 * rng.standard_normal((h, w)))
    ref = np.roll(warped, (3, -5), axis=(0, 1)) \
        + 0.05 * rng.standard_normal((h, w))
    for img in (warped, ref):
        for _ in range(4):
            r0 = rng.integers(0, h - h // 8)
            c0 = rng.integers(0, w - w // 8)
            img[r0:r0 + h // 32, c0:c0 + w // 16] = np.nan

    def t(a):
        return torch.as_tensor(a, dtype=dtype or torch.float32,
                               device=device)

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


# K2's timed lag grids (side, step in px): slice C's 441 and 14641 lags, and
# 14641 lags at 20 px, shifts of up to 1200 px like the coarse run's on its
# Carrington grid, where most pixel-lags fall off the grid
K2_GRIDS = ((21, 1.0), (121, 0.5), (121, 20.0))


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

    # at 2048^2, order 2: the plain version timed and every lag checked on
    # the 441-lag grid, then the kernel timed against its bound at each of
    # K2_GRIDS, each timed launch checked against the plain version on a
    # subset
    warped, ref = k2_operands(N, device, seed=5)
    canvas, ref_c = quad_score.quad_canvases(warped, ref,
                                             method="correlation")
    kw = dict(pad=quad_score.PAD, order=2, method="correlation")
    table = torch.as_tensor(quad_score.coeff_table(k2_grid_coeffs(21, 1.0)),
                            dtype=torch.float32, device=device)
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
        f"plain {p_ms:.3f} ms, |dr| {err:.2e}")
    n_ref = int(torch.isfinite(ref_c).sum())
    timings = []
    for side, step in K2_GRIDS:
        table = torch.as_tensor(
            quad_score.coeff_table(k2_grid_coeffs(side, step)),
            dtype=torch.float32, device=device)
        timings.append(time_against_bound(
            f"K2 {N}^2 x {table.shape[0]} lags at {step:g} px, order 2, "
            f"correlation", "K2",
            lambda: quad_score.quad_score_sums(canvas, ref_c, table, **kw),
            lambda t: quad_score.quad_score_sums_reference(canvas, ref_c, t,
                                                           **kw),
            (canvas, ref_c, table), n_ref, repeat=3))
        max_err = max(max_err, timings[-1]["max_abs_err"])
    return max_err, p_ms, timings


RAGGED_SHAPE = (517, 301)  # rows x columns: no multiple of the 8 x 32 tile


def ragged_lag_counts(lag_tile):
    """Lag counts that leave the last lag tile ragged: 1, LT + 1, 13, 441."""
    return sorted({1, lag_tile + 1, 13, 441})


def ragged_lags(kernel, n_lags, cdelt, seed):
    """``n_lags`` lags around each case's true shift, the true shift among
    them: (L, 5) in degrees for K1, (L, 6, 2) quadratic maps for K2."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if kernel == "K1":
        lags = np.zeros((n_lags, 5))
        lags[:, 0] = 3.0 * cdelt + rng.uniform(-4, 4, n_lags) * cdelt
        lags[:, 1] = rng.uniform(-4, 4, n_lags) * cdelt
        lags[:, 2] = rng.uniform(-0.005, 0.005, n_lags) * cdelt
        lags[:, 4] = rng.uniform(-0.1, 0.1, n_lags)
        lags[n_lags // 2] = (3.0 * cdelt, 0.0, 0.0, 0.0, 0.0)
        return lags
    c = np.zeros((n_lags, 6, 2))
    c[:, 2, 0] = 5.0 + rng.uniform(-6, 6, n_lags)
    c[:, 2, 1] = -3.0 + rng.uniform(-6, 6, n_lags)
    c[:, 0, 0] = rng.uniform(-2e-3, 2e-3, n_lags)
    c[:, 4, 1] = rng.uniform(-2e-6, 2e-6, n_lags)
    c[n_lags // 2] = 0.0
    c[n_lags // 2, 2] = (5.0, -3.0)
    return c


def phase_ragged(device):
    """K1 and K2 against their plain versions where the tiles are ragged:
    a 517 x 301 grid (no multiple of the 8 x 32 pixel tile) with NaN holes,
    lag counts 1, LT + 1, 13 and 441 (the last lag tile ragged), float32
    and float64, K1 TAN and CAR, K2 correlation and residus_masked, orders
    0-2 in turn.  Same tolerances as above; two launches must give
    bit-identical sums.  Returns the largest score difference of each
    kernel."""
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch.engine import _build, quad_score, warp_score

    lag_tile = {kid: warp_score.build_tiles(_build.load(name), name)[0]
                for kid, name in (("K1", "warp_score"), ("K2", "quad_score"))}
    log(f"[ragged] lag tile: K1 {lag_tile['K1']}, K2 {lag_tile['K2']}")
    finish = {"correlation": warp_score.pearson_from_sums,
              "residus_masked": quad_score.residus_from_sums,
              "tan": warp_score.pearson_from_sums,
              "car": warp_score.pearson_from_sums}
    max_err = {"K1": 0.0, "K2": 0.0}
    for dtype in (torch.float32, torch.float64):
        for case in ("tan", "car", "correlation", "residus_masked"):
            kernel = "K1" if case in ("tan", "car") else "K2"
            if kernel == "K1":
                canvas, ref, lon, lat, base, cdelt = kernel_operands(
                    512, case, device, seed=11, shape=RAGGED_SHAPE,
                    dtype=dtype)
            else:
                warped, ref0 = k2_operands(512, device, seed=12,
                                           shape=RAGGED_SHAPE, dtype=dtype)
                canvas, ref = quad_score.quad_canvases(warped, ref0,
                                                       method=case)
                cdelt = 1.0
            for k, n_lags in enumerate(ragged_lag_counts(lag_tile[kernel])):
                order = (k + len(case)) % 3
                lags = ragged_lags(kernel, n_lags, cdelt, seed=n_lags)
                if kernel == "K1":
                    table = torch.as_tensor(warp_score.lag_table(base, lags),
                                            dtype=dtype, device=device)
                    kw = dict(pad=warp_score.PAD, order=order, kind=case)

                    def run(fn):
                        return fn(canvas, ref, lon, lat, table, **kw)

                    got = run(warp_score.warp_score_sums)
                    again = run(warp_score.warp_score_sums)
                    want = run(warp_score.warp_score_sums_reference)
                else:
                    table = torch.as_tensor(quad_score.coeff_table(lags),
                                            dtype=dtype, device=device)
                    kw = dict(pad=quad_score.PAD, order=order, method=case)
                    got = quad_score.quad_score_sums(canvas, ref, table, **kw)
                    again = quad_score.quad_score_sums(canvas, ref, table,
                                                       **kw)
                    want = quad_score.quad_score_sums_reference(
                        canvas, ref, table, **kw)
                torch.cuda.synchronize()
                same_bits = bool(torch.equal(got, again))
                got, want = got.cpu().numpy(), want.cpu().numpy()
                sum_err = float(np.max(np.abs(got - want)
                                       / np.max(np.abs(want), axis=0)))
                s_got, s_want = finish[case](got), finish[case](want)
                s_err = float(np.max(np.abs(s_got - s_want)))
                pick = np.nanargmin if case == "residus_masked" \
                    else np.nanargmax
                same_arg = int(pick(s_got)) == int(pick(s_want))
                log(f"[ragged] {kernel} {case} {str(dtype)[6:]} "
                    f"{RAGGED_SHAPE[0]}x{RAGGED_SHAPE[1]} x {n_lags} lags, "
                    f"order {order}: sums {sum_err:.2e}, |dscore| "
                    f"{s_err:.2e} (tol {TOL:g}), best lag equal {same_arg}, "
                    f"two launches bit-identical {same_bits}")
                if not (sum_err <= TOL and s_err <= TOL and same_arg
                        and same_bits and np.all(want[:, 0] > 0)):
                    raise AssertionError(
                        f"{kernel} {case} {dtype} x {n_lags} lags disagrees "
                        f"with its plain version or itself")
                max_err[kernel] = max(max_err[kernel], s_err)
    return max_err


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
    log_stages("coarse", run)


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
    max_err, p_ms, k1_timings = phase_kernels(torch.device(DEVICE))
    k2_err, k2_plain_ms, k2_timings = phase_k2_kernels(torch.device(DEVICE))
    ragged_err = phase_ragged(torch.device(DEVICE))

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

    log(f"[summary] card {card}; nvcc K1 {build_s['warp_score']:.2f} s, "
        f"K2 {build_s['quad_score']:.2f} s; K1 at 1323 / 11907 lags "
        f"{k1_timings[0]['ms']:.3f} / {k1_timings[1]['ms']:.3f} ms, K2 at "
        f"441 / 14641 / 14641 wide lags " + " / ".join(
            f"{t['ms']:.3f}" for t in k2_timings) + " ms")
    # no single PyTorch call computes either function (grid_sample has no
    # order-2 B-spline, no mirror rule at sample_image's edge and no masked
    # sums), so library_ms is null
    print(json.dumps({"kernels": [{
        "name": "warp_score (K1)",
        "route": "cuda",
        "source": "euispice_coreg_tpu_torch/csrc/warp_score.cu",
        "replaces": "euispice_coreg_tpu/engine/pallas_warp.py:40",
        "launches": main_launches,
        "max_abs_err": max(max_err, ragged_err["K1"]),
        "ms": k1_timings[0]["ms"],
        "plain_ms": p_ms,
        "bound_ms": k1_timings[0]["bound_ms"],
        "bound_by": k1_timings[0]["bound_by"],
        "share": k1_timings[0]["share"],
        "library_ms": None,
        "timings": k1_timings,
    }, {
        "name": "quad_score (K2)",
        "route": "cuda",
        "source": "euispice_coreg_tpu_torch/csrc/quad_score.cu",
        "replaces": "euispice_coreg_tpu/engine/pallas_quad.py:39",
        "launches": k2_launches,
        "max_abs_err": max(k2_err, ragged_err["K2"]),
        "ms": k2_timings[0]["ms"],
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_timings[0]["bound_ms"],
        "bound_by": k2_timings[0]["bound_by"],
        "share": k2_timings[0]["share"],
        "library_ms": None,
        "timings": k2_timings,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
