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
               must read back.  Then slice I (below).  Then "auto" must take
               the block FFT or the select path, on the leg the routing
               names (carrington._tile_fft_mode: tile-FFT on a card), and
               recover the same; its warm API call is timed against
               "pallas" (K2) in the same phase.  Then the coarse grid at the
               engine level (121x121 at 2", +24" injected, "auto"): the
               whole set passes tile-FFT's gate and declines against K2, no
               hybrid, K2 scores every lag, +24" within 3"; timed against
               "pallas", with the hybrid picker's time on its lags.  Then
               the "sunpy" branch (121x121 0.5", "auto"): +8" within 1".
   slice I  -- the Carrington tile-FFT evaluator (no kernel of ours: cuFFT,
               gathers and elementwise torch).  (I1) slice C's call under
               lag_search_mode="tile_fft": the whole lag set on tile-FFT
               surfaces (the log must show that leg and nothing else, K2
               launched 0 times), the tile plan, +8" within 1", argmax
               equal to slice C's K2 hypercube, its peak within 1e-3 and
               every value within 2e-3, first and warm API times and stage clocks, float32 and
               float64 top-2 margins; CUDA-event times of the field build,
               stage-1 forward transforms, products and inverse, and stage
               2, with the bytes each must move and its kernel launches
               (torch.profiler); the evaluator at tile_batch 1/2/4/8; peak
               device memory.  (I3) the same operands under a budget of
               half the tiles' boxes: 2 groups, within 1e-6 relative.
               The auto decision: tile-FFT's select evaluation against
               K2's on the same grid.  (I2) the coarse grid under
               "tile_fft": which leg ran, +24" within 3".  (I4)
               CarringtonTransform + Rectifier onto the 2048^2 grid,
               float64 on the card, against reproject_to_carrington:
               coordinates within 1e-9 px, images within 1e-6.
7. slice D  -- public API, "auto", 21x21 CRVAL (1") x 3 CDELT1 x 3 CDELT2
               (0.5 % of the pixel) x 3 CROTA = 11907 candidates on A's
               pair: the router must send it to K1 (its "auto route" line
               and K1's engine line) and recover +8" within 1.5"; the same
               grid under "fast" must take the block path (27 combos) and
               under "pallas" (K1) give auto's hypercube bit for bit, all
               three with the same CRVAL argmax on the central plane;
               5 x 5 x 3 = 75 combos under "fast" must take the block path
               and recover the same, printed beside the router's
               estimates.
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
               the rotation fleet (one device) against a direct float64
               window Pearson at 3 offsets within 1e-6.
10. slice G -- SPICE: an L2 cube of 192 raster steps x 1024 rows x 48
               spectral pixels (4" x 1.098", 60 s a step) rendered through
               its true pointing and handed over with a CRVAL that the lag
               (+8", -4") corrects, and 20 HRIEUV-like frames (2048^2 at
               0.492", 600 s apart) spanning the 3.2 h raster.  (G1)
               SPICEComposedMapBuilder.process: the synthetic raster
               against the scene within 1e-4 relative; (G2)
               AlignmentSpice.align_using_helioprojective, "auto", 41x41
               CRVAL at 1" (FFT path); (G3) 21x21 at 1" x CDELT1 {-0.08,
               0, +0.08}" x CROTA {-0.2, 0, +0.2} deg = 3969 candidates
               under "pallas" (K1), "auto" (routed to K1, pallas's
               hypercube bit for bit) and "fast" (block path), CRVAL argmax
               equal; (G4) align_using_carrington("fa"), "pallas" (K2),
               41x41 at 1" on a 1024^2 Carrington grid over the raster;
               G2-G4 recover (+8", -4") within (2", 1"); (G5) the iterative
               context raster, batched, 11x11 at 1" x 3 CROTA = 363 lags in
               chunks of 64, 9 of them again through the sequential route
               (within 1e-6).  K1 and K2 timed against their bounds at
               G3's and G4's operands; the compose and chunk-score device
               functions timed on G5's first chunk.
   phase R  -- the "auto" router of mixed grids (after slice G): slice
               A's pair with 3 CROTA combos and CRVAL sub-grids of 11^2,
               21^2, 31^2, 41^2 and 51^2 (1", centred on the +8"), 21^2 x
               9 combos (3 CDELT1 x 3 CROTA), 21^2 x 3 at order 0, and
               G3's operands (1024x192, 21^2 x 9).  Each grid once through
               the API under "auto" (its route line), then at the engine
               warm under "pallas" (K1) and the block path (best of 2
               after a warm-up), beside the router's two estimates.  Fails
               where the two routes' CRVAL argmax (central plane) differ,
               or where auto took the slower route and the two differ by
               more than 25%.  Prints the router's constants fitted to
               these times and the crossover (CRVAL lags a combo at 2048^2)
               under the constants in use and the fitted ones.
11. slice H -- tile-compressed FITS, as the SIDC distributes EUI files:
               slice A's pair (photon-noise-like sigma 0.05 added, a block
               of NaNs in the small image) written as RICE_1 float32
               (quantize level 16, SUBTRACTIVE_DITHER_1, row tiles), the
               small image once more as HCOMPRESS_1 (16-row tiles).  (H1)
               fits.open of each timed against the uncompressed file,
               every decode within one quantization step (its tile's
               ZSCALE) of the source, NaNs where the source has them; (H2)
               Alignment on the compressed pair under "auto" (FFT path,
               +8" within 1") and "pallas" (K1, slice B's grid, within
               1.5"), first and warm API times and the stage clocks
               (api_fits_load_s includes the decode); write_corrected_fits
               to a compressed output, timed and read back: a
               CompImageHDU with the input's ZCMPTYPE, ZQUANTIZ and ZTILE,
               the corrected CRVAL1/2, data within one quantization step of
               the input's decode.  No figure is drawn: the card's machine
               has no matplotlib, and the script imports none.
12. mesh    -- phase M, the sharded paths (a mesh is a list of devices,
               one shard each): two shards on cuda:0, and every card when
               there are several.  K1 on slice B's 1323 lags and K2 on
               slice C's 14641 lags through their engine entry points:
               one launch per shard (counted from 0 just before the call),
               r within 1e-12 of the unsharded call, argmax equal, two
               sharded calls bit-identical, the shards' launches timed
               against the bound and held to the plain version at every
               37th lag; the FFT path on slice A's 121^2 grid (within
               1e-12); tile-FFT on I1's operands (argmax equal, peak within
               1e-6 relative, peak memory); the movie fleet on slice E's 6
               frames (its log line, shifts within 1e-3" of the per-frame
               route, every frame within 1" of its jitter); the rotation
               fleet on slice F (within 1e-12 of the fleet on one device);
               the default route
               (use_device_mesh=True: no mesh on one card, slice A's
               hypercube bit-identical).  Each sharded call's warm time is
               printed beside the unsharded call's.
13. phase X -- the port's examples as a user runs them, in-process on the
               card at their own sizes (examples/*_torch.py main): the
               demo (13x13 CRVAL on a 96^2/196^2 pair, then its Carrington
               leg on a 128^2 grid), align_hri_fsi's synthetic pair,
               align_spice_synras (synthetic raster, then AlignmentSpice),
               jitter_movie (6 frames), and align_hri_fsi's real-file
               branch on an N^2 pair written RICE_1 as slice H's, +24" /
               +6" injected.  Each twice (first and warm wall time), with
               K1's and K2's launches and the engine's route lines.  Each
               must recover its injected shift (the demo prints OK; 1",
               SPICE (2", 1"), jitter 0.5" a frame), and the demo's
               Carrington leg must launch K2 where the route is K2.
14. phase P -- the port's API reference on this machine, which has no JAX:
               tools/gen_api_doc_torch.py --check must find the committed
               docs/API_torch.md fresh, with no jax or euispice_coreg_tpu
               module imported.  No kernel.
15. phase Q -- the port's bench, bench_torch.main([]) in this process:
               bench.py's nine legs at their own sizes on the card.  Its
               JSON line is captured (printed here after "[bench] line:",
               never as the last line); fails unless every leg has
               seconds, leg_errors is null, the bench names the card of
               phase 1 (name and power limit), K2 launched in the
               carr_coarse leg's best run and the README generator's line
               loader (tools/gen_readme_perf_torch.py) neither refuses
               the line nor masks a leg of it.  Then every leg's last
               hypercube is held to the JAX package's at the same size
               (tests/goldens/jax_bench_legs.npz, written on a CPU by
               tools/gen_jax_goldens_torch.py; read with numpy), one
               "[golden]" line a leg: operands within 1e-12 relative,
               NaN pattern, max |d| within the tolerance of the two
               routes (bench_torch.golden_tolerance), argmax equal or,
               where the golden's own top-2 margin is below both that
               tolerance and 1e-5, within it of the golden's maximum; the
               legs whose operands the card builds in float32 (api,
               synras, iterative) hold the argmax exactly there and their
               values at 1e-5 on host-built operands; carr_coarse's
               witness (the JAX package's exact engine on every 10th lag)
               is printed beside it; and the mixed grid once more on K1
               (one launch, the bench's renders), held to the same golden
               with the exact argmax on its CROTA = 0 plane.
16. summary -- the kernels line (JSON, K1 and K2, with every timing against
               its bound, slice G's and the two-shard launches among them),
               then {"ok": true, "device": ...} as the last line.
"""
from __future__ import annotations

import contextlib
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


def compare_sums(got, want):
    """Kernel sums ``got`` against the plain version's ``want`` (numpy,
    lags x sums): (the largest error relative to each sum's largest
    magnitude, r's largest error, r undefined at the same lags)."""
    import numpy as np

    from euispice_coreg_tpu_torch.engine import warp_score

    sum_err = float(np.max(np.abs(got - want) / np.max(np.abs(want), axis=0)))
    r_got = warp_score.pearson_from_sums(got)
    r_want = warp_score.pearson_from_sums(want)
    same_nan = np.array_equal(np.isnan(r_got), np.isnan(r_want))
    return sum_err, float(np.nanmax(np.abs(r_got - r_want))), same_nan


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
    sum_err, r_err, same_nan = compare_sums(got, want)
    same_best = int(np.nanargmax(warp_score.pearson_from_sums(want))) \
        == rows.index(best)
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
    """Smooth deterministic 'sun': Gaussian blobs over (u, v) in degrees,
    numpy arrays or torch tensors (computed where they lie)."""
    import numpy as np

    if isinstance(u, np.ndarray):
        out, exp = np.full(u.shape, 100.0), np.exp
    else:
        import torch

        out, exp = torch.full_like(u, 100.0), torch.exp
    rng = np.random.default_rng(7)
    for _ in range(40):
        cx, cy = rng.uniform(-0.1, 0.1, size=2)
        w = rng.uniform(0.004, 0.02)
        a = rng.uniform(0.5, 3.0)
        out += a * exp(-(((u - cx) ** 2) + ((v - cy) ** 2)) / (2 * w * w))
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

def write_pair(tmp_dir, shift=(TRUE_SHIFT, 0.0), noise=0.0, rice=False):
    """The headline pair, rendered on DEVICE: the small image through its
    true pointing, handed over with CRVAL1/2 mispointed by -``shift``
    (arcsec); the reference is the scene on the small header's own grid
    (correct under that WCS).  ``noise``: the sigma of seeded normal noise
    added to both.  ``rice``: each written as EUI files are distributed,
    an empty primary HDU then RICE_1 float32 row tiles as slice H's; else
    as one primary HDU.  Returns the two paths and the header."""
    import numpy as np
    import torch

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
    given = dict(base, crval1=base["crval1"] - shift[0] / 3600.0,
                 crval2=base["crval2"] - shift[1] / 3600.0)
    x, y = (torch.as_tensor(a, device=DEVICE) for a in coords.pixel_grid(N, N))
    rng = np.random.default_rng(13)
    hdr = Header({
        "NAXIS1": N, "NAXIS2": N,
        "CRVAL1": given["crval1"] * 3600.0, "CRVAL2": given["crval2"] * 3600.0,
        "CRPIX1": given["crpix1"], "CRPIX2": given["crpix2"],
        "CDELT1": CDELT_ARCSEC, "CDELT2": CDELT_ARCSEC,
        "CUNIT1": "arcsec", "CUNIT2": "arcsec",
        "CTYPE1": "HPLN-TAN", "CTYPE2": "HPLT-TAN", "CROTA": 0.75,
        "PC1_1": pc[0], "PC1_2": pc[1], "PC2_1": pc[2], "PC2_2": pc[3],
    })
    paths = []
    for name, params in (("large", given), ("small", base)):
        data = scene(*wcs.tan_pixel_to_world(params, x, y)).cpu().numpy()
        if noise:
            data += rng.normal(0.0, noise, data.shape)
        data = data.astype(np.float32)
        path = os.path.join(tmp_dir, f"{name}.fits")
        if rice:
            fits.write(path, [fits.PrimaryHDU(), fits.CompImageHDU(
                data=data, header=hdr, name=name.upper(),
                compression_type="RICE_1", **H_COMPRESSION)])
        else:
            fits.write(path, [fits.PrimaryHDU(data=data, header=hdr)])
        paths.append(path)
    return paths[0], paths[1], hdr


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
    return st


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
    """lag_search_mode="pallas": the select path on K2.  Returns the K2
    hypercube and the stage clocks of a warm run."""
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
    return res.corr, log_stages("slice C", lambda: run("corr"))


ROUTING_ORDER = ("auto", "pallas", "pallas", "auto")   # warm calls timed


def phase_slice_c_auto(p_large, p_small, engine_log):
    """"auto": the block FFT gate fails on this curved grid, so the select
    path runs, on the leg that carrington._tile_fft_mode names for "auto"
    on a card (tile-FFT surfaces); the log must show that leg.  Then warm
    API calls of "auto" and of "pallas" (the select path on K2) in
    ROUTING_ORDER: the routing's effect on this grid, in one run.  Returns
    {mode: [seconds, ...]}."""
    import torch

    from euispice_coreg_tpu_torch.engine import carrington as carr

    def run(mode, return_type="AlignmentResults"):
        lag, A = carr_alignment(p_large, p_small, mode)
        t0 = time.perf_counter()
        out = A.align_using_carrington(reference_date=CARR_DATE,
                                       return_type=return_type, **CARR_GRID)
        torch.cuda.synchronize()
        return lag, out, time.perf_counter() - t0

    engine_log.lines.clear()
    lag, res, t_api = run("auto")
    paths = [m for m in ("engine path: carrington FFT fast",
                         "engine path: carrington linearized select")
             if m in engine_log.lines]
    if len(paths) != 1:
        raise AssertionError(f"slice C auto took neither the block FFT nor "
                             f"the select path: {engine_log.lines}")
    legs = [m for m in engine_log.lines
            if m.startswith("carrington select:")]
    routing = carr._tile_fft_mode("auto", torch.device(DEVICE))
    want = (f"carrington select: tile-FFT surfaces ({CARR_LAGS ** 2} lags)"
            if routing else
            f"carrington select: K2 quad kernel ({CARR_LAGS ** 2} lags)")
    if paths[0].endswith("linearized select") and legs != [want]:
        raise AssertionError(f"slice C auto: the select path took {legs}, "
                             f"the routing names {want!r}")
    rec = check_recovery("slice C auto", lag, res, TRUE_SHIFT, 1.0)
    warm = {"auto": [], "pallas": []}
    for mode in ROUTING_ORDER:
        warm[mode].append(run(mode, "corr")[2])
    log(f"[slice C auto] {paths[0]!r} {legs}, routing "
        f"_tile_fft_mode('auto', cuda) = {routing!r}, {rec}, first API call "
        f"{t_api:.3f} s; warm API calls in the order "
        f"{'/'.join(ROUTING_ORDER)}: auto "
        + " / ".join(f"{t:.3f}" for t in warm["auto"]) + " s, pallas (K2) "
        + " / ".join(f"{t:.3f}" for t in warm["pallas"]) + " s")
    return warm


def phase_coarse(engine_log):
    """bench.py run_carrington_coarse at the engine level: +24" injected,
    121x121 CRVAL grid at 2", "auto": the whole set passes tile-FFT's gate
    and declines against K2, so K2 scores every lag and no hybrid runs.
    Warm engine calls of "auto" and "pallas" in ROUTING_ORDER, and the
    hybrid picker's time on these lags (what the decline saves).  Returns
    {mode: [seconds, ...], "hybrid_pick_ms": ms}."""
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch.engine import carrington as carr
    from euispice_coreg_tpu_torch.engine import tile_fft

    small = carr_render(carr_header(2.0, 150.0 + 24.0, 100.0))
    hdr_given = carr_header(2.0, 150.0, 100.0)
    lon_g, lat_g = carr.carrington_grid(CARR_GRID["lonlims"],
                                        CARR_GRID["latlims"],
                                        CARR_GRID["shape"])
    small_d = torch.as_tensor(small, dtype=torch.float32, device=DEVICE)
    ref_d = torch.as_tensor(carr_scene(lon_g, lat_g), dtype=torch.float32,
                            device=DEVICE)
    l1 = (np.arange(CARR_LAGS) - CARR_LAGS // 2) * COARSE_STEP / 3600.0

    def run(mode="auto"):
        t0 = time.perf_counter()
        out = carr.evaluate_lag_grid_carrington(
            small_d, ref_d, hdr_given, CARR_GRID["lonlims"],
            CARR_GRID["latlims"], CARR_GRID["shape"], l1, l1, [0.0], [0.0],
            [0.0], d_solar_r=1.004, reference_date=CARR_DATE,
            rate_wave="171", order=2, device=DEVICE, lag_mode=mode)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    engine_log.lines.clear()
    with record_calls(tile_fft, "evaluate_select_tile_fft") as calls:
        corr, t_first = run()
    # "auto": the whole set passes the gate, its plan declines against K2
    # (the card's cost model, tile_fft.plan_tiles), and no hybrid follows
    want = ("carrington tile-FFT: the whole set passed the gate and was "
            "declined against K2, no hybrid",
            f"carrington select: K2 quad kernel ({CARR_LAGS ** 2} lags)")
    if not all(m in engine_log.lines for m in want) or len(calls) != 1 \
            or any("screen" in m for m in engine_log.lines):
        raise AssertionError(f"coarse run did not go from the declined "
                             f"whole-set plan to K2: {engine_log.lines}")
    log("[coarse] auto: " + "; ".join(
        m for m in engine_log.lines if m.startswith("tile-FFT declined")
        or m.startswith("carrington tile-FFT")))
    mi = np.unravel_index(np.nanargmax(corr), corr.shape)
    got = l1[mi[0]] * 3600.0
    if abs(got - 24.0) >= 3.0:
        raise AssertionError(f"coarse run missed +24\": {got}")
    warm = {"auto": [], "pallas": []}
    for mode in ROUTING_ORDER:
        warm[mode].append(run(mode)[1])
    # the hybrid picker on these lags, as "auto" ran it before the decline
    # above skipped it
    (coeffs, *_), kw = calls[0]
    pick_ms, hyb = host_ms(lambda: tile_fft.pick_tile_shape_hybrid(
        coeffs, kw["h"], kw["w"], kw["scale_det_per_grid"],
        order_hint=kw["order"], compute_dtype=kw["compute_dtype"],
        vs_k2=True))
    log(f"[coarse] {N}^2 grid, {CARR_LAGS}^2 at {COARSE_STEP}\", auto -> K2: "
        f"argmax {got:+.1f}\" / {l1[mi[1]] * 3600.0:+.1f}\", engine call "
        f"first {t_first:.3f} s; warm in the order "
        f"{'/'.join(ROUTING_ORDER)}: auto "
        + " / ".join(f"{t:.3f}" for t in warm["auto"]) + " s, pallas (K2) "
        + " / ".join(f"{t:.3f}" for t in warm["pallas"]) + " s; hybrid "
        f"picker (vs_k2) on these lags {pick_ms:.1f} ms, best of 3 (picked "
        f"{'none' if hyb is None else hyb[0]})")
    log_stages("coarse", run)
    return {**warm, "hybrid_pick_ms": pick_ms}


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
# slice I: the Carrington tile-FFT evaluator and its hybrid ("tile_fft"),
# the transform framework
# ---------------------------------------------------------------------------

TILEFFT_BATCHES = (1, 2, 4, 8)   # tile_batch values timed on I1's operands
TILEFFT_PEAK_TOL = 1e-3          # I1's peak against slice C's K2 peak
TILEFFT_SURFACE_TOL = 2e-3       # I1 against K2 over the whole hypercube
TILEFFT_GROUP_RTOL = 1e-6        # I3: grouped against single pass


def tile_fft_leg(lines):
    """The select path's tile-FFT leg as the engine logged it."""
    legs = [m for m in lines if m.startswith("carrington select:")
            or m.startswith("carrington tile-FFT gate failed")]
    if any(m.startswith("carrington select: tile-FFT surfaces")
           for m in legs) and len(legs) == 1:
        return "whole set", legs
    if any("hybrid tile-FFT" in m for m in legs):
        return "hybrid", legs
    return "K2", legs


def tile_fft_stage_times(args, kwargs):
    """CUDA-event times (ms) of the evaluator's device stages on the
    operands of one engine call, its plan replayed stage by stage: the field
    build (g and r fields, padded r frame), stage 1 per tile batch
    (forward transforms, conjugate products, inverse cropped to the boxes)
    and stage 2 (the per-lag readout).  Also the bytes each stage must move
    (each input read once, each output written once) and, where
    torch.profiler sees the card, its kernel launches."""
    import torch

    from euispice_coreg_tpu_torch.engine import tile_fft

    coeffs, warped, ref = args
    order, h, w = kwargs["order"], kwargs["h"], kwargs["w"]
    score = "pearson" if kwargs["method"] == "correlation" else "residus"
    dt = warped.dtype
    item = dt.itemsize
    plan = tile_fft.plan_tiles(coeffs, order=order, h=h, w=w,
                               scale_det_per_grid=kwargs["scale_det_per_grid"],
                               compute_dtype=dt, device=warped.device)
    n_surf, n_rf = tile_fft._plane_counts(order)
    n_g = 3 if score == "pearson" else 6
    coeffs_d = torch.as_tensor(coeffs, dtype=dt, device=warped.device)
    o_tab_d = torch.as_tensor(plan.o_tab, device=warped.device)
    ids = list(range(plan.n_tiles))
    ids_d = torch.as_tensor(ids, device=warped.device)
    chunks = [ids[i:i + plan.batch] for i in range(0, len(ids), plan.batch)]

    def fields():
        g, r = tile_fft._build_fields(warped, ref, order, score, plan.hp,
                                      plan.wp)
        return g, tile_fft._pad_r(r, plan.o_min, plan.o_max, plan.hp,
                                  plan.wp)

    g, r_pad = fields()
    S = tile_fft._tiles_surfaces(g, r_pad, plan, ids, order, score)
    steps = {}

    def stage1():
        marks = []
        for c in chunks:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            G, R = tile_fft._tile_spectra(g, r_pad, plan, c)
            ev[1].record()
            P = tile_fft._products(G, R, order, score)
            ev[2].record()
            tile_fft._inverse(P, plan.my, plan.mx, plan.by, plan.bx) \
                .contiguous()
            ev[3].record()
            marks.append(ev)
        torch.cuda.synchronize()
        for k, name in enumerate(("forward", "products", "inverse")):
            steps[name] = sum(e[k].elapsed_time(e[k + 1]) for e in marks)

    stage1()   # warm-up (cuFFT plans)
    stage1()
    ms = {"field build": cuda_ms(fields), **steps,
          "stage 2": cuda_ms(lambda: tile_fft._combine_lags(
              S, coeffs_d, o_tab_d, ids_d, order, plan))}
    K = plan.mx // 2 + 1
    tiles = plan.n_tiles
    spec = tiles * (n_g + n_rf) * plan.my * K * 2 * item
    prod = tiles * n_surf * plan.my * K * 2 * item
    boxes = tiles * n_surf * plan.by * plan.bx * item
    nbytes = {
        "field build": (2 * h * w + n_g * plan.hp * plan.wp) * item
        + r_pad.numel() * item,
        "forward": tiles * (n_g * plan.th * plan.tw + n_rf * (
            plan.th + plan.by - 1) * (plan.tw + plan.bx - 1)) * item + spec,
        "products": spec + prod,
        "inverse": prod + boxes,
        "stage 2": boxes + coeffs_d.numel() * item + coeffs.shape[0] * 6 * item,
    }
    launches = {}
    try:
        from torch.profiler import ProfilerActivity, profile

        calls = {"field build": fields,
                 "forward": lambda: [tile_fft._tile_spectra(g, r_pad, plan, c)
                                     for c in chunks],
                 "stage 2": lambda: tile_fft._combine_lags(
                     S, coeffs_d, o_tab_d, ids_d, order, plan)}
        G, R = tile_fft._tile_spectra(g, r_pad, plan, chunks[0])
        P = tile_fft._products(G, R, order, score)
        calls["products"] = lambda: [tile_fft._products(G, R, order, score)
                                     for _ in chunks]
        calls["inverse"] = lambda: [tile_fft._inverse(
            P, plan.my, plan.mx, plan.by, plan.bx).contiguous()
            for _ in chunks]
        for name, fn in calls.items():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            n = sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
            launches[name] = n if n else "not measured"
    except Exception as err:  # the profiler is optional here
        log(f"[slice I] torch.profiler gave no kernel counts: {err!r}")
    for name in ms:
        log(f"[slice I] stage {name}: {ms[name]:.3f} ms, "
            f"{nbytes[name] / 1e9:.3f} GB moved "
            f"({nbytes[name] / (ms[name] * 1e-3) / 1e12:.2f} TB/s), "
            f"launches {launches.get(name, 'not measured')}")
    stage1_ms = steps["forward"] + steps["products"] + steps["inverse"]
    elems = tiles * (n_surf + n_rf + 3) * plan.my * plan.mx
    log(f"[slice I] stage 1 {stage1_ms:.3f} ms for {elems:.4e} plane "
        f"elements: {elems / (stage1_ms * 1e-3):.4e} elements/s "
        f"(tile_fft._EST_STAGE1_ELEMS_PER_S "
        f"{tile_fft._EST_STAGE1_ELEMS_PER_S:.4e}); resident r stack "
        f"{r_pad.numel() * item / 1e9:.3f} GB + boxes {boxes / 1e9:.3f} GB")
    del S, g, r_pad
    return plan, ms, nbytes, launches


def phase_slice_i(p_large, p_small, k2_corr, k2_stages, k2_kernel_ms,
                  engine_log):
    """I1: align_using_carrington("fa") under lag_search_mode="tile_fft" on
    slice C's pair and grid: the whole lag set on tile-FFT surfaces, +8"
    within 1" (argmax and fit), argmax equal to slice C's K2 hypercube and
    the peak within TILEFFT_PEAK_TOL, float32 and float64; the stage clocks
    and the device stages; tile_batch timed; peak memory.  I3: the same
    operands under a budget that forces two groups.  Returns the numbers
    the auto decision and PERF.md read."""
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch.engine import carrington as carr
    from euispice_coreg_tpu_torch.engine import quad_score, tile_fft

    def run(dtype="float32", return_type="AlignmentResults"):
        from euispice_coreg_tpu_torch import Alignment

        lag = (np.arange(CARR_LAGS) - CARR_LAGS // 2) * CARR_STEP
        A = Alignment(p_large, p_small, lag_crval1=lag, lag_crval2=lag,
                      small_fov_window=0, large_fov_window=0,
                      lag_search_mode="tile_fft", compute_dtype=dtype,
                      device=DEVICE)
        out = A.align_using_carrington(reference_date=CARR_DATE,
                                       return_type=return_type, **CARR_GRID)
        torch.cuda.synchronize()
        return lag, out

    engine_log.lines.clear()
    quad_score.LAUNCHES = 0
    t0 = time.perf_counter()
    with record_calls(tile_fft, "evaluate_select_tile_fft") as calls:
        lag, res = run()
    t_first = time.perf_counter() - t0
    leg, legs = tile_fft_leg(engine_log.lines)
    plan_line = [m for m in engine_log.lines if m.startswith("tile-FFT plan")]
    if leg != "whole set" or quad_score.LAUNCHES or len(calls) != 1:
        raise AssertionError(f"I1 did not run the whole-set tile-FFT leg: "
                             f"{legs}, K2 launches {quad_score.LAUNCHES}")
    rec = check_recovery("I1", lag, res, TRUE_SHIFT, 1.0)
    corr = res.corr[..., 0]
    mi, mi_k2 = (np.unravel_index(np.nanargmax(c), c.shape)
                 for c in (corr, k2_corr[..., 0]))
    d_peak = abs(float(np.nanmax(corr)) - float(np.nanmax(k2_corr)))
    d_max = float(np.nanmax(np.abs(corr - k2_corr[..., 0])))
    log(f"[slice I] I1 {N}^2 -> {N}^2 Carrington grid, {CARR_LAGS}^2 at "
        f"{CARR_STEP}\", tile_fft: {legs[0]!r}; {plan_line[0]}; {rec}; "
        f"argmax {mi[:2]} vs K2 {mi_k2[:2]}, peak |d| {d_peak:.3e} (tol "
        f"{TILEFFT_PEAK_TOL:g}), max |d| over the hypercube {d_max:.3e} (tol "
        f"{TILEFFT_SURFACE_TOL:g}); K2 launches {quad_score.LAUNCHES}")
    if mi != mi_k2 or d_peak > TILEFFT_PEAK_TOL or d_max > TILEFFT_SURFACE_TOL:
        raise AssertionError("I1 disagrees with slice C's K2 hypercube")
    t0 = time.perf_counter()
    run(return_type="corr")
    t_warm = time.perf_counter() - t0
    stages = log_stages("slice I1", lambda: run(return_type="corr"))
    lag64, res64 = run("float64")
    rec64 = check_recovery("I1 float64", lag64, res64, TRUE_SHIFT, 1.0)
    same = (np.unravel_index(np.nanargmax(res64.corr), res64.corr.shape)
            == np.unravel_index(np.nanargmax(res.corr), res.corr.shape))
    log(f"[slice I] I1 API first {t_first:.3f} s, warm {t_warm:.3f} s; "
        f"top-2 margin float32 {top2_margin(corr):.6e}, float64 "
        f"{top2_margin(res64.corr):.6e} ({rec64}), argmax equal {same}, "
        f"max |d| f32-f64 "
        f"{float(np.nanmax(np.abs(res64.corr - res.corr))):.3e}; K2 (slice "
        f"C) top-2 margin {top2_margin(k2_corr):.6e}")
    if not same:
        raise AssertionError("I1: float32 and float64 argmax differ")

    args, kwargs = calls[0]
    plan, stage_ms, stage_bytes, stage_launches = tile_fft_stage_times(
        args, kwargs)

    def evaluate(**kw):
        return tile_fft.evaluate_select_tile_fft(*args, **{**kwargs, **kw})

    batch_ms = {}
    for b in TILEFFT_BATCHES:
        batch_ms[b] = cuda_ms(lambda b=b: evaluate(tile_batch=b), repeat=3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    r_single = evaluate()
    peak = torch.cuda.max_memory_allocated() - base
    log(f"[slice I] evaluator ms by tile_batch "
        + ", ".join(f"{b}: {v:.3f}" for b, v in batch_ms.items())
        + f" (default {tile_fft.TILE_BATCH}); peak device memory above the "
        f"operands {peak / 1e9:.3f} GB (budget "
        f"{tile_fft.MEM_BUDGET_BYTES / 1e9:.1f} GB)")

    # I3: a budget that holds the r stack and half the tiles' boxes
    n_surf, n_rf = tile_fft._plane_counts(kwargs["order"])
    item = args[1].dtype.itemsize
    rpad = n_rf * (plan.hp + int(plan.o_max[1] - plan.o_min[1])) \
        * (plan.wp + int(plan.o_max[0] - plan.o_min[0])) * item
    bt = n_surf * plan.by * plan.bx * item
    budget = rpad + max(1, plan.n_tiles // 2) * bt + 1
    engine_log.lines.clear()
    r_grouped = evaluate(mem_budget_bytes=budget)
    groups = [m for m in engine_log.lines if m.startswith("tile-FFT plan")]
    rel = float(np.nanmax(np.abs(r_grouped - r_single))
                / np.nanmax(np.abs(r_single)))
    rel_api = float(np.nanmax(np.abs(r_grouped - corr.ravel()))
                    / np.nanmax(np.abs(r_single)))
    log(f"[slice I] I3 budget {budget / 1e9:.3f} GB: {groups[0]}; grouped "
        f"vs single pass {rel:.3e}, vs I1's hypercube {rel_api:.3e} relative "
        f"(tol {TILEFFT_GROUP_RTOL:g})")
    if ((plan.n_tiles > 1 and "1 group(s)" in groups[0])
            or max(rel, rel_api) > TILEFFT_GROUP_RTOL):
        raise AssertionError("I3: the grouped evaluation disagrees or did not "
                             "group")

    tile_s = stages["carr_tilefft_select_s"]
    stage1_ms = sum(stage_ms[k] for k in ("forward", "products", "inverse"))
    k2_s = k2_stages["k2_s"]
    gate_eval = sum(stages.get(k, 0.0) for k in (
        "carr_tilefft_gate_s", "carr_tilefft_hostprep_s",
        "carr_tilefft_eval_s"))
    log(f"[slice I] auto decision: tile-FFT select evaluation (gate + "
        f"evaluation) {tile_s * 1e3:.1f} ms (stages {gate_eval * 1e3:.1f} "
        f"ms) vs K2 select evaluation {k2_s * 1e3:.1f} ms on slice C's grid "
        f"-> tile-FFT {'faster' if tile_s < k2_s else 'slower'}; "
        f"carrington._tile_fft_mode('auto', cuda) = "
        f"{carr._tile_fft_mode('auto', torch.device(DEVICE))!r}; "
        f"K2 kernel {k2_kernel_ms:.3f} ms at {CARR_LAGS ** 2} lags = "
        f"{k2_kernel_ms * 1e-3 / CARR_LAGS ** 2:.3e} s a lag at {N}^2 "
        f"(tile_fft._EST_PALLAS_S_PER_LAG "
        f"{tile_fft._EST_PALLAS_S_PER_LAG:.3e}); "
        f"select minus stage 1 {tile_s * 1e3 - stage1_ms:.1f} ms "
        f"(_EST_SELECT_OVERHEAD_S {tile_fft._EST_SELECT_OVERHEAD_S})")
    return {"first_s": t_first, "warm_s": t_warm, "tile_s": tile_s,
            "k2_s": k2_s, "stages": stage_ms, "bytes": stage_bytes,
            "launches": stage_launches, "batch_ms": batch_ms, "peak": peak}


def phase_slice_i_coarse(engine_log):
    """I2: the coarse grid (121x121 at 2", +24" injected) at engine level
    under "tile_fft": prints which leg ran (whole set, hybrid with its lag
    counts, or K2) and recovers +24" within 3"."""
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
            rate_wave="171", order=2, device=DEVICE, lag_mode="tile_fft")
        torch.cuda.synchronize()
        return out

    engine_log.lines.clear()
    t0 = time.perf_counter()
    corr = run()
    t_first = time.perf_counter() - t0
    leg, legs = tile_fft_leg(engine_log.lines)
    notes = [m for m in engine_log.lines if "screen" in m
             or m.startswith("tile-FFT declined")
             or m.startswith("tile-FFT plan")]
    mi = np.unravel_index(np.nanargmax(corr), corr.shape)
    got = l1[mi[0]] * 3600.0
    log(f"[slice I] I2 coarse {CARR_LAGS}^2 at {COARSE_STEP}\", tile_fft: "
        f"leg {leg} {legs}; {notes[:3]}; argmax {got:+.1f}\" / "
        f"{l1[mi[1]] * 3600.0:+.1f}\", engine call first {t_first:.3f} s")
    if abs(got - 24.0) >= 3.0:
        raise AssertionError(f"I2 missed +24\": {got}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    log_stages("slice I2", run)
    log(f"[slice I] I2 warm (the stage run) {time.perf_counter() - t0:.3f} "
        f"s, peak device memory above the operands "
        f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f} GB")
    return leg


def phase_slice_i_transforms(p_small):
    """I4: CarringtonTransform + Rectifier take slice C's small image onto
    its 2048^2 grid, float64 on the card, against
    carrington.reproject_to_carrington on the same device: pixel
    coordinates (host numpy, torch on the card, the engine's device
    projection) within 1e-9 px, sampled images within 1e-6."""
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch.core import transforms
    from euispice_coreg_tpu_torch.engine import carrington as carr
    from euispice_coreg_tpu_torch.io import fits
    from euispice_coreg_tpu_torch.utils import timeutils

    hdu = fits.open(p_small)[0]
    data, hdr = np.asarray(hdu.data, dtype=np.float64), hdu.header
    lonlims, latlims, shape = (CARR_GRID["lonlims"], CARR_GRID["latlims"],
                               CARR_GRID["shape"])
    t = transforms.CarringtonTransform(hdr, radius_correction=1.004,
                                       reference_date=CARR_DATE,
                                       rate_wave="171")
    rect = transforms.Rectifier(t)
    t0 = time.perf_counter()
    host = rect.coordinates(shape, lonlims, latlims)
    t_host = time.perf_counter() - t0
    lon, lat = (torch.as_tensor(a, device=DEVICE) for a in rect._coords)
    on_card = t(lon, lat, xp=torch)
    sc = carr.header_spherical_scalars(hdr, 1.004)

    def s(v):
        return torch.tensor(float(v), dtype=torch.float64, device=DEVICE)

    delta = timeutils.time_diff_days(str(hdr["DATE-OBS"]), CARR_DATE)
    lon_rot = lon - carr.diff_rot_shift_deg(lat, s(delta), "171", xp=torch)
    geo = carr.observer_geometry(lon_rot, lat, s(sc["obs_lon"]),
                                 s(sc["obs_lat"]), xp=torch)
    x0, y0 = carr._pixel_origin(sc["crval1_arcsec"], sc["crval2_arcsec"],
                                sc["crpix1"], sc["crpix2"], sc["roll"],
                                sc["cdelt1_arcsec"], sc["cdelt2_arcsec"],
                                xp=np)
    engine = carr.spherical_project(*geo, *(s(v) for v in (
        sc["dist"], sc["roll"], x0, y0, sc["cdelt1_arcsec"],
        sc["cdelt2_arcsec"])))
    d_card = d_engine = 0.0
    for a, b, c in zip(host, on_card, engine):
        b, c = b.cpu().numpy(), c.cpu().numpy()
        if not (np.array_equal(np.isnan(a), np.isnan(b))
                and np.array_equal(np.isnan(a), np.isnan(c))):
            raise AssertionError("I4: NaN patterns of the coordinates differ")
        d_card = max(d_card, float(np.nanmax(np.abs(a - b))))
        d_engine = max(d_engine, float(np.nanmax(np.abs(a - c))))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = rect(data, shape, lonlims, latlims, order=2, dtype=np.float64,
               device=DEVICE)
    t_rect = time.perf_counter() - t0
    want = carr.reproject_to_carrington(
        data, hdr, lonlims, latlims, shape, d_solar_r=1.004,
        reference_date=CARR_DATE, rate_wave="171", order=2, device=DEVICE,
        compute_dtype="float64")
    same_nan = np.array_equal(np.isnan(got), np.isnan(want))
    d_img = float(np.nanmax(np.abs(got - want)))
    log(f"[slice I] I4 transforms {shape[0]}x{shape[1]}: coordinates host "
        f"vs card (xp=torch) {d_card:.3e} px, host vs the engine's "
        f"projection {d_engine:.3e} px (tol 1e-9); Rectifier vs "
        f"reproject_to_carrington {d_img:.3e} (tol 1e-6), NaN pattern equal "
        f"{same_nan}; host coordinates {t_host:.3f} s, Rectifier call "
        f"{t_rect:.3f} s")
    if max(d_card, d_engine) > 1e-9 or d_img > 1e-6 or not same_nan:
        raise AssertionError("I4: the transform framework disagrees with "
                             "the Carrington engine")


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
    """auto on 11907 candidates (the router sends them to K1), the same grid
    under "fast" (27 combos on the block path) and under "pallas" (K1, the
    same hypercube as auto's bit for bit), and 75 combos on the block
    path beside the router's estimates."""
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch import Alignment
    from euispice_coreg_tpu_torch.engine import lag_search, warp_score

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

    def timed_runs(n_cdelt, mode, want_lines, label):
        engine_log.lines.clear()
        t0 = time.perf_counter()
        lag, res = run(n_cdelt, mode)
        t_first = time.perf_counter() - t0
        mi = check(label, lag, res, want_lines)
        route = [line for line in engine_log.lines
                 if line.startswith("auto route:")]
        t0 = time.perf_counter()
        run(n_cdelt, mode, "corr")
        return lag, res, mi, t_first, time.perf_counter() - t0, route

    k1_lines = ("auto route: K1 est", "engine path: K1 fused warp+score")
    block_lines = ("engine path: FFT block fast (mixed grid)",)

    # auto: the router sends the 27 combos to K1
    warp_score.LAUNCHES = 0
    lag, res, mi, t_first, t_warm, route = timed_runs(3, "auto", k1_lines,
                                                      "slice D auto")
    if not route or not route[0].endswith("-> pallas"):
        raise AssertionError(f"slice D auto did not route to K1: {route}")
    n_cand = res.corr[..., 0].size
    log(f"[slice D] {N}^2, {n_cand} candidates (27 combos), auto: K1 "
        f"({warp_score.LAUNCHES} launch(es) over two calls), central argmax "
        f"{lag[mi[0]]:+.1f}\" / {lag[mi[1]]:+.1f}\", fit "
        f"{res.shift_arcsec[0]:+.3f}\" / {res.shift_arcsec[1]:+.3f}\"; API "
        f"call first {t_first:.3f} s, warm {t_warm:.3f} s; {route[0]}")
    log_stages("slice D auto", lambda: run(3, "auto", "corr"))

    # the block path, kept on the card under "fast"
    _, res_blk, mi_blk, b_first, b_warm, _ = timed_runs(
        3, "fast", block_lines, "slice D fast")
    log(f"[slice D] same grid, fast: block path (27 combos), central argmax "
        f"{lag[mi_blk[0]]:+.1f}\" / {lag[mi_blk[1]]:+.1f}\", fit "
        f"{res_blk.shift_arcsec[0]:+.3f}\"; API call first {b_first:.3f} s, "
        f"warm {b_warm:.3f} s")
    log_stages("slice D", lambda: run(3, "fast", "corr"))

    warp_score.LAUNCHES = 0
    t0 = time.perf_counter()
    _, res_k1 = run(3, "pallas")
    t_k1 = time.perf_counter() - t0
    if warp_score.LAUNCHES <= 0:
        raise AssertionError("slice D pallas did not launch K1")
    mi_k1 = central_argmax(res_k1.corr)
    arg5 = np.unravel_index(np.nanargmax(res_blk.corr[..., 0]),
                            res_blk.corr.shape[:5])
    arg5_k1 = np.unravel_index(np.nanargmax(res_k1.corr[..., 0]),
                               res_k1.corr.shape[:5])
    dcorr = float(np.nanmax(np.abs(res_blk.corr - res_k1.corr)))
    same = np.array_equal(res.corr, res_k1.corr, equal_nan=True)
    log(f"[slice D] same grid, pallas (K1, {warp_score.LAUNCHES} launch(es)):"
        f" central argmax {lag[mi_k1[0]]:+.1f}\" / {lag[mi_k1[1]]:+.1f}\"; "
        f"5-D argmax block {tuple(int(i) for i in arg5)}, K1 "
        f"{tuple(int(i) for i in arg5_k1)}; max |dcorr| block vs K1 "
        f"{dcorr:.3e}; auto's hypercube equal to pallas's bit for bit "
        f"{same}; API call {t_k1:.3f} s")
    if tuple(mi_k1) != tuple(mi_blk) or tuple(mi_k1) != tuple(mi):
        raise AssertionError(f"slice D: block central argmax {mi_blk}, K1 "
                             f"{mi_k1}, auto {mi}")
    if not same:
        raise AssertionError("slice D: auto's hypercube differs from "
                             "pallas's")

    engine_log.lines.clear()
    t0 = time.perf_counter()
    lag, res75 = run(5, "fast")
    t_75 = time.perf_counter() - t0
    mi = check("slice D 75 combos", lag, res75, block_lines)
    est_k1, est_blk = lag_search.estimate_mixed_grid_seconds(
        MIXED_LAGS ** 2, 75, N, N, order=2, method="correlation")
    log(f"[slice D] {N}^2, {res75.corr[..., 0].size} candidates (75 combos),"
        f" fast: block path, central argmax {lag[mi[0]]:+.1f}\" / "
        f"{lag[mi[1]]:+.1f}\", fit {res75.shift_arcsec[0]:+.3f}\"; API call "
        f"{t_75:.3f} s ({t_75 / 75 * 1e3:.1f} ms a combo, against "
        f"{b_warm / 27 * 1e3:.1f} at 27 combos); the router's estimates: "
        f"K1 {est_k1:.3f} s, block {est_blk:.3f} s")


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
    legs = sorted({m for m in engine_log.lines
                   if m.startswith("carrington select:")})
    anchor = np.array(read_crval(c_paths[0]))
    crvals = np.array([read_crval(os.path.join(out, f"carr_movie_{k}.fits"))
                       for k in range(len(c_paths))])
    err = float(np.max(np.abs(crvals - anchor)))
    log(f"[slice E] jitter_correction_imagers carrington, 3 frames on a "
        f"{CARR_N}^2 Carrington grid, 41x41 lags at 0.5\": engine "
        f"{paths_run} {legs}, K2 {k2_launches} launch(es), worst |corrected "
        f"- anchor| {err:.3f}\" (tol 1\"), {t_carr * 1e3:.1f} ms per "
        f"aligned frame")
    # the select path scores on tile-FFT surfaces ("auto" on a card) or K2
    k2_ran = any("K2" in m for m in legs)
    select = paths_run == ["engine path: carrington linearized select"]
    if (len(paths_run) != 1 or not err < 1.0 or k2_ran != (k2_launches > 0)
            or select != bool(legs)):
        raise AssertionError(f"slice E Carrington jitter: {paths_run}, "
                             f"{legs}, K2 {k2_launches} launch(es), {err}")


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
    # the rotation fleet against a direct float64 sliding window
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
        f"r {r_true:.9f}, rotation fleet vs direct float64 at 3 "
        f"offsets {max(errs):.2e} (tol 1e-6); find_best_parameters (FITS "
        f"load included) {times[0]:.3f} s first, {times[1]:.3f} s second")
    if best != (dx, dy, 0.0) or abs(r_true - 1.0) > 1e-6 \
            or not max(errs) <= 1e-6:
        raise AssertionError(f"slice F: argmax {best}, r {r_true}, "
                             f"direct {errs}")


# ---------------------------------------------------------------------------
# phase 10: slice G, SPICE (synthetic raster, AlignmentSpice, iterative)
# ---------------------------------------------------------------------------

SPICE_SHAPE = (192, 1024, 48)  # raster steps, detector rows, spectral pixels
SPICE_CDELT = (4.0, 1.098)     # arcsec at SPICE_SHAPE (the FOV is kept)
SPICE_STEP_S = 60.0            # seconds a raster step (PC4_1)
SPICE_CRVAL = (120.0, 80.0)    # true pointing, arcsec
SPICE_SHIFT = (8.0, -4.0)      # the lag that corrects the handed-over CRVAL
SPICE_TOL = (2.0, 1.0)         # half a raster step, 1 arcsec
SPICE_BEG = "2022-03-17T09:00:00.000"
IMAGER_FRAMES = 20             # HRIEUV-like frames at N^2 ...
IMAGER_CADENCE = 600.0         # ... this many seconds apart
SPICE_LAGS = 41                # CRVAL lags per axis at 1" (G2, G4)
SPICE_CARR_N = 1024            # Carrington grid of G4
ITER_LAGS, ITER_CHUNK = 11, 64  # G5: 11x11 CRVAL at 1" x 3 CROTA
# G1: the raster against the analytic scene (the order-2 spline smooths
# the blobs by ~(pixel / width)^2 / 8, under 1e-5 at 0.492" pixels)
SYNRAS_TOL = 1e-4


@contextlib.contextmanager
def record_calls(module, name):
    """Within the block, ``module.name`` records the arguments of every call
    (the call itself goes through unchanged); yields the list of
    ``(args, kwargs)``."""
    fn = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def spice_scene(lon, lat):
    """300 Gaussian blobs (11-36" wide) over +-540": structure across the
    whole raster at the SPICE pixel scale.  ``lon``/``lat``: float64
    tensors in degrees."""
    import numpy as np
    import torch

    out = torch.full_like(lon, 100.0)
    rng = np.random.default_rng(17)
    for _ in range(300):
        cx, cy = rng.uniform(-0.15, 0.15, size=2)
        w = rng.uniform(0.003, 0.01)
        out += rng.uniform(0.5, 3.0) * torch.exp(
            -((lon - cx) ** 2 + (lat - cy) ** 2) / (2 * w * w))
    return out


CARR_KEYS = {"DSUN_OBS": 0.5 * 1.496e11, "CRLN_OBS": 120.0,
             "CRLT_OBS": 3.0, "RSUN_REF": 6.957e8, "SOLAR_B0": 3.0}


def spice_header(crval):
    """The 4-D SPICE L2 header (x, y, WAVE, UTC; time coupled to x through
    PC4_1) at ``crval`` (arcsec), with the Carrington keys."""
    from euispice_coreg_tpu_torch.core.header import Header
    from euispice_coreg_tpu_torch.utils import timeutils

    nx, ny, nl = SPICE_SHAPE
    c1 = SPICE_CDELT[0] * 192 / nx
    c2 = SPICE_CDELT[1] * 1024 / ny
    t_mid = timeutils.parse_fits_time(SPICE_BEG) + SPICE_STEP_S * nx / 2
    return Header({
        "NAXIS": 4, "NAXIS1": nx, "NAXIS2": ny, "NAXIS3": nl, "NAXIS4": 1,
        "CTYPE1": "HPLN-TAN", "CTYPE2": "HPLT-TAN", "CTYPE3": "WAVE",
        "CTYPE4": "UTC", "CUNIT1": "deg", "CUNIT2": "deg", "CUNIT3": "nm",
        "CUNIT4": "s", "CRVAL1": crval[0] / 3600.0,
        "CRVAL2": crval[1] / 3600.0, "CRVAL3": 77.0,
        "CRVAL4": SPICE_STEP_S * nx / 2, "CRPIX1": (nx + 1) / 2,
        "CRPIX2": (ny + 1) / 2, "CRPIX3": (nl + 1) / 2, "CRPIX4": 1.0,
        "CDELT1": c1 / 3600.0, "CDELT2": c2 / 3600.0, "CDELT3": 0.0025,
        "CDELT4": 1.0, "PC1_1": 1.0, "PC2_2": 1.0, "PC3_3": 1.0,
        "PC4_4": 1.0, "PC4_1": SPICE_STEP_S, "CROTA": 0.0,
        "NBIN2": 1024 // ny, "DETECTOR": "SW", "PXBEG2": 1,
        "DATEREF": SPICE_BEG, "DATE-BEG": SPICE_BEG, "DATE-OBS": SPICE_BEG,
        "DATE-AVG": timeutils.format_fits_time(t_mid), "LEVEL": "L2",
        **CARR_KEYS,
    })


def spice_world(hdr_spatial):
    """World grid (deg, float64 tensors on the card) of a 2-D header."""
    import torch

    from euispice_coreg_tpu_torch.core.header import wcs_params_from_header
    from euispice_coreg_tpu_torch.engine import lag_search

    p = wcs_params_from_header(hdr_spatial)
    return lag_search.compute_world_grid(
        p.as_dict(), int(hdr_spatial["NAXIS2"]), int(hdr_spatial["NAXIS1"]),
        p.kind, True, device=DEVICE, compute_dtype=torch.float64)


def write_spice_inputs(tmp_dir):
    """The L2 cube (the scene through the true pointing, a Gaussian line
    over the spectral pixels) written with the handed-over header, and the
    imager frames (one rendering, DATE-AVG 600 s apart, the first 300 s
    after the raster starts)."""
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch.core.header import Header
    from euispice_coreg_tpu_torch.hdrshift.alignment_spice import \
        spatial_header_from_spice_l2
    from euispice_coreg_tpu_torch.io import fits
    from euispice_coreg_tpu_torch.utils import timeutils

    nx, ny, nl = SPICE_SHAPE
    hdr_true = spice_header(SPICE_CRVAL)
    lon, lat = spice_world(spatial_header_from_spice_l2(hdr_true, nx, ny))
    k = torch.arange(nl, dtype=torch.float64, device=DEVICE)
    line = torch.exp(-0.5 * ((k - (nl - 1) / 2) / (nl / 8)) ** 2)
    cube = spice_scene(lon, lat)[None] * (line / line.sum())[:, None, None]
    hdr_given = spice_header((SPICE_CRVAL[0] - SPICE_SHIFT[0],
                              SPICE_CRVAL[1] - SPICE_SHIFT[1]))
    p_spice = os.path.join(tmp_dir, "solo_L2_spice-n-ras_g.fits")
    fits.write(p_spice, [fits.PrimaryHDU(
        data=cube[None].float().cpu().numpy(), header=hdr_given)])

    cdelt = CDELT_ARCSEC * 2048 / N
    hdr = Header({
        "NAXIS1": N, "NAXIS2": N, "CRVAL1": 0.0, "CRVAL2": 0.0,
        "CRPIX1": (N + 1) / 2, "CRPIX2": (N + 1) / 2, "CDELT1": cdelt,
        "CDELT2": cdelt, "CUNIT1": "arcsec", "CUNIT2": "arcsec",
        "CTYPE1": "HPLN-TAN", "CTYPE2": "HPLT-TAN", "CROTA": 0.0,
        "WAVELNTH": 174, "DETECTOR": "HRI_EUV", **CARR_KEYS})
    data = spice_scene(*spice_world(hdr)).float().cpu().numpy()
    t0 = timeutils.parse_fits_time(SPICE_BEG) + IMAGER_CADENCE / 2
    paths = []
    for f in range(IMAGER_FRAMES):
        hdr["DATE-AVG"] = timeutils.format_fits_time(t0 + IMAGER_CADENCE * f)
        hdr["DATE-OBS"] = hdr["DATE-AVG"]
        paths.append(os.path.join(tmp_dir, f"solo_L2_eui-hrieuv174_{f}.fits"))
        fits.write(paths[-1], [fits.PrimaryHDU(data=data, header=hdr)])
    return p_spice, paths, hdr_given


def check_spice_recovery(label, lag1, lag2, res):
    """argmax and fit within SPICE_TOL of SPICE_SHIFT on both axes."""
    mi = res.max_index
    got = [(lag1[mi[0]], lag2[mi[1]]), tuple(res.shift_arcsec[:2])]
    for g in got:
        if not all(abs(g[i] - SPICE_SHIFT[i]) < SPICE_TOL[i] for i in (0, 1)):
            raise AssertionError(f"{label} missed {SPICE_SHIFT}: argmax "
                                 f"{got[0]}, fit {got[1]}")
    return (f"argmax {got[0][0]:+.1f}\" / {got[0][1]:+.1f}\", fit "
            f"{got[1][0]:+.3f}\" / {got[1][1]:+.3f}\"")


def spice_carrington_limits(hdr_given):
    """Carrington lon/lat limits (deg) of the raster's slit rows within
    the dumbbells, inset by 5 % a side."""
    import numpy as np

    from euispice_coreg_tpu_torch.engine import carrington as carr
    from euispice_coreg_tpu_torch.hdrshift.alignment_spice import (
        SpiceUtil, spatial_header_from_spice_l2)

    nx, ny, _ = SPICE_SHAPE
    h = spatial_header_from_spice_l2(hdr_given, nx, ny)
    for ax in (1, 2):
        h[f"CRVAL{ax}"] *= 3600.0
        h[f"CDELT{ax}"] *= 3600.0
        h[f"CUNIT{ax}"] = "arcsec"
    h.update({"CROTA": 0.0, **CARR_KEYS})
    ymin, ymax = SpiceUtil.vertical_edges_limits(hdr_given)
    px, py = np.meshgrid(np.arange(nx, dtype=np.float64),
                         np.arange(ymin, ymax, dtype=np.float64))
    lon, lat = carr.spherical_unproject(
        px, py, carr.header_spherical_scalars(h, 1.004))
    out = []
    for v in (lon, lat):
        lo, hi = float(np.nanmin(v)), float(np.nanmax(v))
        out.append((lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo)))
    return out


def phase_slice_g(tmp_dir, engine_log):
    """Slice G (module docstring).  Returns the K1 and K2 timings at G3's and
    G4's operands, each with its launches on that path, and G3's engine
    call under "auto" (``"G3 engine call"``: its arguments) for phase R."""
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch.engine import (lag_search, quad_score,
                                                 warp_score)
    from euispice_coreg_tpu_torch.hdrshift import (
        AlignementSpiceIterativeContextRaster, AlignmentSpice)
    from euispice_coreg_tpu_torch.hdrshift import alignment_spice
    from euispice_coreg_tpu_torch.hdrshift.alignment_spice import \
        spatial_header_from_spice_l2
    from euispice_coreg_tpu_torch.io import fits
    from euispice_coreg_tpu_torch.synras import SPICEComposedMapBuilder
    from euispice_coreg_tpu_torch.synras import map_builder
    from euispice_coreg_tpu_torch.utils import obs

    nx, ny, nl = SPICE_SHAPE
    t0 = time.perf_counter()
    p_spice, paths, hdr_given = write_spice_inputs(tmp_dir)
    log(f"[slice G] inputs: L2 cube {nx}x{ny}x{nl} "
        f"({os.path.getsize(p_spice) / 1e6:.1f} MB), {IMAGER_FRAMES} frames "
        f"of {N}^2, written in {time.perf_counter() - t0:.1f} s")

    # G1: the synthetic raster, first (frames read and moved to the card)
    # and again (frames cached by the builder)
    builder = SPICEComposedMapBuilder(p_spice, paths, threshold_time=600.0,
                                      window_imager=0, window_spectro=0,
                                      device=DEVICE)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_synras = builder.process(tmp_dir, basename_output="synras_g.fits",
                                   print_filename=False,
                                   return_synras_name=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    composed = fits.open(p_synras)[0].data.astype(np.float64)
    lon, lat = spice_world(spatial_header_from_spice_l2(hdr_given, nx, ny))
    want = spice_scene(lon, lat).cpu().numpy()
    ok = np.isfinite(composed)
    err = float(np.max(np.abs(composed[ok] - want[ok]) / want[ok]))
    n_frames = len(np.unique(builder.dates_selected))
    log(f"[slice G1] SPICEComposedMapBuilder.process: {composed.shape} "
        f"raster from {n_frames} frames, finite {ok.mean():.3f}, max "
        f"|raster - scene| / scene {err:.2e} (tol {SYNRAS_TOL:g}); "
        f"{times[0]:.3f} s "
        f"first, {times[1]:.3f} s with the frames cached")
    if not (err <= SYNRAS_TOL and ok.mean() > 0.8 and n_frames == IMAGER_FRAMES):
        raise AssertionError(f"slice G1: raster off the scene ({err}, "
                             f"finite {ok.mean()}, frames {n_frames})")

    lag = (np.arange(SPICE_LAGS) - SPICE_LAGS // 2) * 1.0

    def spice(mode, return_type="AlignmentResults", carrington=None, **lags):
        lags = lags or dict(lag_crval1=lag, lag_crval2=lag)
        A = AlignmentSpice(p_synras, p_spice, large_fov_window=0,
                           small_fov_window=0, lag_search_mode=mode,
                           device=DEVICE, **lags)
        if carrington:
            out = A.align_using_carrington(return_type=return_type,
                                           **carrington)
        else:
            out = A.align_using_helioprojective(return_type=return_type)
        torch.cuda.synchronize()
        return out

    def timed_run(*args, **kwargs):
        t0 = time.perf_counter()
        out = spice(*args, **kwargs)
        return out, time.perf_counter() - t0

    # G2: CRVAL grid, auto -> the FFT path
    engine_log.lines.clear()
    res, t_first = timed_run("auto")
    if "engine path: FFT fast (crval grid)" not in engine_log.lines:
        raise AssertionError(f"slice G2 did not take the FFT path: "
                             f"{engine_log.lines}")
    rec = check_spice_recovery("slice G2", lag, lag, res)
    _, t_warm = timed_run("auto", "corr")
    log(f"[slice G2] AlignmentSpice helioprojective, {SPICE_LAGS}^2 CRVAL at "
        f"1\", auto (FFT path): {rec}; API call first {t_first:.3f} s, warm "
        f"{t_warm:.3f} s")
    log_stages("slice G2", lambda: spice("auto", "corr"))

    # G3: the mixed grid, pallas (K1), auto (routed to K1) and fast (the
    # block path); auto's engine call is kept for phase R
    l21 = (np.arange(21) - 10) * 1.0
    mixed = dict(lag_crval1=l21, lag_crval2=l21,
                 lag_cdelt1=[-0.08, 0.0, 0.08], lag_crota=[-0.2, 0.0, 0.2])
    warp_score.LAUNCHES = 0
    with record_calls(warp_score, "warp_score_sums") as k1_calls:
        res_k1, t_k1 = timed_run("pallas", **mixed)
    k1_launches = warp_score.LAUNCHES
    if k1_launches <= 0:
        raise AssertionError("slice G3 pallas did not launch K1")
    engine_log.lines.clear()
    with record_calls(lag_search, "evaluate_lag_grid") as g3_calls:
        res_auto, t_auto = timed_run("auto", **mixed)
    route = [line for line in engine_log.lines
             if line.startswith("auto route:")]
    if not (route and route[0].endswith("-> pallas")
            and "engine path: K1 fused warp+score kernel" in engine_log.lines):
        raise AssertionError(f"slice G3 auto did not take K1: "
                             f"{engine_log.lines}")
    engine_log.lines.clear()
    res_blk, t_blk = timed_run("fast", **mixed)
    if "engine path: FFT block fast (mixed grid)" not in engine_log.lines:
        raise AssertionError(f"slice G3 fast did not take the block path: "
                             f"{engine_log.lines}")
    n_cand = res_k1.corr[..., 0].size

    def argmax5(res):
        return tuple(int(i) for i in res.max_index[:5])

    rec_k1 = check_spice_recovery("slice G3 pallas", l21, l21, res_k1)
    rec_blk = check_spice_recovery("slice G3 fast", l21, l21, res_blk)
    same = np.array_equal(res_auto.corr, res_k1.corr, equal_nan=True)
    log(f"[slice G3] {n_cand} candidates: pallas (K1, {k1_launches} "
        f"launch(es)) {rec_k1}, 5-D argmax {argmax5(res_k1)}, API call "
        f"{t_k1:.3f} s; auto (K1) API call {t_auto:.3f} s, hypercube equal "
        f"to pallas's bit for bit {same}; {route[0]}; fast (block path) "
        f"{rec_blk}, 5-D argmax {argmax5(res_blk)}, API call {t_blk:.3f} s; "
        f"max |dcorr| "
        f"{float(np.nanmax(np.abs(res_k1.corr - res_blk.corr))):.3e}")
    if tuple(res_k1.max_index[:2]) != tuple(res_blk.max_index[:2]):
        raise AssertionError("slice G3: K1 and the block path disagree on "
                             "the CRVAL argmax")
    if not same:
        raise AssertionError("slice G3: auto's hypercube differs from "
                             "pallas's")

    # G4: Carrington "fa" on K2, a 1024^2 grid over the raster
    lonlims, latlims = spice_carrington_limits(hdr_given)
    carr = dict(lonlims=lonlims, latlims=latlims,
                shape=(SPICE_CARR_N, SPICE_CARR_N))
    engine_log.lines.clear()
    quad_score.LAUNCHES = 0
    with record_calls(quad_score, "quad_score_sums") as k2_calls:
        res, t_first = timed_run("pallas", carrington=carr)
    k2_launches = quad_score.LAUNCHES
    want_lines = ("engine path: carrington linearized select",
                  f"carrington select: K2 quad kernel ({SPICE_LAGS ** 2} "
                  f"lags)")
    if k2_launches <= 0 or not all(m in engine_log.lines for m in want_lines):
        raise AssertionError(f"slice G4 did not run K2 ({k2_launches} "
                             f"launches): {engine_log.lines}")
    rec = check_spice_recovery("slice G4", lag, lag, res)
    _, t_warm = timed_run("pallas", "corr", carrington=carr)
    log(f"[slice G4] AlignmentSpice Carrington fa, {SPICE_CARR_N}^2 grid "
        f"lon {lonlims[0]:.3f}..{lonlims[1]:.3f}, lat {latlims[0]:.3f}.."
        f"{latlims[1]:.3f} deg, {SPICE_LAGS}^2 at 1\", pallas: K2 "
        f"{k2_launches} launch(es), {rec}; API call first {t_first:.3f} s, "
        f"warm {t_warm:.3f} s")
    log_stages("slice G4", lambda: spice("pallas", "corr", carrington=carr))

    # G5: the iterative context raster, batched, around the truth
    l1 = SPICE_SHIFT[0] + (np.arange(ITER_LAGS) - ITER_LAGS // 2) * 1.0
    l2 = SPICE_SHIFT[1] + (np.arange(ITER_LAGS) - ITER_LAGS // 2) * 1.0
    rota = [-0.2, 0.0, 0.2]

    def iterative(lag1, lag2, **kw):
        A = AlignementSpiceIterativeContextRaster(
            paths, p_spice, threshold_time=600.0, lag_crval1=lag1,
            lag_crval2=lag2, lag_crota=rota, large_fov_window=0,
            small_fov_window=0, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = A.align_using_helioprojective(return_type="corr", **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with obs.collect_stages() as st, \
            record_calls(alignment_spice, "_iter_chunk_scores") as scores, \
            record_calls(map_builder, "_sample_frame_all_lags") as samples:
        corr_b, t_b = iterative(l1, l2, lag_chunk=ITER_CHUNK)
    n_lags = corr_b.size
    mi = np.unravel_index(np.nanargmax(corr_b), corr_b.shape)
    best = (l1[mi[0]], l2[mi[1]], rota[mi[4]])
    if not (all(abs(best[i] - SPICE_SHIFT[i]) < SPICE_TOL[i] for i in (0, 1))
            and np.all(np.isfinite(corr_b))):
        raise AssertionError(f"slice G5 missed {SPICE_SHIFT}: {best}")
    pick1, pick2 = [0, ITER_LAGS // 2, ITER_LAGS - 1], [ITER_LAGS // 2 - 1]
    corr_s, t_s = iterative(l1[pick1], l2[pick2], batch_lags=False)
    d_seq = float(np.max(np.abs(corr_s - corr_b[np.ix_(pick1, pick2)])))
    log(f"[slice G5] iterative context raster, {n_lags} lags ({ITER_LAGS}^2 "
        f"CRVAL at 1\" x 3 CROTA), batched in chunks of {ITER_CHUNK}: argmax "
        f"{best[0]:+.1f}\" / {best[1]:+.1f}\" / {best[2]:+.1f} deg; "
        f"{t_b:.3f} s, {t_b / n_lags * 1e3:.2f} ms per lag (frames read "
        f"included; compose {st.get('iter_compose_s', 0.0):.3f} s, score "
        f"{st.get('iter_score_s', 0.0):.3f} s); sequential route on "
        f"{corr_s.size} lags {t_s / corr_s.size * 1e3:.1f} ms per lag, max "
        f"|batched - sequential| {d_seq:.2e} (tol 1e-6)")
    if not d_seq <= 1e-6:
        raise AssertionError(f"slice G5: batched and sequential differ by "
                             f"{d_seq}")

    # the two device functions on G5's first chunk (CUDA events)
    first = scores[0][0][0]  # the chunk's stacked composed-grid params
    frame_calls = [c for c in samples if c[0][0] is samples[0][0][0]]
    ms_compose = cuda_ms(lambda: [map_builder._sample_frame_all_lags(*a)
                                  for a, _ in frame_calls])
    ms_score = cuda_ms(lambda: alignment_spice._iter_chunk_scores(
        *scores[0][0]))
    log(f"[slice G5] device functions on the first chunk "
        f"({int(first['crval1'].shape[0])} lags, {ny}x{nx}): "
        f"_sample_frame_all_lags over its {len(frame_calls)} frames "
        f"{ms_compose:.3f} ms, _iter_chunk_scores {ms_score:.3f} ms")

    # K1 and K2 against their bounds at the operands this slice gave them
    out = {}
    for kid, kernel, mod, fn, calls, launches in (
            ("K1", "K1 tan", warp_score, "warp_score_sums", k1_calls,
             k1_launches),
            ("K2", "K2", quad_score, "quad_score_sums", k2_calls,
             k2_launches)):
        args, kw = calls[0]
        launch = getattr(mod, fn)
        plain = getattr(mod, fn + "_reference")
        ref = args[1]
        shape = "x".join(str(n) for n in ref.shape)
        out[kid] = time_against_bound(
            f"{kid} slice G {shape} x {args[-1].shape[0]} lags", kernel,
            lambda: launch(*args, **kw),
            lambda t: plain(*args[:-1], t, **kw), args,
            int(torch.isfinite(ref).sum()), repeat=3)
        plain_ms = cuda_ms(lambda: plain(*args, **kw), repeat=1)
        log(f"[kernels] {kid} slice G {shape}: plain version {plain_ms:.3f} "
            f"ms")
        out[kid].update(slice="G", launches=launches, plain_ms=plain_ms)
    out["G3 engine call"] = g3_calls[0]
    return out


# ---------------------------------------------------------------------------
# phase R: the "auto" router of mixed grids, K1 against the block path
# ---------------------------------------------------------------------------

ROUTE_CRVAL = (11, 21, 31, 41, 51)  # CRVAL lags per axis at 1", 3 CROTA
ROUTE_MARGIN = 0.25  # a route faster than the other by more must be auto's


def route_grids():
    """Phase R's grids on slice A's pair: (label, Alignment lags in arcsec,
    reprojection order).  The CRVAL1 axis is centred on the injected +8"."""
    import numpy as np

    def lags(n, **combo):
        lag = (np.arange(n) - n // 2) * 1.0
        return dict(lag_crval1=TRUE_SHIFT + lag, lag_crval2=lag, **combo)

    crota = [-0.05, 0.0, 0.05]
    frac = [-0.005 * CDELT_ARCSEC, 0.0, 0.005 * CDELT_ARCSEC]
    n = MIXED_LAGS
    return ([(f"A {k}^2 x 3", lags(k, lag_crota=crota), 2)
             for k in ROUTE_CRVAL]
            + [(f"A {n}^2 x 9", lags(n, lag_cdelt1=frac, lag_crota=crota), 2),
               (f"A {n}^2 x 3, order 0", lags(n, lag_crota=crota), 0)])


def best_of(fn, runs=3):
    """(best seconds over runs 2..``runs``, the last result): host clock
    around work ending in a synchronize; the first run warms."""
    import torch

    best, out = None, None
    for i in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if i:
            best = dt if best is None else min(best, dt)
    return best, out


def fit_route_constants(rows):
    """The router's constants fitted to phase R's times (non-negative least
    squares): K1 t = k0 + rate[order] h w L; the block path t = bL L +
    C (bc + bp P m^2), C combos of P planes of m x m."""
    import numpy as np
    from scipy.optimize import nnls

    k2 = [r for r in rows if r["order"] == 2]
    (k0, rate2), _ = nnls(np.array([[1.0, r["hw"] * r["lags"]] for r in k2]),
                          np.array([r["k1_s"] for r in k2]))
    rate = {2: rate2}
    for order in {r["order"] for r in rows} - {2}:
        rate[order] = float(np.mean([(r["k1_s"] - k0) / (r["hw"] * r["lags"])
                                     for r in rows if r["order"] == order]))
    coef, _ = nnls(np.array([[r["lags"], r["combos"],
                              r["combos"] * r["planes"] * r["m"] ** 2]
                             for r in rows]),
                   np.array([r["blk_s"] for r in rows]))
    return {"k1_s": k0, "k1_s_per_pixel_lag": rate,
            "block_s_per_lag": coef[0], "block_s_per_combo": coef[1],
            "block_s_per_plane_elem": coef[2]}


def route_crossover(c, n_combos, h, w, planes, m, order=2):
    """CRVAL lags per combo where K1's and the block path's estimates meet
    under the constants ``c`` (:func:`fit_route_constants`' keys): K1 is
    the cheaper below, the block path above (inf: K1 at every size)."""
    per_lag = c["k1_s_per_pixel_lag"][order] * h * w - c["block_s_per_lag"]
    fixed = n_combos * (c["block_s_per_combo"]
                        + c["block_s_per_plane_elem"] * planes * m * m) \
        - c["k1_s"]
    if per_lag <= 0:
        return float("inf")
    return max(fixed, 0.0) / (n_combos * per_lag)


def phase_route(p_large, p_small, g3_call, engine_log):
    """Phase R: each grid of :func:`route_grids` and G3's operands, warm
    under "pallas" (K1) and under the block path at the engine, beside the
    router's two estimates and the route "auto" took.  Fails where the
    two routes' CRVAL argmax differ, or where "auto" took the slower route
    and the two differ by more than :data:`ROUTE_MARGIN`.  Prints the
    constants fitted to these times and the crossover they imply."""
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch import Alignment
    from euispice_coreg_tpu_torch.engine import fast_corr, lag_search

    t_phase = time.perf_counter()
    calls = []
    for label, lags, order in route_grids():
        A = Alignment(p_large, p_small, small_fov_window=0,
                      large_fov_window=0, reprojection_order=order,
                      device=DEVICE, **lags)
        engine_log.lines.clear()
        with record_calls(lag_search, "evaluate_lag_grid") as rec:
            A.align_using_helioprojective(return_type="corr")
        calls.append((label, rec[0], list(engine_log.lines)))
    calls.append(("G3", g3_call, []))

    rows = []
    for label, (args, kw), lines in calls:
        small, l1, l2, l3, l4, l5 = args[0], *args[5:10]
        h, w = small.shape
        order, method = kw["order"], kw.get("method", "correlation")
        n_combos = len(l3) * len(l4) * len(l5)
        n_lags = len(l1) * len(l2) * n_combos
        auto = kw["allow_fast"]
        line = [m for m in lines if m.startswith("auto route:")]
        if lines and not (line and line[0].endswith(f"-> {auto}")):
            raise AssertionError(f"phase R {label}: auto's route line does "
                                 f"not name {auto!r}: {lines}")

        def engine(mode):
            engine_log.lines.clear()
            t, cube = best_of(lambda: lag_search.evaluate_lag_grid(
                *args, **dict(kw, allow_fast=mode)))
            want = ("engine path: K1 fused warp+score kernel"
                    if mode == "pallas" else
                    "engine path: FFT block fast (mixed grid)")
            if want not in engine_log.lines:
                raise AssertionError(f"phase R {label} {mode}: no "
                                     f"{want!r}: {engine_log.lines}")
            return t, cube

        t_k1, cube_k1 = engine("pallas")
        t_blk, cube_blk = engine("block")
        centre = tuple(n // 2 for n in cube_k1.shape[2:5])
        arg_k1, arg_blk = (
            np.unravel_index(np.nanargmax(c[(slice(None),) * 2 + centre]),
                             c.shape[:2]) for c in (cube_k1, cube_blk))
        est_k1, est_blk = lag_search.estimate_mixed_grid_seconds(
            len(l1) * len(l2), n_combos, h, w, order=order, method=method)
        faster = "pallas" if t_k1 < t_blk else "block"
        ratio = max(t_k1, t_blk) / min(t_k1, t_blk)
        log(f"[route] {label} ({h}x{w}): {n_lags} lags ({n_combos} combos), K1 "
            f"{t_k1 * 1e3:.1f} ms (est {est_k1 * 1e3:.1f}), block "
            f"{t_blk * 1e3:.1f} ms (est {est_blk * 1e3:.1f}); faster "
            f"{faster} by {ratio:.2f}x, auto -> {auto}; CRVAL argmax K1 "
            f"{tuple(int(i) for i in arg_k1)}, block "
            f"{tuple(int(i) for i in arg_blk)}, max |dcorr| "
            f"{float(np.nanmax(np.abs(cube_k1 - cube_blk))):.2e}")
        if tuple(arg_k1) != tuple(arg_blk):
            raise AssertionError(f"phase R {label}: K1 and the block path "
                                 f"disagree on the CRVAL argmax")
        if auto != faster and ratio > 1.0 + ROUTE_MARGIN:
            raise AssertionError(f"phase R {label}: auto took {auto!r}, "
                                 f"{ratio:.2f}x slower than {faster!r}")
        rows.append(dict(label=label, order=order, hw=h * w, lags=n_lags,
                         combos=n_combos, k1_s=t_k1, blk_s=t_blk,
                         planes=lag_search._block_planes(order, method),
                         m=fast_corr._fft_size(max(h, w) + 4), auto=auto,
                         faster=faster))
        del args, kw, cube_k1, cube_blk

    fit = fit_route_constants(rows)
    used = {"k1_s": lag_search._EST_K1_S,
            "k1_s_per_pixel_lag": lag_search._EST_K1_S_PER_PIXEL_LAG,
            "block_s_per_lag": lag_search._EST_BLOCK_S_PER_LAG,
            "block_s_per_combo": lag_search._EST_BLOCK_S_PER_COMBO,
            "block_s_per_plane_elem": lag_search._EST_BLOCK_S_PER_PLANE_ELEM}
    log("[route] fitted constants: " + ", ".join(
        f"{k} " + (" / ".join(f"order {o} {v:.4g}" for o, v in
                              sorted(fit[k].items()))
                   if isinstance(fit[k], dict) else f"{fit[k]:.4g}")
        for k in fit))
    m = fast_corr._fft_size(N + 4)
    planes = lag_search._block_planes(2, "correlation")
    cross = {}
    for name, c in (("in use", used), ("fitted", fit)):
        cross[name] = {n: route_crossover(c, n, N, N, planes, m)
                       for n in (3, 27)}
        log(f"[route] crossover at {N}^2, order 2 ({name} constants): "
            + ", ".join(f"{n} combos {v:.0f} CRVAL lags a combo "
                        f"({v ** 0.5:.1f}^2)" for n, v in cross[name].items()))
    log(f"[route] phase R {time.perf_counter() - t_phase:.1f} s")
    return {"rows": rows, "fit": fit, "crossover": cross}


# ---------------------------------------------------------------------------
# phase 11: slice H, tile-compressed FITS in and out of the helioprojective
# path
# ---------------------------------------------------------------------------

H_NOISE = 0.05       # photon-noise-like sigma added to slice A's pair
H_COMPRESSION = dict(quantize_level=16.0,
                     quantize_method="SUBTRACTIVE_DITHER_1")
H_HCOMP_ROWS = 16    # HCOMPRESS_1 tiles of 16 rows (cfitsio's default)


def host_ms(fn, repeat=3):
    """Best host milliseconds of ``fn`` over ``repeat`` runs; and its
    result."""
    best, out = None, None
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = fn()
        dt = (time.perf_counter() - t0) * 1e3
        best = dt if best is None else min(best, dt)
    return best, out


def check_within_step(label, got, want, path):
    """``got`` within one quantization step of ``want`` (the step of each
    pixel's tile in ``path``, 0 for a tile stored losslessly), NaN where
    ``want`` is NaN.  Returns the largest error in steps."""
    import numpy as np

    from euispice_coreg_tpu_torch.io import tile_compression

    step = tile_compression.quantization_steps(path, 1)
    nan_ok = np.array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    err = np.abs(got[fin].astype(np.float64) - want[fin])
    q = step[fin] > 0
    worst = float(np.max(err[q] / step[fin][q])) if q.any() else 0.0
    exact = bool(np.all(err[~q] == 0.0))
    log(f"[slice H] {label}: {q.mean() * 100:.1f}% of pixels quantized, "
        f"largest error {worst:.3f} step(s), lossless tiles exact {exact}, "
        f"NaNs where the source has NaNs {nan_ok}")
    if not (worst <= 1.0 and exact and nan_ok):
        raise AssertionError(f"slice H {label}: not within one quantization "
                             f"step of the source")
    return worst


def phase_slice_h(p_large, p_small, tmp_dir, engine_log):
    """Slice A's pair as real EUI files are distributed: tile-compressed
    float32 (RICE_1, quantize level 16, SUBTRACTIVE_DITHER_1, row tiles;
    photon-noise-like sigma H_NOISE added, a dead-pixel block of NaNs in the
    small image), and the small image once more as HCOMPRESS_1.  H1 times
    the port's fits.open of each against the uncompressed file and checks
    each decode within one quantization step; H2 aligns the compressed
    pair under "auto" (FFT path) and "pallas" (K1, slice B's grid), writes
    the correction back compressed and reads it back.  Returns K1's
    launches in the "pallas" run."""
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch import Alignment
    from euispice_coreg_tpu_torch.engine import warp_score
    from euispice_coreg_tpu_torch.io import fits, native
    from euispice_coreg_tpu_torch.utils import obs

    build_ms, _ = host_ms(native._load, repeat=1)
    log(f"[slice H] codecs (io/native/*.cpp) built with g++ and loaded in "
        f"{build_ms / 1e3:.2f} s")
    rng = np.random.default_rng(11)
    src = {}
    paths = {}
    for name, path in (("large", p_large), ("small", p_small)):
        hdu = fits.open(path)[0]
        data = (hdu.data + rng.normal(0.0, H_NOISE, hdu.data.shape)).astype(
            np.float32)
        if name == "small":
            data[N // 3: N // 3 + 8, N // 7: N // 7 + 120] = np.nan
        src[name] = (data, hdu.header)
        paths[name] = os.path.join(tmp_dir, f"{name}_rice.fits")
    hcomp_path = os.path.join(tmp_dir, "small_hcompress.fits")

    writes = {}
    for name in ("large", "small"):
        data, hdr = src[name]
        writes[f"RICE_1 {name}"] = host_ms(lambda: fits.write(
            paths[name], [fits.PrimaryHDU(), fits.CompImageHDU(
                data=data, header=hdr, name="HRI", compression_type="RICE_1",
                **H_COMPRESSION)]), repeat=1)[0]
    data, hdr = src["small"]
    writes["HCOMPRESS_1 small"] = host_ms(lambda: fits.write(
        hcomp_path, [fits.PrimaryHDU(), fits.CompImageHDU(
            data=data, header=hdr, name="HRI",
            compression_type="HCOMPRESS_1", tile_shape=(H_HCOMP_ROWS, N),
            **H_COMPRESSION)]), repeat=1)[0]
    log(f"[slice H] compressed writes (host ms): " + ", ".join(
        f"{k} {v:.1f} ({os.path.getsize(p) / 2**20:.2f} MiB)" for (k, v), p
        in zip(writes.items(), (paths["large"], paths["small"], hcomp_path)))
        + f"; uncompressed {os.path.getsize(p_small) / 2**20:.2f} MiB")

    # H1: read and decode
    plain_ms, _ = host_ms(lambda: fits.open(p_small))
    reads = {}
    for label, path, want in (("RICE_1 large", paths["large"],
                               src["large"][0]),
                              ("RICE_1 small", paths["small"],
                               src["small"][0]),
                              ("HCOMPRESS_1 small", hcomp_path,
                               src["small"][0])):
        reads[label], hdul = host_ms(lambda: fits.open(path))
        hdu = hdul[1]
        if not (isinstance(hdu, fits.CompImageHDU)
                and hdu.data.dtype == np.float32 and hdu.data.shape == (N, N)):
            raise AssertionError(f"slice H {label}: decoded {type(hdu)} "
                                 f"{hdu.data.dtype} {hdu.data.shape}")
        check_within_step(label, hdu.data, want, path)
    log(f"[slice H] fits.open (host ms, best of 3): uncompressed "
        f"{plain_ms:.1f}, " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in reads.items()))

    # H2: align the compressed pair, then write the correction back
    lag_a = (np.arange(121) - 60) * 0.5
    lag_b = (np.arange(21) - 10) * 1.0

    def make(mode):
        lag = lag_a if mode == "auto" else lag_b
        return Alignment(paths["large"], paths["small"], lag_crval1=lag,
                         lag_crval2=lag,
                         lag_crota=None if mode == "auto" else
                         [-0.05, 0.0, 0.05],
                         small_fov_window=1, large_fov_window=1,
                         lag_search_mode=mode, device=DEVICE)

    def align(mode):
        res = make(mode).align_using_helioprojective()
        torch.cuda.synchronize()
        return res

    results = {}
    k1_launches = 0
    for mode, lag, tol in (("auto", lag_a, 1.0), ("pallas", lag_b, 1.5)):
        engine_log.lines.clear()
        warp_score.LAUNCHES = 0
        t0 = time.perf_counter()
        res = align(mode)
        t_first = time.perf_counter() - t0
        launched = warp_score.LAUNCHES
        plane = res.corr[:, :, 0, 0, res.corr.shape[4] // 2, 0]
        mi = np.unravel_index(np.nanargmax(plane), plane.shape)
        if abs(lag[mi[0]] - TRUE_SHIFT) >= tol or (
                mode == "auto" and abs(res.shift_arcsec[0] - TRUE_SHIFT) >= tol):
            raise AssertionError(f"slice H {mode} missed +8\": argmax "
                                 f"{lag[mi[0]]}, fit {res.shift_arcsec}")
        if mode == "auto" and \
                "engine path: FFT fast (crval grid)" not in engine_log.lines:
            raise AssertionError(f"slice H auto did not take the FFT fast "
                                 f"path: {engine_log.lines}")
        if mode == "pallas":
            if launched <= 0:
                raise AssertionError("slice H pallas did not launch K1")
            k1_launches = launched
        t_warm, _ = host_ms(lambda: align(mode), repeat=2)
        with obs.collect_stages() as st:
            align(mode)
        log(f"[slice H] {mode}: argmax {lag[mi[0]]:+.1f}\" / "
            f"{lag[mi[1]]:+.1f}\", fit {res.shift_arcsec[0]:+.3f}\" / "
            f"{res.shift_arcsec[1]:+.3f}\", K1 launches {launched}; API "
            f"first {t_first:.3f} s, warm {t_warm / 1e3:.3f} s; stages (ms): "
            + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in st.items()))
        results[mode] = res

    res = results["auto"]
    out_path = os.path.join(tmp_dir, "small_rice_corrected.fits")
    write_ms, _ = host_ms(lambda: res.write_corrected_fits([1], out_path),
                          repeat=1)
    inp = fits.open(paths["small"])[1]
    back = fits.open(out_path)[1]
    if not isinstance(back, fits.CompImageHDU):
        raise AssertionError(f"slice H: corrected window is {type(back)}")
    for key in ("ZCMPTYPE", "ZQUANTIZ", "ZTILE1", "ZTILE2"):
        if back.header[key] != inp.header[key]:
            raise AssertionError(f"slice H: corrected {key} "
                                 f"{back.header[key]} != {inp.header[key]}")
    for axis in (1, 2):
        want = inp.header[f"CRVAL{axis}"] + res.shift_arcsec[axis - 1]
        if abs(back.header[f"CRVAL{axis}"] - want) > 1e-9:
            raise AssertionError(f"slice H: corrected CRVAL{axis} "
                                 f"{back.header[f'CRVAL{axis}']} != {want}")
    check_within_step("corrected output vs the input's decode", back.data,
                      inp.data.astype(np.float64), out_path)
    log(f"[slice H] write_corrected_fits (RICE_1 {back.header['ZQUANTIZ']}, "
        f"tiles {back.header['ZTILE1']}x{back.header['ZTILE2']}) "
        f"{write_ms:.1f} ms host; CRVAL1 {inp.header['CRVAL1']:.4f}\" -> "
        f"{back.header['CRVAL1']:.4f}\" (true "
        f"{inp.header['CRVAL1'] + TRUE_SHIFT:.4f}\")")
    if "matplotlib" in sys.modules:
        raise AssertionError("the port's main path imported matplotlib")
    return k1_launches


# ---------------------------------------------------------------------------
# phase M: multi-device sharding (a mesh of shards over a list of devices)
# ---------------------------------------------------------------------------

MESH_TOL = 1e-12        # sharded against unsharded: r, hypercubes
MESH_TILE_RTOL = 1e-6   # tile-FFT's float32 peak, sharded against unsharded
MESH_MOVIE_TOL = 1e-3   # arcsec: fleet shifts against the per-frame route


def mesh_meshes():
    """The meshes phase M drives: two shards on the first card, and every
    card when there are several."""
    import torch

    meshes = [("2 shards on cuda:0", ["cuda:0", "cuda:0"])]
    n = torch.cuda.device_count()
    if n > 1:
        meshes.append((f"{n} cards", [f"cuda:{i}" for i in range(n)]))
    return meshes


def synced(fn):
    """(result, seconds) of ``fn`` on the host clock, ending in a
    synchronize of every card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return out, time.perf_counter() - t0


def mesh_compare(label, run, mesh, check):
    """One path unsharded and sharded: a sharded warm-up call (its result
    held to the unsharded one by ``check``), then the unsharded call and
    the sharded call again, both timed (warm), the two sharded results
    bit-identical."""
    import numpy as np

    first, _ = synced(lambda: run(mesh))
    want, t_u = synced(lambda: run(None))
    again, t_s = synced(lambda: run(mesh))
    detail = check(first, want)
    same = np.array_equal(first, again, equal_nan=True)
    log(f"[mesh] {label}: {detail}; two sharded calls bit-identical {same}; "
        f"warm {t_u * 1e3:.1f} ms unsharded, {t_s * 1e3:.1f} ms sharded")
    if not same:
        raise AssertionError(f"{label}: two sharded calls differ")


def hypercube_check(tol):
    import numpy as np

    def check(got, want):
        err = float(np.nanmax(np.abs(got - want)))
        same = (np.unravel_index(np.nanargmax(got), got.shape)
                == np.unravel_index(np.nanargmax(want), want.shape))
        if not (err <= tol and same
                and np.array_equal(np.isnan(got), np.isnan(want))):
            raise AssertionError(f"sharded max |d| {err:.3e} (tol {tol:g}), "
                                 f"argmax equal {same}")
        return f"max |d| {err:.3e} (tol {tol:g}), argmax equal {same}"
    return check


def mesh_kernel(label, kernel, module, wrapper, plain_fn, run, mesh):
    """K1 or K2 through its engine entry point under ``mesh``: the launch
    count (one per shard, counted from 0 just before the call), r against
    the unsharded call, two sharded calls bit-identical; on the two-shard
    mesh the shards' launches timed against the bound and held to the plain
    version at every CHECK_STRIDE-th lag (:func:`time_against_bound`).
    Returns the timing (with ``"shards"``) or None."""
    import torch

    module.LAUNCHES = 0
    with record_calls(module, wrapper) as shards:
        synced(lambda: run(mesh))
    launched = module.LAUNCHES
    lags = [a[-1].shape[0] for a, _ in shards]
    log(f"[mesh] {label}: {launched} launch(es) for {len(mesh)} shard(s) "
        f"of {lags} lags")
    if launched != len(mesh) or len(shards) != len(mesh):
        raise AssertionError(f"{label}: {launched} launches, expected one "
                             f"per shard ({len(mesh)})")
    mesh_compare(label, run, mesh, hypercube_check(MESH_TOL))
    if len(set(mesh)) != 1:
        return None
    ops = shards[0][0][:-1]
    kw = shards[0][1]
    n_ref = int(torch.isfinite(ops[1]).sum())
    table = torch.cat([a[-1] for a, _ in shards])
    fn = getattr(module, wrapper)
    timing = time_against_bound(
        f"{label}, the {len(shards)} shards' launches", kernel,
        lambda: torch.cat([fn(*a, **k) for a, k in shards]),
        lambda t: plain_fn(*ops, t, **kw), (*ops, table), n_ref, repeat=3)
    timing["shards"] = len(shards)
    return timing


def phase_mesh(calls, tmp_dir, card, engine_log):
    """Phase M: every sharded path on a mesh of two shards on the card
    (and on every card when there are several), each against its
    unsharded call: K1 (slice B's 1323 lags), K2 (slice C's 14641 lags),
    the FFT path (slice A's 121^2 grid), tile-FFT (I1's operands), the
    movie fleet (slice E's 6 frames), the rotation fleet (slice F), and the
    default route (``use_device_mesh=True``: no mesh on one card).
    ``calls``: the engine calls of slices A, B, C and I1, as recorded.
    Returns the two-shard K1 and K2 timings."""
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch import Alignment
    from euispice_coreg_tpu_torch.engine import (carrington, lag_search,
                                                 quad_score, tile_fft,
                                                 warp_score)
    from euispice_coreg_tpu_torch.jitter_correction import \
        align_movie_to_reference
    from euispice_coreg_tpu_torch.pxlshift import AlignmentPixels

    t_phase = time.perf_counter()
    log(f"[mesh] {card}; meshes: " + ", ".join(m for m, _ in mesh_meshes()))

    def engine(fn, call):
        args, kwargs = call
        return lambda mesh: fn(*args, **{**kwargs, "mesh": mesh})

    timings = {}
    for name, mesh in mesh_meshes():
        k1 = mesh_kernel(
            f"K1 {name}, slice B (1323 lags, \"pallas\")", "K1 tan",
            warp_score, "warp_score_sums",
            warp_score.warp_score_sums_reference,
            engine(lag_search.evaluate_lag_grid, calls["B"]), mesh)
        k2 = mesh_kernel(
            f"K2 {name}, slice C ({CARR_LAGS ** 2} lags, \"pallas\")", "K2",
            quad_score, "quad_score_sums",
            quad_score.quad_score_sums_reference,
            engine(carrington.evaluate_lag_grid_carrington, calls["C"]),
            mesh)
        if k1 is not None:
            timings["K1"], timings["K2"] = k1, k2
        mesh_compare(f"FFT path {name}, slice A (121^2 grid)",
                     engine(lag_search.evaluate_lag_grid, calls["A"]), mesh,
                     hypercube_check(MESH_TOL))

        # tile-FFT on I1's operands: float32 sums, added in another order
        def tile_check(got, want):
            rel = abs(float(np.nanmax(got)) - float(np.nanmax(want))) \
                / abs(float(np.nanmax(want)))
            same = int(np.nanargmax(got)) == int(np.nanargmax(want))
            if not (same and rel <= MESH_TILE_RTOL):
                raise AssertionError(f"tile-FFT sharded: argmax equal {same},"
                                     f" peak {rel:.3e} relative")
            return (f"argmax equal {same}, peak {rel:.3e} relative (tol "
                    f"{MESH_TILE_RTOL:g}), max |d| "
                    f"{float(np.nanmax(np.abs(got - want))):.3e}")

        run_tiles = engine(tile_fft.evaluate_select_tile_fft, calls["I1"])
        mesh_compare(f"tile-FFT {name}, I1's operands", run_tiles, mesh,
                     tile_check)
        peaks = {}
        for label, m in (("unsharded", None), ("sharded", mesh)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run_tiles(m)
            torch.cuda.synchronize()
            peaks[label] = (torch.cuda.max_memory_allocated() - base) / 1e9
        log(f"[mesh] tile-FFT {name}: peak memory on cuda:0 above the "
            f"operands {peaks['unsharded']:.3f} GB unsharded, "
            f"{peaks['sharded']:.3f} GB sharded")

        # the movie fleet against the per-frame route (slice E's files)
        p_ref = os.path.join(tmp_dir, "movie_ref.fits")
        paths = [os.path.join(tmp_dir, f"movie_{k}.fits")
                 for k in range(len(JITTER))]

        def movie(m):
            res = align_movie_to_reference(
                paths, p_ref, window_files_input=0, reference_window=0,
                device=DEVICE, mesh=m)
            return np.array([res[k].shift_arcsec[:2] for k in sorted(res)])

        def movie_check(got, want):
            d = float(np.max(np.abs(got - want)))
            fit = float(np.max(np.abs(got - np.array(JITTER))))
            if not (d <= MESH_MOVIE_TOL and fit < 1.0):
                raise AssertionError(f"movie fleet: |fleet - per-frame| {d},"
                                     f" |fit - jitter| {fit}")
            return (f"|fleet - per-frame| {d:.2e}\" (tol {MESH_MOVIE_TOL:g}"
                    f"\"), worst |fit - jitter| {fit:.3f}\" (tol 1\")")

        engine_log.lines.clear()
        mesh_compare(f"movie fleet {name}, slice E ({len(paths)} frames)",
                     movie, mesh, movie_check)
        fleet = [m for m in engine_log.lines
                 if m.startswith("fleet movie search")]
        log(f"[mesh] movie fleet {name}: {fleet[:1]}")
        if len(fleet) != 2:
            raise AssertionError(f"the movie did not take the fleet route "
                                 f"twice: {fleet}")

        # the rotation fleet on the mesh against it on one device (slice F)
        lag_d = np.arange(-16, 17)

        def pixels(m):
            A = AlignmentPixels(os.path.join(tmp_dir, "fsi.fits"), 0,
                                os.path.join(tmp_dir, "crop.fits"), 0,
                                device=DEVICE)
            return A.find_best_parameters(lag_d, lag_d, [-1.0, 0.0, 1.0],
                                          mesh=m)

        mesh_compare(f"pixel shifts {name}, slice F (3 rotations)", pixels,
                     mesh, hypercube_check(MESH_TOL))

    # the default route: use_device_mesh=True builds no mesh on one card
    lag = (np.arange(121) - 60) * 0.5
    p_large, p_small = (os.path.join(tmp_dir, f) for f in ("large.fits",
                                                           "small.fits"))
    corr = {}
    for flag in (True, False):
        A = Alignment(p_large, p_small, lag_crval1=lag, lag_crval2=lag,
                      small_fov_window=0, large_fov_window=0,
                      use_device_mesh=flag, device=DEVICE)
        if flag:
            mesh_default = A.mesh
        corr[flag] = A.align_using_helioprojective(return_type="corr")
    n_cards = torch.cuda.device_count()
    if n_cards == 1:
        ok = mesh_default is None and np.array_equal(
            corr[True], corr[False], equal_nan=True)
    else:
        ok = len(mesh_default) == n_cards and float(np.nanmax(np.abs(
            corr[True] - corr[False]))) <= MESH_TOL
    log(f"[mesh] default route, {n_cards} card(s): Alignment("
        f"use_device_mesh=True).mesh = {mesh_default}; slice A's hypercube "
        f"against use_device_mesh=False: "
        f"{'bit-identical' if n_cards == 1 else 'within 1e-12'} {ok}")
    if not ok:
        raise AssertionError("the default route changed on this machine")
    log(f"[mesh] phase M {time.perf_counter() - t_phase:.1f} s")
    return timings


# ---------------------------------------------------------------------------
# phase P: the port's API reference
# ---------------------------------------------------------------------------

def _load_tool(name):
    """``tools/<name>.py`` as a module (``tools/`` is no package)."""
    import importlib.util

    path = os.path.join(REPO, "tools", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_api_doc():
    """``tools/gen_api_doc_torch.py --check`` in this process: the port's
    API reference, generated here from the port alone, must equal the
    committed ``docs/API_torch.md``.  Returns the seconds it took."""
    t0 = time.perf_counter()
    gen = _load_tool("gen_api_doc_torch")
    rc = gen.main(["--check"])
    seconds = time.perf_counter() - t0
    jax_loaded = sorted(k for k in sys.modules if k.split(".")[0] in (
        "jax", "jaxlib", "euispice_coreg_tpu"))
    log(f"[api] gen_api_doc_torch.py --check: rc {rc}, "
        f"{len(gen.SECTIONS)} sections, JAX modules loaded {jax_loaded}, "
        f"{seconds:.3f} s")
    if rc != 0 or jax_loaded:
        raise AssertionError("phase P: docs/API_torch.md is stale or the "
                             "generator loaded JAX")
    return seconds


# ---------------------------------------------------------------------------
# phase Q: the port's bench
# ---------------------------------------------------------------------------

# bench_torch's leg -> the key of its seconds in the bench's JSON line
BENCH_LEGS = {"core": "wall_clock_s", "api": "end_to_end_api_s",
              "carr": "carrington_121x121_2048_s",
              "carr_api": "carrington_api_s",
              "carr_coarse": "carrington_coarse_121x121_s",
              "mixed": "mixed_grid_21x21x3_2048_s",
              "synras": "synras_spice_e2e_s",
              "iterative": "iterative_spice_5x5_s"}


def phase_bench(card):
    """``bench_torch.main([])`` in this process, its standard output
    captured.  Fails unless every leg has seconds, no leg failed its
    recovery check, the bench's device is phase 1's card (``card``: the
    nvidia-smi line), K2 launched in the carr_coarse leg's best run, the
    README generator (``tools/gen_readme_perf_torch.py``) takes the line
    as it is (neither refused nor masked), every leg's last hypercube
    agrees with the JAX package's (:func:`phase_golden`) and K1 on the
    mixed grid does too.  Returns the bench's JSON line (a dict) and the
    phase's seconds."""
    import io

    import torch

    import bench_torch

    buf = io.StringIO()
    keep = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        bench_torch.main([], keep=keep)
    seconds = time.perf_counter() - t0
    line = buf.getvalue().strip().splitlines()[-1]
    log(f"[bench] line: {line}")
    out = json.loads(line)
    launches = out["launches"]
    log("[bench] " + "; ".join(
        f"{leg} {out[key]} s, K1 {(launches.get(leg) or {}).get('K1')} / K2 "
        f"{(launches.get(leg) or {}).get('K2')}"
        for leg, key in BENCH_LEGS.items())
        + f"; {out['value']} evals/s, host per-lag reference x 20 cores "
        f"{out['cpu_baseline_s_20core_est']} s; device {out['device']}; "
        f"phase {seconds:.1f} s")
    power = float(card.rsplit(",", 1)[1].split()[0])
    dev = out["device"]
    problems = [f"{leg} has no seconds" for leg, key in BENCH_LEGS.items()
                if out[key] is None]
    if out["leg_errors"] is not None:
        problems.append(f"leg_errors {out['leg_errors']}")
    # the README generator's line loader must take the line as it is
    gen = _load_tool("gen_readme_perf_torch")
    try:
        taken = gen.mask_failed_legs(gen.parse_run(line, "phase Q"))
    except gen.RunRefused as exc:
        problems.append(f"the README generator refuses the line: {exc}")
    else:
        log(f"[bench] README generator: card {gen.card_of(out)}, line "
            + ("taken as it is" if taken == out else "masked"))
        if taken != out:
            problems.append("the README generator masks legs of the line")
    if dev["name"] != torch.cuda.get_device_name(0) \
            or dev["power_limit_w"] != power:
        problems.append(f"device {dev} is not phase 1's card {card!r}")
    if not (launches.get("carr_coarse") or {}).get("K2"):
        problems.append(f"K2 did not launch in carr_coarse: {launches}")
    problems += phase_golden(keep)
    if problems:
        raise AssertionError("phase Q: " + "; ".join(problems))
    return out, seconds


def phase_golden(keep):
    """Every bench leg's kept hypercube (``keep``: ``bench_torch.main``'s)
    against the JAX package's (``bench_torch.GOLDEN``), the legs whose
    operands the card builds on host-built operands
    (:func:`golden_host_built`), then the mixed grid's operands through K1
    (``warp_score.evaluate_lag_grid_warp``, one launch) against the same
    golden, its argmax on the CROTA = 0 plane (bench.py's).  Reuses the
    bench's renders.  Logs one ``[golden]`` line each, and where the
    carr_coarse golden has a witness, how far the JAX package's exact
    engine lies from both; returns the problems."""
    import numpy as np
    import torch

    import bench_torch
    from euispice_coreg_tpu_torch.engine import warp_score

    t0 = time.perf_counter()
    golden = bench_torch.load_golden()
    problems = []
    for leg in BENCH_LEGS:
        if leg not in keep:
            problems.append(f"{leg}: no hypercube kept")
            continue
        k = keep[leg]
        f = bench_torch.compare_to_golden(leg, k["corr"], k["inputs"], golden,
                                          route=k["route"], built_on_card=True)
        log(f"[golden] {bench_torch.golden_line(f)}")
        problems += f["problems"]
    w = golden.get("carr_coarse", {}).get("witness")
    if w is not None and "carr_coarse" in keep:
        sub = (slice(None, None, w["step"]),) * 2
        port = keep["carr_coarse"]["corr"][sub]
        jax_sel = golden["carr_coarse"]["corr"][sub]
        c = tuple(n // 2 for n in w["corr"].shape[:2])
        fam = bench_torch.route_family(golden["carr_coarse"]["route"])
        log(f"[golden] carr_coarse witness: the JAX package's "
            f"{w['route']!r} on every {w['step']}th lag ({port.shape[0]}^2)"
            f": max |d| against its {fam} "
            f"{np.nanmax(np.abs(w['corr'] - jax_sel)):.3e}, against the "
            f"port's {np.nanmax(np.abs(w['corr'] - port)):.3e} (|d| at lag "
            f"0 {abs(w['corr'][c] - port[c]).item():.3e}); the port against "
            f"the JAX package's {fam} there "
            f"{np.nanmax(np.abs(port - jax_sel)):.3e}")

    small, ref, lon, lat, base = bench_torch.last_pair
    bench_torch.last_pair = None
    problems += golden_host_built(small, ref, base, golden)

    dev = small.device
    ops = [t.to(torch.float32) for t in (small, ref, lon, lat)]
    lags = keep["mixed"]["inputs"]["lags"] if "mixed" in keep else \
        golden["mixed"]["lags"]
    warp_score.LAUNCHES = 0
    t1 = time.perf_counter()
    corr = warp_score.evaluate_lag_grid_warp(
        *ops, base, *lags, order=2, method="correlation", kind="tan",
        device=dev, compute_dtype="float32")
    torch.cuda.synchronize()
    k1_s = time.perf_counter() - t1
    launches = warp_score.LAUNCHES
    inputs = {"lags": lags, "operands": {
        name: bench_torch.fingerprint(t)
        for name, t in zip(("small", "ref", "lon", "lat"),
                           (small, ref, lon, lat))}}
    f = bench_torch.compare_to_golden(
        "mixed", corr, inputs, golden,
        route="engine path: K1 fused warp+score kernel",
        plane=(slice(None), slice(None), 0, 0, 1))
    log(f"[golden] K1 {bench_torch.golden_line(f)}; argmax on the CROTA = 0 "
        f"plane; {launches} launch(es), {k1_s * 1e3:.1f} ms with the "
        f"operands' upload and the host's Pearson")
    problems += [f"K1 on the mixed grid: {p}" for p in f["problems"]]
    if launches != 1:
        problems.append(f"K1 on the mixed grid launched {launches} times")
    log(f"[golden] {len(BENCH_LEGS)} legs, the host-built runs and K1 "
        f"compared in {time.perf_counter() - t0:.1f} s")
    return problems


def golden_host_built(small, ref, base, golden):
    """The legs of ``bench_torch.DEVICE_BUILT`` on operands built on the
    host CPU, their values held to the golden's tolerance: api's
    comparison grid and submap (``lag_search.prepare_grid_and_submap``,
    float32, seeded as Alignment seeds them) built on the host and scored
    by the card's engine; synras and iterative through the port on the
    host CPU, one run each.  Logs one ``[golden]`` line a leg; returns the
    problems."""
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    import bench_torch
    from euispice_coreg_tpu_torch.core import wcs as wcs_mod
    from euispice_coreg_tpu_torch.engine import lag_search

    problems = []
    n = small.shape[0]
    params = {k: v for k, v in base.items() if k != "crota"}
    lags = golden["api"]["lags"]
    small32 = small.to(torch.float32)
    lon, lat, sub = lag_search.prepare_grid_and_submap(
        ref.to(torch.float32).cpu().numpy(), params, params, n, n, "tan",
        False, 2, device="cpu", compute_dtype="float32")
    lon, lat, sub = (t.to(small.device) for t in (lon, lat, sub))
    px, py = lag_search.probe_pixel_points(n, n)
    lag_search.seed_probe_values(
        lon, lat, *wcs_mod.pixel_to_world(params, px, py, kind="tan", xp=np))
    with bench_torch.route_log() as lines:
        corr = lag_search.evaluate_lag_grid(
            small32, sub, lon, lat, base, *(np.asarray(v) / 3600.0
                                            for v in lags),
            order=2, method="correlation", kind="tan",
            device=small.device, compute_dtype="float32")
    inputs = {"lags": lags, "operands": {
        "small": bench_torch.fingerprint(small),
        "ref": bench_torch.fingerprint(ref)}}
    found = [bench_torch.compare_to_golden(
        "api", corr[..., None], inputs, golden, route=" | ".join(lines))]
    cpu = torch.device("cpu")
    with mock.patch.object(bench_torch, "timed_best", bench_torch.run_once):
        for leg, run in (("synras", bench_torch.run_synras_spice),
                         ("iterative", bench_torch.run_iterative_spice)):
            with tempfile.TemporaryDirectory() as td:
                run(td, cpu)
            found.append(bench_torch.compare_to_golden(
                leg, bench_torch.last_result, bench_torch.last_inputs,
                golden, route=bench_torch.last_route))
    for f, where in zip(found, ("grid and submap built on the host CPU, the "
                                "card's engine", "on the host CPU",
                                "on the host CPU")):
        log(f"[golden] host-built {bench_torch.golden_line(f)}; {where}")
        problems += [f"host-built {p}" for p in f["problems"]]
    return problems


# ---------------------------------------------------------------------------
# phase X: the port's examples, as a user runs them
# ---------------------------------------------------------------------------

EXAMPLES = os.path.join(REPO, "examples")
X_SHIFT = (24.0, 6.0)   # the real-file run's pointing error, inside the
                        # example's grid (15..34" x -4..16")
X_ROUTE_LINES = ("engine path:", "auto route:", "tile-FFT",
                 "carrington select:")


def run_example(label, module, argv, out_dir, engine_log):
    """``module.main(argv + [out_dir/first])`` and again into
    ``out_dir/warm``, in-process on DEVICE.  K1's and K2's counts are set
    to 0 just before the first run and read just after, and their
    launches recorded.  Prints both wall times, the launches and the
    engine's route lines of the first run and the warm run's stage clocks,
    then holds every recorded launch against its plain version
    (check_example_launches).  Returns (first run's output, {"first_s",
    "warm_s", "K1", "K2", "route", "printed", "stages", "timings"})."""
    import io

    import torch

    from euispice_coreg_tpu_torch.engine import quad_score, warp_score
    from euispice_coreg_tpu_torch.utils import obs

    runs = {}
    for run in ("first", "warm"):
        engine_log.lines.clear()
        warp_score.LAUNCHES = 0
        quad_score.LAUNCHES = 0
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed), \
                obs.collect_stages() as stages, \
                record_calls(warp_score, "warp_score_sums") as k1_calls, \
                record_calls(quad_score, "quad_score_sums") as k2_calls:
            out = module.main(argv + ["--device", DEVICE,
                                      os.path.join(out_dir, run)])
            torch.cuda.synchronize()
        runs[run] = (time.perf_counter() - t0, out, warp_score.LAUNCHES,
                     quad_score.LAUNCHES, list(engine_log.lines),
                     printed.getvalue().strip().splitlines(), stages,
                     {"K1": k1_calls, "K2": k2_calls})
    first_s, out, k1, k2, lines, printed, _, calls = runs["first"]
    warm_s, stages = runs["warm"][0], runs["warm"][-2]
    route = [ln for ln in lines if ln.startswith(X_ROUTE_LINES)]
    log(f"[phase X] {label}: first {first_s:.3f} s, warm {warm_s:.3f} s; "
        f"K1 launches {k1}, K2 launches {k2}; route: "
        f"{' | '.join(dict.fromkeys(route))}; warm stages (ms): "
        + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in stages.items()))
    timings = {kid: check_example_launches(label, kid, calls[kid], n)
               for kid, n in (("K1", k1), ("K2", k2)) if calls[kid]}
    return out, {"first_s": first_s, "warm_s": warm_s, "K1": k1, "K2": k2,
                 "route": route, "printed": printed, "stages": stages,
                 "timings": timings}


def check_example_launches(label, kid, calls, launches):
    """Every launch of kernel ``kid`` recorded in an example's first run,
    replayed on the same card tensors through the kernel and its plain
    version: every lag's sums within TOL of each sum's largest magnitude,
    r within TOL and undefined at the same lags.  The first call is then
    timed against its bound (time_against_bound) and its plain version.
    Returns the timing entry ("slice": "X")."""
    import numpy as np
    import torch

    from euispice_coreg_tpu_torch.engine import quad_score, warp_score

    mod, fn = {"K1": (warp_score, "warp_score_sums"),
               "K2": (quad_score, "quad_score_sums")}[kid]
    launch = getattr(mod, fn)
    plain = getattr(mod, fn + "_reference")
    errs = []
    for args, kw in calls:
        got = launch(*args, **kw).cpu().numpy()
        want = plain(*args, **kw).cpu().numpy()
        errs.append(compare_sums(got, want))
    sum_err = max(e[0] for e in errs)
    r_err = max(e[1] for e in errs)
    same_nan = all(e[2] for e in errs)
    n_lags = sum(c[0][-1].shape[0] for c in calls)
    log(f"[kernels] {kid} slice X {label}: {len(calls)} launch(es), all "
        f"{n_lags} lags against the plain version: sums {sum_err:.2e}, "
        f"|dr| {r_err:.2e} (tol {TOL:g}), r undefined at the same lags "
        f"{same_nan}")
    if not (sum_err <= TOL and r_err <= TOL and same_nan):
        raise AssertionError(f"phase X {label}: {kid} disagrees with its "
                             f"plain version")
    args, kw = calls[0]
    ref = args[1]
    kernel = "K2" if kid == "K2" else f"K1 {kw['kind']}"
    shape = "x".join(str(n) for n in ref.shape)
    out = time_against_bound(
        f"{kid} slice X {label} {shape} x {args[-1].shape[0]} lags", kernel,
        lambda: launch(*args, **kw), lambda t: plain(*args[:-1], t, **kw),
        args, int(torch.isfinite(ref).sum()), repeat=3)
    plain_ms = cuda_ms(lambda: plain(*args, **kw), repeat=1)
    log(f"[kernels] {kid} slice X {label} {shape}: plain version "
        f"{plain_ms:.3f} ms")
    out.update(slice="X", example=label, launches=launches,
               plain_ms=plain_ms, max_abs_err=max(out["max_abs_err"], r_err),
               max_sum_err=sum_err)
    return out


def check_shift(label, shift, truth, bound):
    """``shift`` within ``bound`` (arcsec, per axis) of ``truth``."""
    import numpy as np

    err = np.abs(np.subtract(shift[:2], truth))
    log(f"[phase X] {label}: recovered ({shift[0]:+.3f}\", "
        f"{shift[1]:+.3f}\"), injected ({truth[0]:+.3f}\", "
        f"{truth[1]:+.3f}\"), bound {bound}\"")
    if not np.all(err < bound):
        raise AssertionError(f"phase X {label}: missed the injected shift")


def phase_examples(tmp_dir, engine_log):
    """Phase X: the four examples of the port (examples/*_torch.py), each
    through its ``main`` at its own sizes, then align_hri_fsi_torch's
    real-file branch on an N^2 RICE_1 pair (write_pair, mispointed by
    X_SHIFT, noise sigma H_NOISE).  Each must pass its own recovery check;
    the demo's Carrington leg must run on K2 where the card's router sends
    it there, and on the route it names otherwise; every launch of K1 or
    K2 must agree with its plain version.  Returns each run's times,
    launches and kernel timings."""
    sys.path.insert(0, EXAMPLES)
    import align_hri_fsi_torch
    import align_spice_synras_torch
    import demo_synthetic_torch
    import jitter_movie_torch

    x_dir = os.path.join(tmp_dir, "phase_x")
    t_phase = time.perf_counter()
    runs = {}

    out, runs["demo_synthetic"] = run_example(
        "demo_synthetic", demo_synthetic_torch, [],
        os.path.join(x_dir, "demo"), engine_log)
    r = runs["demo_synthetic"]
    log(f"[phase X] demo_synthetic printed: {' | '.join(r['printed'][-3:])}")
    if not out["ok"] or r["printed"][-1] != "OK":
        raise AssertionError("phase X demo_synthetic: MISMATCH")
    check_shift("demo_synthetic helioprojective",
                out["helioprojective"].shift_arcsec,
                demo_synthetic_torch.TRUE_SHIFT, 1.0)
    check_shift("demo_synthetic carrington", out["carrington"].shift_arcsec,
                demo_synthetic_torch.TRUE_SHIFT, 1.0)
    # the Carrington leg: the select path on K2 unless tile-FFT took the
    # whole set (or the per-combo FFT path ran, which launches neither)
    carr = [ln for ln in r["route"] if "carrington" in ln
            or "tile-FFT" in ln]
    on_k2 = ("engine path: carrington linearized select" in carr
             and not any(ln.startswith("carrington select: tile-FFT "
                                       "surfaces") for ln in carr))
    log(f"[phase X] demo_synthetic Carrington leg: "
        f"{'K2' if on_k2 else 'not K2'} ({' | '.join(carr)}), K2 launches "
        f"{r['K2']}")
    if on_k2 != (r["K2"] > 0) or not carr:
        raise AssertionError(f"phase X demo_synthetic: the Carrington leg's "
                             f"route {carr} and K2's launches {r['K2']} "
                             f"disagree")
    if "engine path: FFT fast (crval grid)" not in r["route"]:
        raise AssertionError("phase X demo_synthetic: the helioprojective "
                             "leg left the FFT path")

    out, runs["align_hri_fsi"] = run_example(
        "align_hri_fsi (synthetic)", align_hri_fsi_torch, [],
        os.path.join(x_dir, "hri_fsi"), engine_log)
    check_shift("align_hri_fsi (synthetic)", out["results"].shift_arcsec,
                align_hri_fsi_torch.SYNTHETIC_SHIFT, 1.0)

    out, runs["align_spice_synras"] = run_example(
        "align_spice_synras", align_spice_synras_torch, [],
        os.path.join(x_dir, "spice"), engine_log)
    # half a raster step (4") along the raster, 1" across
    check_shift("align_spice_synras", out["results"].shift_arcsec,
                align_spice_synras_torch.TRUE_SHIFT, (2.0, 1.0))

    out, runs["jitter_movie"] = run_example(
        "jitter_movie", jitter_movie_torch, [],
        os.path.join(x_dir, "jitter"), engine_log)
    if sorted(out["results"]) != [1, 2, 3, 4, 5]:
        raise AssertionError(f"phase X jitter_movie: frames "
                             f"{sorted(out['results'])} aligned")
    for k, res in sorted(out["results"].items()):
        check_shift(f"jitter_movie frame {k}", res.shift_arcsec,
                    out["jitter"][k], 0.5)

    t0 = time.perf_counter()
    real_dir = os.path.join(x_dir, "real")
    os.makedirs(real_dir)
    p_fsi, p_hri, _ = write_pair(real_dir, shift=X_SHIFT, noise=H_NOISE,
                                 rice=True)
    log(f"[phase X] real-file pair: {N}^2 RICE_1, "
        f"{os.path.getsize(p_fsi) / 2**20:.2f} + "
        f"{os.path.getsize(p_hri) / 2**20:.2f} MiB, written in "
        f"{time.perf_counter() - t0:.2f} s")
    out, runs["align_hri_fsi real"] = run_example(
        f"align_hri_fsi ({N}^2 RICE_1 files)", align_hri_fsi_torch,
        [p_fsi, p_hri], os.path.join(x_dir, "hri_fsi_real"), engine_log)
    res = out["results"]
    check_shift(f"align_hri_fsi ({N}^2 RICE_1 files)", res.shift_arcsec,
                X_SHIFT, 1.0)
    if out["window"] != -1 or "engine path: FFT fast (crval grid)" not in \
            runs["align_hri_fsi real"]["route"]:
        raise AssertionError("phase X real-file run: not the last HDU on "
                             "the FFT path")
    from euispice_coreg_tpu_torch.io import fits

    back = fits.open(out["paths"]["aligned"])[-1]
    if not (isinstance(back, fits.CompImageHDU)
            and back.header["ZCMPTYPE"] == "RICE_1"):
        raise AssertionError("phase X real-file run: the aligned file is "
                             "not RICE_1")
    if "matplotlib" in sys.modules:
        raise AssertionError("phase X imported matplotlib")
    log(f"[phase X] the phase {time.perf_counter() - t_phase:.1f} s")
    return runs


def main():
    t_start = time.perf_counter()
    card = phase_device()
    sys.path.insert(0, REPO)
    import torch

    from euispice_coreg_tpu_torch.engine import (carrington, lag_search,
                                                 quad_score, tile_fft,
                                                 warp_score)

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
        # the engine calls of slices A, B, C and I1 are recorded for phase M
        # (the recorder passes every call through unchanged)
        mesh_calls = {}
        with record_calls(lag_search, "evaluate_lag_grid") as rec:
            corr32 = phase_slice_a(p_large, p_small, engine_log)
        mesh_calls["A"] = rec[0]
        with record_calls(lag_search, "evaluate_lag_grid") as rec:
            launches = phase_slice_b(p_large, p_small, hdr, tmp_dir)
        mesh_calls["B"] = rec[0]
        main_launches = warp_score.LAUNCHES
        if main_launches <= 0 or launches <= 0:
            raise AssertionError("K1 was not launched on the main path")
        phase_precision(p_large, p_small, corr32)
        time_fast_path(p_large, p_small)

        # slice C: the Carrington path, counts from 0 again
        c_large, c_small, c_hdr = write_carr_pair(tmp_dir)
        warp_score.LAUNCHES = 0
        quad_score.LAUNCHES = 0
        with record_calls(carrington, "evaluate_lag_grid_carrington") as rec:
            k2_corr, k2_stages = phase_slice_c(c_large, c_small, c_hdr,
                                               tmp_dir, engine_log)
        mesh_calls["C"] = rec[0]
        k2_launches = quad_score.LAUNCHES
        if k2_launches <= 0:
            raise AssertionError("K2 was not launched on the Carrington path")
        # slice I: tile-FFT on slice C's grid (no kernel of ours: I1 sets
        # K2's count to 0 and requires it to stay there), the coarse grid,
        # the transforms; then slice C auto, routed by slice I's measurement
        with record_calls(tile_fft, "evaluate_select_tile_fft") as rec:
            slice_i = phase_slice_i(c_large, c_small, k2_corr, k2_stages,
                                    k2_timings[1]["ms"], engine_log)
        mesh_calls["I1"] = rec[0]
        del rec
        i2_leg = phase_slice_i_coarse(engine_log)
        phase_slice_i_transforms(c_small)
        c_auto = phase_slice_c_auto(c_large, c_small, engine_log)
        coarse = phase_coarse(engine_log)
        phase_sunpy(c_large, c_small)

        # slices D-F: the block path, movies, pxlshift (each phase sets the
        # count of the kernel it drives to 0 just before that run)
        phase_slice_d(p_large, p_small, engine_log)
        phase_slice_e(p_small, c_small, tmp_dir, engine_log)
        phase_slice_f(tmp_dir)

        # slice G: SPICE (G3 and G4 set their kernel's count to 0 first)
        g_timings = phase_slice_g(tmp_dir, engine_log)

        # phase R: the "auto" router of mixed grids on slice A's pair and
        # G3's operands (K1 launched to compare routes, not counted)
        route = phase_route(p_large, p_small,
                            g_timings.pop("G3 engine call"), engine_log)

        # slice H: tile-compressed files (sets K1's count to 0 first)
        phase_slice_h(p_large, p_small, tmp_dir, engine_log)

        # phase M: the sharded paths (K1's and K2's counts set to 0 just
        # before each sharded call and read just after)
        mesh_timings = phase_mesh(mesh_calls, tmp_dir, card, engine_log)
        del mesh_calls

        # phase X: the port's examples (K1's and K2's counts set to 0 just
        # before each run and read just after)
        examples = phase_examples(tmp_dir, engine_log)
    api_doc_s = phase_api_doc()
    # phase Q: the port's bench (its launches are its own, not the main
    # path's)
    bench, bench_s = phase_bench(card)
    x_timings = {kid: [r["timings"][kid] for r in examples.values()
                       if kid in r["timings"]] for kid in ("K1", "K2")}
    k1_timings += [g_timings["K1"], mesh_timings["K1"], *x_timings["K1"]]
    k2_timings += [g_timings["K2"], mesh_timings["K2"], *x_timings["K2"]]

    log(f"[summary] card {card}; nvcc K1 {build_s['warp_score']:.2f} s, "
        f"K2 {build_s['quad_score']:.2f} s; K1 at 1323 / 11907 / slice G "
        f"/ 2 shards / phase X lags " + " / ".join(
            f"{t['ms']:.3f}" for t in k1_timings) + " ms, K2 at 441 / 14641 "
        "/ 14641 wide / slice G / 2 shards / phase X lags " + " / ".join(
            f"{t['ms']:.3f}" for t in k2_timings) + " ms; slice I tile-FFT "
        f"select {slice_i['tile_s'] * 1e3:.1f} ms vs K2 select "
        f"{slice_i['k2_s'] * 1e3:.1f} ms, I1 API warm "
        f"{slice_i['warm_s']:.3f} s, I2 leg {i2_leg}; warm API auto / "
        f"pallas: slice C {min(c_auto['auto']):.3f} / "
        f"{min(c_auto['pallas']):.3f} s, coarse {min(coarse['auto']):.3f} / "
        f"{min(coarse['pallas']):.3f} s (best of 2); coarse hybrid picker "
        f"{coarse['hybrid_pick_ms']:.1f} ms; phase R: auto took the faster "
        f"route on {sum(r['auto'] == r['faster'] for r in route['rows'])} "
        f"of {len(route['rows'])} grids, crossover at {N}^2 (fitted) "
        + " / ".join(f"{v:.0f}" for v in route["crossover"]["fitted"].values())
        + " CRVAL lags a combo at 3 / 27 combos; phase X first / warm s: "
        + ", ".join(f"{k} {v['first_s']:.2f} / {v['warm_s']:.2f}"
                    for k, v in examples.items())
        + f"; phase P {api_doc_s:.3f} s"
        + f"; phase Q (bench) {bench_s:.1f} s, core {bench['wall_clock_s']}"
        f" s, carr_coarse {bench['carrington_coarse_121x121_s']} s"
        + f"; main() {time.perf_counter() - t_start:.1f} s")
    # no single PyTorch call computes either function (grid_sample has no
    # order-2 B-spline, no mirror rule at sample_image's edge and no masked
    # sums), so library_ms is null
    print(json.dumps({"kernels": [{
        "name": "warp_score (K1)",
        "route": "cuda",
        "source": "euispice_coreg_tpu_torch/csrc/warp_score.cu",
        "replaces": "euispice_coreg_tpu/engine/pallas_warp.py:40",
        "launches": main_launches,
        "max_abs_err": max(max_err, ragged_err["K1"],
                           *(t["max_abs_err"] for t in k1_timings)),
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
        "max_abs_err": max(k2_err, ragged_err["K2"],
                           *(t["max_abs_err"] for t in k2_timings)),
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
