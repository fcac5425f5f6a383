#!/usr/bin/env python3
"""Reference hypercubes of ``bench_torch.py``'s eight legs, computed by the
JAX package on the CPU.

    JAX_PLATFORMS=cpu python tools/gen_jax_goldens_torch.py [--leg LEG ...]
        [--out PATH] [--small] [--timeout SECONDS]

For each leg it renders ``bench.py``'s inputs with ``bench.py``'s own
helpers (``synthesize_pair``, ``_carr_header``, ``_carr_render``,
``_carr_scene``) and ``tests/fixtures.py`` (the SPICE legs), then makes the
JAX-package call of that ``bench.py`` leg with that leg's arguments, once:

    core         run_tpu                lag_search.evaluate_lag_grid
    api          run_full_api           Alignment.align_using_helioprojective
    mixed        run_mixed_grid         lag_search.evaluate_lag_grid, "block"
    synras       run_synras_spice       SPICEComposedMapBuilder + AlignmentSpice
    iterative    run_iterative_spice    AlignementSpiceIterativeContextRaster
    carr         run_carrington         carrington.evaluate_lag_grid_carrington
    carr_coarse  run_carrington_coarse  carrington.evaluate_lag_grid_carrington
    carr_api     run_carrington_api     Alignment.align_using_carrington

It writes ``tests/goldens/jax_bench_legs.npz``.  For leg ``L`` the file holds

- ``L.corr``: the hypercube, float64;
- ``L.route``: the JAX route, as the engine's log lines name it, and the
  ``lag_mode`` passed where it is not ``bench.py``'s (``LAG_MODE``);
- ``L.operands``: the names of the operands the leg feeds the engine, and
  for each ``L.op.NAME.shape`` and ``L.op.NAME.stats`` (NaN count, float64
  sum and sum of squares of the finite values) of the operand as rendered:
  the float64 render where the leg casts one to float32 (the port renders
  it on the card, where float32 casts of renders 1e-13 apart can round
  apart), the float32 data where both benches write the same host array;
- ``L.lag0`` .. ``L.lag4``: the five lag arrays passed, in the call's units;
- ``L.constants``: a JSON object of the leg's sizes, steps and injection;
- ``L.margin``: the hypercube's top-2 margin (its largest finite value less
  the next one);
- for a leg of ``WITNESS`` (its golden route is not the exact engine),
  ``L.witness.corr``, ``L.witness.route`` and ``L.witness.step``: the
  exact engine's hypercube on every ``step``-th lag of each CRVAL axis;

and ``meta``: a JSON object with the JAX and numpy versions, the x64 flag
and the sizes' name (``full`` or ``small``).

Each leg runs in a process of its own (``--leg`` runs only those named)
and replaces only its own keys in the file, under a lock, so legs may run
one at a time or side by side; a leg that does not finish within
``--timeout`` seconds (default 1800) writes nothing.  The Carrington legs
pass a ``lag_mode`` (``LAG_MODE``), which the file names in their route.
Images, grids and steps are never shrunk.  ``--small`` writes the
same legs at small sizes (``SMALL``) for tests; a test may also call
:func:`compute_leg` in its own process.

The arrays of two runs are identical.  Runs on the CPU only; the port and
``bench_torch.py`` read the file with numpy (``bench_torch.load_golden``)
and never import JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import fcntl
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "goldens", "jax_bench_legs.npz")

LEGS = ("core", "api", "mixed", "synras", "iterative", "carr", "carr_coarse",
        "carr_api")

# bench.py's sizes, and the small ones of the tests (tests/test_torch_bench.py
# runs bench_torch.py's legs at these)
FULL = {"N_SMALL": 2048, "N_REF": 2048, "GRID": 121,
        "CARR_SHAPE": (2048, 2048), "IMAGER_SHAPE": (1024, 1024)}
SMALL = {"N_SMALL": 256, "N_REF": 256, "GRID": 41,
         "CARR_SHAPE": (64, 64), "IMAGER_SHAPE": (384, 384)}

# Legs whose JAX route differs from bench.py's call: leg -> lag_mode.  On
# an 8-core CPU bench.py's route ("auto": the XLA select evaluator on a
# CPU) finished no Carrington leg within 1800 s; "tile_fft" took 70-117 s
# (carr, carr_api).  On carr_coarse "tile_fft" declines and the XLA select
# evaluator too (its whole-image residual exceeds 24 px), so a CPU run ends
# in the per-lag gather (2104 s), an algorithm whose canvas is the whole
# detector image; "pallas" takes the quad kernel (in interpret mode on a
# CPU), the algorithm of the JAX package's accelerator route and of the
# port's K2, whose canvas is the Carrington grid.
LAG_MODE: dict[str, str] = {"carr": "tile_fft", "carr_api": "tile_fft",
                            "carr_coarse": "pallas"}

# Legs whose golden route is not the exact engine keep a witness: the
# exact engine's hypercube on every WITNESS_STEP-th lag of each CRVAL axis
# (leg -> lag_mode), to show where the two JAX routes part.
WITNESS: dict[str, str] = {"carr_coarse": "exact"}
WITNESS_STEP = 10

CARR_LONLIMS = (117.0, 123.0)
CARR_LATLIMS = (-1.0, 7.0)

# engine log lines that name the route a call took (the Carrington gather
# fallback says so only in its "preconditions failed" line)
_ROUTE_PREFIXES = ("engine path:", "carrington select:",
                   "carrington tile-FFT:",
                   "carrington select preconditions failed")


def _setup_jax():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for p in (REPO, os.path.join(REPO, "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)
    return jax


class _RouteLog(logging.Handler):
    """Collects the engine's route lines, in order, each once."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith(_ROUTE_PREFIXES) and msg not in self.lines:
            self.lines.append(msg)


@contextlib.contextmanager
def route_log(name="euispice_coreg_tpu"):
    """Capture the route lines of ``name``'s logger inside the block."""
    log = logging.getLogger(name)
    h, level = _RouteLog(), log.level
    log.addHandler(h)
    log.setLevel(logging.INFO)
    try:
        yield h.lines
    finally:
        log.removeHandler(h)
        log.setLevel(level)


def fingerprint(a):
    """(shape, [NaN count, sum, sum of squares]) of an array in float64;
    the sums run over its finite values."""
    a = np.asarray(a, dtype=np.float64)
    fin = a[np.isfinite(a)]
    return (np.asarray(a.shape, dtype=np.int64),
            np.array([a.size - fin.size, fin.sum(), (fin * fin).sum()]))


def top2_margin(corr):
    """The hypercube's largest finite value less its second largest."""
    v = np.sort(np.asarray(corr, dtype=np.float64)[np.isfinite(corr)])
    return float(v[-1] - v[-2]) if v.size > 1 else float("inf")


def _lags5(*lags):
    return [np.asarray(x, dtype=np.float64) for x in lags]


def _bench(sizes):
    """bench.py, its module constants set to ``sizes`` (the module is not
    edited: only this process's copy of its constants)."""
    import bench

    bench.N_SMALL, bench.N_REF, bench.GRID = (sizes["N_SMALL"],
                                              sizes["N_REF"], sizes["GRID"])
    return bench


def _pair(sizes):
    bench = _bench(sizes)
    small, ref, lon, lat, base = bench.synthesize_pair()
    return bench, small, ref, lon, lat, base


def leg_core(sizes, lag_mode):
    import jax.numpy as jnp

    from euispice_coreg_tpu.engine import lag_search

    bench, small, ref, lon, lat, base = _pair(sizes)
    ops = {"small": small, "ref": ref, "lon": lon, "lat": lat}
    step = 0.5 / 3600.0
    lag = (np.arange(bench.GRID) - bench.GRID // 2) * step
    lags = _lags5(lag, lag, [0.0], [0.0], [0.0])
    corr = lag_search.evaluate_lag_grid(
        *(jnp.asarray(ops[k].astype(np.float32))
          for k in ("small", "ref", "lon", "lat")), base,
        *lags, order=2, method="correlation", kind="tan",
        compute_dtype="float32", batch_size=16, mesh=None)
    return corr, ops, lags, {"step_arcsec": 0.5, "injected_arcsec": [8.0, 0.0]}


def leg_api(sizes, lag_mode):
    from euispice_coreg_tpu.core.header import Header
    from euispice_coreg_tpu.hdrshift import Alignment
    from euispice_coreg_tpu.io import fits

    bench, small, ref, _lon, _lat, base = _pair(sizes)
    n = bench.N_SMALL

    def make_hdr(p):
        return Header({
            "NAXIS1": n, "NAXIS2": n,
            "CRVAL1": p["crval1"] * 3600.0, "CRVAL2": p["crval2"] * 3600.0,
            "CRPIX1": p["crpix1"], "CRPIX2": p["crpix2"],
            "CDELT1": p["cdelt1"] * 3600.0, "CDELT2": p["cdelt2"] * 3600.0,
            "CUNIT1": "arcsec", "CUNIT2": "arcsec",
            "CTYPE1": "HPLN-TAN", "CTYPE2": "HPLT-TAN",
            "CROTA": p["crota"],
            "PC1_1": p["pc11"], "PC1_2": p["pc12"], "PC2_1": p["pc21"],
            "PC2_2": p["pc22"],
        })

    ops = {"small": small, "ref": ref}
    lag = (np.arange(bench.GRID) - bench.GRID // 2) * 0.5
    with tempfile.TemporaryDirectory() as td:
        p_large, p_small = f"{td}/bench_large.fits", f"{td}/bench_small.fits"
        fits.write(p_large, [fits.PrimaryHDU(data=ref.astype(np.float32),
                                             header=make_hdr(base))])
        fits.write(p_small, [fits.PrimaryHDU(data=small.astype(np.float32),
                                             header=make_hdr(base))])
        A = Alignment(
            large_fov_known_pointing=p_large, small_fov_to_correct=p_small,
            lag_crval1=lag, lag_crval2=lag,
            lag_cdelt1=None, lag_cdelt2=None, lag_crota=None,
            small_fov_window=0, large_fov_window=0,
        )
        corr = A.align_using_helioprojective(return_type="corr")
    return (corr, ops, _lags5(lag, lag, [0.0], [0.0], [0.0]),
            {"step_arcsec": 0.5, "injected_arcsec": [8.0, 0.0]})


def leg_mixed(sizes, lag_mode):
    import jax.numpy as jnp

    from euispice_coreg_tpu.engine import lag_search

    _bench_, small, ref, lon, lat, base = _pair(sizes)
    ops = {"small": small, "ref": ref, "lon": lon, "lat": lat}
    step = 1.0 / 3600.0
    lag = (np.arange(21) - 10) * step
    lags = _lags5(lag, lag, [0.0], [0.0], [-0.05, 0.0, 0.05])
    corr = lag_search.evaluate_lag_grid(
        *(jnp.asarray(ops[k].astype(np.float32))
          for k in ("small", "ref", "lon", "lat")), base,
        *lags, order=2, method="correlation", kind="tan",
        compute_dtype="float32", batch_size=16, mesh=None,
        allow_fast="block")
    return corr, ops, lags, {"step_arcsec": 1.0, "injected_arcsec": [8.0, 0.0],
                             "argmax_plane": "crota 0 (index 1)"}


def _imager_paths(td, stem, n_frames, cadence_s, shape):
    import fixtures as fx

    from euispice_coreg_tpu.io import fits
    from euispice_coreg_tpu.utils import timeutils

    paths, data = [], None
    t0p = timeutils.parse_fits_time("2022-03-17T09:45:00")
    for k in range(n_frames):
        hdr = fx.make_header(tuple(shape), (2.4, 2.4), (0.0, 0.0), 0.0)
        hdr["DATE-AVG"] = timeutils.format_fits_time(t0p + cadence_s * k)
        data = fx.render_helioprojective(hdr, seed=0).astype(np.float32)
        p = f"{td}/{stem}_{k}.fits"
        fits.write(p, [fits.PrimaryHDU(data=data, header=hdr)])
        paths.append(p)
    return paths, data


def _spice_file(td, name, true_arcsec, given_arcsec, **kw):
    import fixtures as fx

    from euispice_coreg_tpu.io import fits

    cube = fx.render_spice_l2_cube(
        fx.make_spice_l2_header(crval_arcsec=true_arcsec, **kw))
    cube = cube.astype(np.float32)
    p = f"{td}/{name}"
    fits.write(p, [fits.PrimaryHDU(
        data=cube, header=fx.make_spice_l2_header(crval_arcsec=given_arcsec,
                                                  **kw))])
    return p, cube


def leg_synras(sizes, lag_mode):
    from euispice_coreg_tpu.hdrshift.alignment_spice import AlignmentSpice
    from euispice_coreg_tpu.synras.map_builder import SPICEComposedMapBuilder

    l1, l2 = np.arange(2.0, 15.0, 1.0), np.arange(-10.0, 3.0, 1.0)
    with tempfile.TemporaryDirectory() as td:
        paths, frame = _imager_paths(td, "bench_imager", 5, 90.0,
                                     sizes["IMAGER_SHAPE"])
        p_spice, cube = _spice_file(td, "solo_L2_bench_spice.fits",
                                    (120.0, 80.0), (112.0, 84.0),
                                    nx=96, ny=128)
        builder = SPICEComposedMapBuilder(
            path_to_spectro=p_spice, list_imager_paths=paths,
            threshold_time=900.0, window_imager=0, window_spectro=0)
        raster = builder.process(folder_path_output=td, level=2,
                                 print_filename=False,
                                 return_synras_name=True)
        A = AlignmentSpice(
            large_fov_known_pointing=raster, small_fov_to_correct=p_spice,
            lag_crval1=l1, lag_crval2=l2,
            large_fov_window=0, small_fov_window=0)
        corr = A.align_using_helioprojective(return_type="corr")
    return (corr, {"imager": frame, "cube": cube},
            _lags5(l1, l2, [0.0], [0.0], [0.0]),
            {"imager_frames": 5, "imager_cadence_s": 90.0,
             "injected_arcsec": [8.0, -4.0]})


def leg_iterative(sizes, lag_mode):
    from euispice_coreg_tpu.hdrshift.alignment_spice import \
        AlignementSpiceIterativeContextRaster

    lag = np.arange(-2.0, 3.0, 1.0)
    with tempfile.TemporaryDirectory() as td:
        paths, frame = _imager_paths(td, "bench_it_imager", 2, 150.0,
                                     sizes["IMAGER_SHAPE"])
        p_spice, cube = _spice_file(td, "solo_L2_bench_it_spice.fits",
                                    (122.0, 78.0), (120.0, 80.0))
        A = AlignementSpiceIterativeContextRaster(
            large_fov_list_paths=paths, small_fov_to_correct=p_spice,
            threshold_time=600.0, lag_crval1=lag, lag_crval2=lag,
            large_fov_window=0, small_fov_window=0)
        corr = A.align_using_helioprojective(return_type="corr")
    return (corr, {"imager": frame, "cube": cube},
            _lags5(lag, lag, [0.0], [0.0], [0.0]),
            {"imager_frames": 2, "imager_cadence_s": 150.0,
             "injected_arcsec": [2.0, -2.0]})


def _carr_ref(bench, sizes):
    from euispice_coreg_tpu.engine import carrington as carr

    lon_g, lat_g = carr.carrington_grid(CARR_LONLIMS, CARR_LATLIMS,
                                        tuple(sizes["CARR_SHAPE"]))
    return bench._carr_scene(lon_g, lat_g)


def _carr_engine(sizes, lag_mode, small, hdr, step_arcsec, every=1):
    import jax.numpy as jnp

    from euispice_coreg_tpu.engine import carrington as carr

    bench = _bench(sizes)
    ops = {"small": small, "ref": _carr_ref(bench, sizes)}
    l1 = (np.arange(bench.GRID) - bench.GRID // 2) * step_arcsec / 3600.0
    l1 = l1[::every]
    lags = _lags5(l1, l1, [0.0], [0.0], [0.0])
    kw = {} if lag_mode is None else {"lag_mode": lag_mode}
    corr = carr.evaluate_lag_grid_carrington(
        jnp.asarray(small, dtype=jnp.float32),
        jnp.asarray(ops["ref"], dtype=jnp.float32), hdr,
        CARR_LONLIMS, CARR_LATLIMS, tuple(sizes["CARR_SHAPE"]), *lags,
        d_solar_r=1.004, reference_date=hdr["DATE-OBS"], rate_wave="171",
        order=2, compute_dtype="float32", **kw)
    return corr, ops, lags


def leg_carr(sizes, lag_mode):
    bench = _bench(sizes)
    hdr = bench._carr_header(bench.N_SMALL, 2.0, 150.0, 100.0)
    corr, ops, lags = _carr_engine(sizes, lag_mode, bench._carr_render(hdr),
                                   hdr, 0.5)
    return corr, ops, lags, {"step_arcsec": 0.5, "injected_arcsec": None}


def leg_carr_coarse(sizes, lag_mode, every=1):
    bench = _bench(sizes)
    small = bench._carr_render(bench._carr_header(bench.N_SMALL, 2.0,
                                                  150.0 + 24.0, 100.0))
    hdr = bench._carr_header(bench.N_SMALL, 2.0, 150.0, 100.0)
    corr, ops, lags = _carr_engine(sizes, lag_mode, small, hdr, 2.0, every)
    return corr, ops, lags, {"step_arcsec": 2.0,
                             "injected_arcsec": [24.0, 0.0]}


def leg_carr_api(sizes, lag_mode):
    from euispice_coreg_tpu.hdrshift import Alignment
    from euispice_coreg_tpu.io import fits

    bench = _bench(sizes)
    n = bench.N_SMALL
    small = bench._carr_render(bench._carr_header(n, 2.0, 150.0, 100.0))
    hdr_given = bench._carr_header(n, 2.0, 142.0, 100.0)
    hdr_large = bench._carr_header(n, 2.4, 148.0, 98.0, crota=0.0)
    ops = {"small": small, "large": bench._carr_render(hdr_large)}
    lag = (np.arange(bench.GRID) - bench.GRID // 2) * 0.5
    kw = {} if lag_mode is None else {"lag_search_mode": lag_mode}
    with tempfile.TemporaryDirectory() as td:
        p_large = f"{td}/bench_carr_large.fits"
        p_small = f"{td}/bench_carr_small.fits"
        fits.write(p_large, [fits.PrimaryHDU(
            data=ops["large"].astype(np.float32), header=hdr_large)])
        fits.write(p_small, [fits.PrimaryHDU(
            data=small.astype(np.float32), header=hdr_given)])
        A = Alignment(
            large_fov_known_pointing=p_large, small_fov_to_correct=p_small,
            lag_crval1=lag, lag_crval2=lag,
            small_fov_window=0, large_fov_window=0, **kw)
        corr = A.align_using_carrington(
            lonlims=CARR_LONLIMS, latlims=CARR_LATLIMS,
            shape=tuple(sizes["CARR_SHAPE"]),
            reference_date=bench._CARR_EXTRA["DATE-OBS"], return_type="corr")
    return (corr, ops, _lags5(lag, lag, [0.0], [0.0], [0.0]),
            {"step_arcsec": 0.5, "injected_arcsec": [8.0, 0.0]})


_LEG_FNS = {"core": leg_core, "api": leg_api, "mixed": leg_mixed,
            "synras": leg_synras, "iterative": leg_iterative,
            "carr": leg_carr, "carr_coarse": leg_carr_coarse,
            "carr_api": leg_carr_api}


def compute_leg(leg, sizes=FULL):
    """Run one leg through the JAX package; returns its entry: ``corr``,
    ``route``, ``operands`` ({name: (shape, stats)}), ``lags``,
    ``constants``, ``margin`` and ``seconds`` (the call's wall time)."""
    _setup_jax()
    lag_mode = LAG_MODE.get(leg)
    t0 = time.perf_counter()
    with route_log() as lines:
        corr, ops, lags, consts = _LEG_FNS[leg](sizes, lag_mode)
    seconds = time.perf_counter() - t0
    corr = np.asarray(corr, dtype=np.float64)
    route = " | ".join(lines) or "(no engine route line)"
    if lag_mode is not None:
        route = f"lag_mode={lag_mode}: {route}"
    constants = {k: (list(v) if isinstance(v, tuple) else v)
                 for k, v in sizes.items()}
    constants.update(consts)
    entry = {"corr": corr, "route": route,
             "operands": {k: fingerprint(v) for k, v in ops.items()},
             "lags": lags, "constants": constants,
             "margin": top2_margin(corr), "seconds": seconds}
    if leg in WITNESS:
        with route_log() as lines:
            w = _LEG_FNS[leg](sizes, WITNESS[leg], every=WITNESS_STEP)[0]
        entry["witness"] = {
            "corr": np.asarray(w, dtype=np.float64), "step": WITNESS_STEP,
            "route": f"lag_mode={WITNESS[leg]}: "
                     + (" | ".join(lines) or "(no engine route line)")}
    return entry


def leg_arrays(leg, entry):
    """The npz keys of one leg's entry."""
    out = {f"{leg}.corr": entry["corr"], f"{leg}.route": np.str_(entry["route"]),
           f"{leg}.operands": np.array(sorted(entry["operands"])),
           f"{leg}.constants": np.str_(json.dumps(entry["constants"],
                                                  sort_keys=True)),
           f"{leg}.margin": np.float64(entry["margin"])}
    for name, (shape, stats) in entry["operands"].items():
        out[f"{leg}.op.{name}.shape"] = shape
        out[f"{leg}.op.{name}.stats"] = stats
    for i, lag in enumerate(entry["lags"]):
        out[f"{leg}.lag{i}"] = lag
    if "witness" in entry:
        w = entry["witness"]
        out[f"{leg}.witness.corr"] = w["corr"]
        out[f"{leg}.witness.route"] = np.str_(w["route"])
        out[f"{leg}.witness.step"] = np.int64(w["step"])
    return out


def meta(sizes_name):
    import jax

    return {"jax": jax.__version__, "numpy": np.__version__,
            "x64": bool(jax.config.read("jax_enable_x64")),
            "platform": jax.default_backend(), "sizes": sizes_name}


def write_leg(path, leg, entry, sizes_name):
    """Replace ``leg``'s keys of the npz at ``path`` (created if missing),
    under a lock beside it."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        data = {}
        if os.path.exists(path):
            with np.load(path) as z:
                data = {k: z[k] for k in z.files
                        if not k.startswith(leg + ".")}
        data.update(leg_arrays(leg, entry))
        data["meta"] = np.str_(json.dumps(meta(sizes_name), sort_keys=True))
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, **dict(sorted(data.items())))
        os.replace(tmp, path)
    os.remove(path + ".lock")


def _run_one(leg, out, small):
    sizes_name = "small" if small else "full"
    entry = compute_leg(leg, SMALL if small else FULL)
    write_leg(out, leg, entry, sizes_name)
    print(f"{leg}: {entry['seconds']:.1f} s on this host's CPU "
          f"({os.cpu_count()} cores), route {entry['route']!r}, "
          f"shape {entry['corr'].shape}, margin {entry['margin']:.3e}",
          flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--leg", action="append", choices=LEGS,
                   help="leg to compute (repeatable; default all, in turn)")
    p.add_argument("--out", default=OUT)
    p.add_argument("--small", action="store_true",
                   help="the tests' small sizes instead of bench.py's")
    p.add_argument("--timeout", type=float, default=1800.0,
                   help="seconds a leg may take")
    p.add_argument("--in-process", action="store_true",
                   help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    legs = a.leg or list(LEGS)
    if a.in_process:
        for leg in legs:
            _run_one(leg, a.out, a.small)
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    failed = []
    for leg in legs:
        cmd = [sys.executable, os.path.abspath(__file__), "--in-process",
               "--leg", leg, "--out", a.out] + (["--small"] if a.small else [])
        try:
            subprocess.run(cmd, env=env, check=True, timeout=a.timeout)
        except subprocess.TimeoutExpired:
            print(f"{leg}: not finished within {a.timeout:.0f} s",
                  flush=True)
            failed.append(leg)
        except subprocess.CalledProcessError as exc:
            print(f"{leg}: failed ({exc.returncode})", flush=True)
            failed.append(leg)
    if failed:
        print(f"no reference for: {', '.join(failed)}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
