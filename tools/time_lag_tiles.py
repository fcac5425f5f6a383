#!/usr/bin/env python3
"""Time builds of K1 and K2 (the port's CUDA kernels) on one CUDA card, and
count the instructions of their main loops.

    python3 tools/time_lag_tiles.py [--lag-tiles 1 2 3 4 8]
    python3 tools/time_lag_tiles.py --package-root DIR

Run from the root of a checkout on a machine with a CUDA card and nvcc.  By
default it builds ``csrc/warp_score.cu`` and ``csrc/quad_score.cu`` once per
lag tile, all builds in parallel, into the package's git-ignored build
directory: a copy of ``csrc/`` whose ``constexpr int kLagTile = ...;`` line
is set to the lag tile, compiled with ``engine/_build.py``'s nvcc flags.
For each build it prints the registers, shared memory and spills of every
kernel instantiation (``-Xptxas -v``) and the instruction mix of the main
loop of the float32, order-2 kernel (K2 correlation, K1 TAN); then it has
the package's wrappers launch that build, checks it against the plain
versions (K1 at 2048^2 x 1323 lags, K2 at 2048^2 x 441 lags: r within
1e-5, argmax equal) and times it (CUDA events, order 2, float32) at the
shapes ``chip_smoke.py`` times, each beside its bound and, where every warp
scores every lag, beside its instruction-issue ceiling.

With ``--package-root DIR`` it imports ``euispice_coreg_tpu_torch`` from
DIR instead (an earlier checkout), times its default builds the same way,
and counts the instructions of DIR's sources.  To compare two trees on one
card, run parent, change, change, parent in one command.

The instruction mix.  The loop over a thread's pixels is the kernel's
longest backward branch.  A pixel passes through it once for all the lags
of its lag tile (one lag for a build without lag tiles), so the loop's
instructions over the lag tile are those of one pixel-lag, the per-pixel
work shared out.  Regions that a forward branch jumps over around an inner
loop (the slow path of the sine and cosine for huge arguments, never taken
here) are left out.  Each class's time is its instructions per pixel-lag x
the pixel-lags / 32 lanes / (SMs x its rate x the card's highest SM clock),
with rates in warp-instructions per clock per SM: issue 4 (one per
scheduler, every instruction), float32 add, multiply and FMA 4, float64 2,
integer, logic, compares and selects 2, conversions 0.5, special functions
(MUFU) 0.5 (the CUDA C++ Programming Guide's arithmetic-throughput table,
compute capability 9.0), loads and stores 1 (an assumption).  A static
count is no counter: it is what the loop issues when every lane runs every
instruction once.

The operands, lag grids, bounds and timer are ``chip_smoke.py``'s.  The
last line is one JSON object with every timing and count.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = {"warp_score": "K1", "quad_score": "K2"}
LAG_TILE_LINE = re.compile(r"constexpr int kLagTile = \d+;")
# the float32, order-2 kernel of each library: K2 correlation, K1 TAN
MAIN_KERNEL = re.compile(r"(quad|warp)_score_kernelIfLi2ELi0E")
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)"
                       r"[^;]*;")
BRANCH_TARGET = re.compile(r"\bBRA\b[^;]*?0x([0-9a-f]+)")
# instruction classes: (rate in warp-instructions per clock per SM, opcodes)
CLASSES = {
    "fp32": (4, {"FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I",
                 "HFMA2"}),
    "fp64": (2, {"DADD", "DMUL", "DFMA"}),
    "int": (2, {"IADD3", "IMAD", "LEA", "SHF", "LOP3", "ISETP", "SEL",
                "IABS", "IMNMX", "PRMT", "MOV", "VIADD", "FSETP", "FSEL",
                "FMNMX", "DSETP", "PLOP3", "CS2R", "S2R", "P2R", "R2P"}),
    "conversion": (0.5, {"F2I", "I2F", "I2FP", "F2F", "FRND", "F2FP"}),
    "mufu": (0.5, {"MUFU"}),
    "memory": (1, {"LDG", "LDS", "STS", "STG", "LD", "ST", "LDC", "ATOM",
                   "RED"}),
}
ISSUE_RATE = 4


def load_file(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def nvcc(build, src, lib):
    """Compiles ``src`` into ``lib`` with the package's flags; returns
    nvcc's ``-Xptxas -v`` report."""
    proc = subprocess.run(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
         src], capture_output=True, text=True, check=True)
    return proc.stdout + proc.stderr


def variant_csrc(build, lag_tile):
    """A copy of ``csrc/`` in the build directory with each kernel's lag
    tile set to ``lag_tile``."""
    out = os.path.join(build.BUILD_DIR, "lag_tiles", f"lt{lag_tile}")
    shutil.copytree(build.CSRC_DIR, out, dirs_exist_ok=True)
    for name in NAMES:
        path = os.path.join(out, f"{name}.cu")
        with open(path) as f:
            text, n = LAG_TILE_LINE.subn(
                f"constexpr int kLagTile = {lag_tile};", f.read())
        if n != 1:
            raise RuntimeError(f"{path}: expected one kLagTile line, got {n}")
        with open(path, "w") as f:
            f.write(text)
    return out


def main_loop_mix(build, lib, lag_tile):
    """Instructions per pixel-lag of the main kernel's pixel loop, by class
    (see the module note), from ``cuobjdump -sass``."""
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    funcs = text.split("Function : ")[1:]
    listing = next(f for f in funcs if MAIN_KERNEL.search(f.split("\n")[0]))
    ins, branches = [], []
    for line in listing.splitlines():
        m = SASS_LINE.search(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        ins.append((addr, m.group(2)))
        t = BRANCH_TARGET.search(line)
        if t:
            branches.append((addr, int(t.group(1), 16)))
    back = [(a, t) for a, t in branches if t < a]
    end, start = max(back, key=lambda b: b[0] - b[1])
    cold = []
    for a, t in back:
        if start < t and a < end:  # an inner loop: skip what jumps over it
            over = [(b, u) for b, u in branches if start <= b < t and u > a]
            if over:
                b, u = max(over)
                cold.append((b, u))
    body = [op for addr, op in ins if start <= addr <= end
            and not any(b < addr < u for b, u in cold)]
    counts = collections.Counter(body)
    per = {c: sum(counts[o] for o in ops) / lag_tile
           for c, (_, ops) in CLASSES.items()}
    per["issue"] = len(body) / lag_tile
    return {"per_pixel_lag": per, "loop_instructions": len(body),
            "calls_in_loop": counts["CALL"], "cold_regions": len(cold),
            "opcodes": dict(counts.most_common())}


def ceilings(mix, pixel_lags, sms, clock_hz):
    """Milliseconds of each class's (and the issue) ceiling."""
    rates = {c: r for c, (r, _) in CLASSES.items()}
    rates["issue"] = ISSUE_RATE
    return {c: mix["per_pixel_lag"][c] * pixel_lags / 32
            / (sms * rates[c] * clock_hz) * 1e3 for c in rates}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lag-tiles", type=int, nargs="+",
                    default=[1, 2, 3, 4, 8])
    ap.add_argument("--package-root", default=None,
                    help="import euispice_coreg_tpu_torch from this "
                         "checkout instead and time its default builds")
    args = ap.parse_args()
    root = os.path.abspath(args.package_root or REPO)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    smoke = load_file("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    card = smoke.phase_device()
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smoke.log(f"[card] {sms} SMs, highest SM clock {clock_mhz:g} MHz")
    from euispice_coreg_tpu_torch.engine import _build, quad_score, warp_score

    # this checkout's report parser (an earlier checkout may have none)
    here = load_file("build_here", os.path.join(
        REPO, "euispice_coreg_tpu_torch", "engine", "_build.py"))
    out_dir = os.path.join(_build.BUILD_DIR, "lag_tiles")
    os.makedirs(out_dir, exist_ok=True)
    if args.package_root:
        jobs = {("parent", name): (os.path.join(_build.CSRC_DIR,
                                                f"{name}.cu"), 1)
                for name in NAMES}
    else:
        dirs = {k: variant_csrc(_build, k) for k in args.lag_tiles}
        jobs = {(f"LT {k}", name): (os.path.join(dirs[k], f"{name}.cu"), k)
                for k in args.lag_tiles for name in NAMES}

    def compile_job(key):
        label, name = key
        lib = os.path.join(out_dir, f"lib{name}-{label.replace(' ', '')}.so")
        return lib, nvcc(_build, jobs[key][0], lib)

    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(compile_job, jobs)))
    mixes = {}
    for (label, name), (lib, report) in built.items():
        smoke.log_ptxas(f"[build] {label} {NAMES[name]}",
                        here.parse_ptxas(report))
        mix = main_loop_mix(_build, lib, jobs[(label, name)][1])
        mixes[(label, name)] = mix
        smoke.log(f"[sass] {label} {NAMES[name]}: "
                  f"{mix['loop_instructions']} loop instructions, per "
                  f"pixel-lag " + ", ".join(
                      f"{c} {v:.2f}" for c, v in mix["per_pixel_lag"].items())
                  + f"; {mix['calls_in_loop']} calls, "
                  f"{mix['cold_regions']} cold regions left out")

    dev = torch.device("cuda")
    n = smoke.N
    canvas1, ref1, lon, lat, base, _ = smoke.kernel_operands(n, "tan", dev,
                                                             seed=1)
    k1_tables = [torch.as_tensor(warp_score.lag_table(base, g),
                                 dtype=torch.float32, device=dev)
                 for g in (smoke.slice_b_lags(), smoke.slice_d_lags())]
    warped, ref = smoke.k2_operands(n, dev, seed=5)
    canvas2, ref2 = quad_score.quad_canvases(warped, ref,
                                             method="correlation")
    k2_tables = [torch.as_tensor(
        quad_score.coeff_table(smoke.k2_grid_coeffs(side, step)),
        dtype=torch.float32, device=dev) for side, step in smoke.K2_GRIDS]
    kw1 = dict(pad=warp_score.PAD, order=2, kind="tan")
    kw2 = dict(pad=quad_score.PAD, order=2, method="correlation")
    want1 = warp_score.pearson_from_sums(warp_score.warp_score_sums_reference(
        canvas1, ref1, lon, lat, k1_tables[0], **kw1).cpu().numpy())
    want2 = warp_score.pearson_from_sums(
        quad_score.quad_score_sums_reference(canvas2, ref2, k2_tables[0],
                                             **kw2).cpu().numpy())
    n_ref1 = int(torch.isfinite(ref1).sum())
    n_ref2 = int(torch.isfinite(ref2).sum())

    def plain1(t):
        return warp_score.warp_score_sums_reference(canvas1, ref1, lon, lat,
                                                    t, **kw1)

    def plain2(t):
        return quad_score.quad_score_sums_reference(canvas2, ref2, t, **kw2)

    def against_issue(timing, key, n_ref):
        c = ceilings(mixes[key], n_ref * timing["lags"], sms,
                     clock_mhz * 1e6)
        top = max((k for k in c if k != "issue"), key=c.get)
        timing.update(ceilings_ms=c, issue_share=c["issue"] / timing["ms"])
        smoke.log(f"[sass]   issue ceiling {c['issue']:.3f} ms (share "
                  f"{timing['issue_share']:.3f}); largest class {top} "
                  f"{c[top]:.3f} ms; " + ", ".join(
                      f"{k} {v:.3f}" for k, v in c.items() if k != top))

    results = {"card": card, "sms": sms, "sm_clock_mhz": clock_mhz,
               "package_root": root, "builds": {}}
    for label in dict.fromkeys(label for label, _ in jobs):
        for name in NAMES:
            _build._loaded[name] = ctypes.CDLL(built[(label, name)][0])
        got1 = warp_score.pearson_from_sums(warp_score.warp_score_sums(
            canvas1, ref1, lon, lat, k1_tables[0], **kw1).cpu().numpy())
        got2 = warp_score.pearson_from_sums(quad_score.quad_score_sums(
            canvas2, ref2, k2_tables[0], **kw2).cpu().numpy())
        err1 = float(np.max(np.abs(got1 - want1)))
        err2 = float(np.max(np.abs(got2 - want2)))
        ok = (err1 <= smoke.TOL and err2 <= smoke.TOL
              and np.nanargmax(got1) == np.nanargmax(want1)
              and np.nanargmax(got2) == np.nanargmax(want2))
        smoke.log(f"[{label}] against the plain versions: K1 |dr| "
                  f"{err1:.2e}, K2 |dr| {err2:.2e}, argmax equal {ok}")
        if not ok:
            raise AssertionError(f"{label} disagrees with the plain versions")
        timings = []
        for (_, step), table in zip(smoke.K2_GRIDS, k2_tables):
            timings.append(smoke.time_against_bound(
                f"{label} K2 {n}^2 x {table.shape[0]} lags at {step:g} px",
                "K2",
                lambda: quad_score.quad_score_sums(canvas2, ref2, table,
                                                   **kw2),
                plain2, (canvas2, ref2, table), n_ref2, repeat=3))
            if step <= 1.0:  # every warp scores every lag
                against_issue(timings[-1], (label, "quad_score"), n_ref2)
        for table in k1_tables:
            timings.append(smoke.time_against_bound(
                f"{label} K1 {n}^2 x {table.shape[0]} lags", "K1 tan",
                lambda: warp_score.warp_score_sums(canvas1, ref1, lon, lat,
                                                   table, **kw1),
                plain1, (canvas1, ref1, lon, lat, table), n_ref1, repeat=3))
            against_issue(timings[-1], (label, "warp_score"), n_ref1)
        results["builds"][label] = {
            "k1_err": err1, "k2_err": err2, "timings": timings,
            "mix": {NAMES[name]: mixes[(label, name)] for name in NAMES}}
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
