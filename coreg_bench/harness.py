"""One run of one cell: set-up, the measured window, the traced stretch, the
judgement, and the result line.

Everything that belongs to a configuration, a cell or a metric is data
found by name (:mod:`coreg_bench.discover`); this module holds no cell of
its own.  The program is called only through its public API:
``Alignment``, ``AlignmentResults.return_corrected_header``, the kernel
modules' ``LAUNCHES`` counters and ``utils.obs.collect_stages``; its route
log lines are read from its logger.
"""
from __future__ import annotations

import contextlib
import gc
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from . import discover, inputs, trace
from .reference import judge

FORBIDDEN = ("jax", "jaxlib", "flax", "euispice_coreg_tpu")
PROGRAM_LOGGER = "euispice_coreg_tpu_torch"
RANDOM_LAGS = 128   # lags drawn from the seed for the judgement, per pair
TRACE_SKIP = 2      # files before the traced stretch
TRACE_FILES = 20    # files in the traced stretch
COUNT_STRIDE = 37   # every 37th lag is counted for the rooflines
# where the program keeps the libraries it builds with nvcc
BUILD_DIR = os.path.join(discover.ROOT, "euispice_coreg_tpu_torch", "build")

ROUTE_PREFIXES = ("engine path:", "carrington select:", "auto route:",
                  "carrington tile-FFT", "tile-FFT skipped")


class RouteLog(logging.Handler):
    """Keeps the program's route lines of the current file."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith(ROUTE_PREFIXES):
            self.lines.append(msg)

    def take(self):
        lines, self.lines = self.lines, []
        return lines


def route_of(lines, routes):
    """The route names of a file's route lines under the frame's ``routes``
    (prefix, name); an engine line that none names is kept as logged."""
    found = []
    for line in lines:
        name = next((n for p, n in routes if line.startswith(p)), None)
        if name is None and line.startswith(("engine path:",
                                             "carrington select:")):
            name = line
        if name is not None and name not in found:
            found.append(name)
    return "+".join(found) or "unknown"


def built_libraries():
    """The program's built libraries now in the checkout."""
    try:
        return {f for f in os.listdir(BUILD_DIR) if f.endswith(".so")}
    except FileNotFoundError:
        return set()


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def lags_of(workload, config):
    """The cell's lag axes: (crval1, crval2, cdelt1, cdelt2) in arcsec and
    CROTA in degrees, as the ``Alignment`` call takes them."""
    lg = workload["lags"]
    crval = [(np.arange(lg[k]["n"]) - lg[k]["n"] // 2) * lg[k]["step_arcsec"]
             for k in ("crval1", "crval2")]
    cdelt = config["small"]["cdelt_arcsec"]
    frac = [np.asarray(lg.get(k, [0.0]), dtype=np.float64) * cdelt
            for k in ("cdelt1_frac", "cdelt2_frac")]
    crota = np.asarray(lg.get("crota_deg", [0.0]), dtype=np.float64)
    return crval + frac, crota


def truth_index(error, lags_arcsec, crota):
    """5-D index of the lag nearest the injected error."""
    i1 = int(np.argmin(np.abs(lags_arcsec[0] - error[0])))
    i2 = int(np.argmin(np.abs(lags_arcsec[1] - error[1])))
    zero = [int(np.argmin(np.abs(v))) for v in (lags_arcsec[2],
                                                 lags_arcsec[3], crota)]
    return (i1, i2, *zero)


class Cell:
    """A cell's configuration, workload and the program call of one file."""

    def __init__(self, name, data_root):
        self.name = name
        self.workload = discover.workload(name, data_root)
        self.config = discover.config(self.workload["config"], data_root)
        self.frame = discover.frame(self.config["frame"])
        self.write_pair = getattr(self.frame, "write_pair", inputs.write_pair)
        self.lags_arcsec, self.crota = lags_of(self.workload, self.config)
        self.phases = []  # host seconds of each call's three steps

    def call(self, paths, device):
        """One user's file: Alignment, the search, the corrected header."""
        from euispice_coreg_tpu_torch import Alignment

        l1, l2, l3, l4 = self.lags_arcsec
        mixed = (len(l3) > 1 or len(l4) > 1 or len(self.crota) > 1)
        kw = dict(lag_crval1=l1, lag_crval2=l2, lag_search_mode="auto",
                  small_fov_window=0, large_fov_window=0, device=device,
                  reprojection_order=self.config["reprojection_order"],
                  compute_dtype=self.config["compute_dtype"])
        if mixed:
            kw.update(lag_cdelt1=l3, lag_cdelt2=l4, lag_crota=self.crota)
        t0 = time.perf_counter()
        with torch.profiler.record_function("Alignment()"):
            a = Alignment(large_fov_known_pointing=paths[0],
                          small_fov_to_correct=paths[1], **kw)
        t1 = time.perf_counter()
        with torch.profiler.record_function(
                f"align_using_{self.config['frame']}"):
            res = self.frame.align(a, self.config)
        t2 = time.perf_counter()
        with torch.profiler.record_function("return_corrected_header"):
            hdr = res.return_corrected_header(0)
        self.phases.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
        return res, {k: float(hdr[k]) for k in judge.HEADER_KEYS}

    def reference(self, pair, device, dtype=torch.float64):
        """The plain reference of one pair (the frame's, on
        module reference.hypercube)."""
        lags_deg = [v / 3600.0 for v in self.lags_arcsec] + [self.crota]
        return self.frame.reference(self.config, pair, lags_deg, device,
                                    dtype)

    def route(self, lines):
        return route_of(lines, self.frame.ROUTES)

    def sample(self, seed, k, error):
        shape = tuple(len(v) for v in self.lags_arcsec) + (len(self.crota),)
        return judge.sample_lags(
            shape, truth_index(error, self.lags_arcsec, self.crota),
            truth_index((0.0, 0.0), self.lags_arcsec, self.crota),
            RANDOM_LAGS,
            inputs.pair_rng(seed, k, "sample"))

    def judge_answers(self, pairs, answers, seed, device, dtype=torch.float64):
        """The three numbers, each the largest over every answer, and the
        first pair's reference (the roofline counts read it); the others
        are built one pair at a time and freed."""
        worst = {k: 0.0 for k in judge.NUMBERS}
        refs = {}
        by_pair = {}
        for ans in answers:
            by_pair.setdefault(ans["pair"], []).append(ans)
        for k, group in sorted(by_pair.items()):
            ref = self.reference(pairs[k], device, dtype)
            sample = self.sample(seed, k, pairs[k]["error"])
            for ans in group:
                nums = judge.judge(ref, ans["scores"], ans["argmax"],
                                   ans["header"], sample, self.lags_arcsec,
                                   self.crota, pairs[k]["hdr_small"])
                for key, v in nums.items():
                    worst[key] = max(worst[key], v)
            if not refs:
                refs[k] = ref
            del ref
        return worst, refs


def port_answer(k, res, header):
    corr = res.corr

    def scores(idx):
        idx = np.atleast_2d(idx)
        return corr[tuple(idx.T) + (0,)]

    return {"pair": k, "scores": scores, "argmax": tuple(res.max_index[:5]),
            "header": header}


def card_info(device):
    """Name, power limit and count of the card(s) the run uses."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "not read"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "power_limit": limit}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name, seed, seconds, trace_on, *, t0, device="cuda",
             bench=None, data_root=None, out=sys.stdout, err=sys.stderr):
    """Run the cell once; returns the result dict (the last line).  The
    caller has checked the card (``main``)."""
    from euispice_coreg_tpu_torch.engine import quad_score, warp_score
    from euispice_coreg_tpu_torch.utils import obs

    libraries = built_libraries()
    bench = bench or discover.benchmark()
    cell = Cell(name, data_root)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    wl = cell.workload
    log = RouteLog()
    plog = logging.getLogger(PROGRAM_LOGGER)
    plog.addHandler(log)
    plog.setLevel(logging.INFO)
    tmp = tempfile.mkdtemp(prefix="coreg_bench_")
    try:
        # set-up: render and write the pairs, warm up on pair 0
        pairs = [inputs.make_pair(cell.config, wl, seed, k, dev)
                 for k in range(wl["pairs"])]
        paths = [cell.write_pair(p, tmp, k) for k, p in enumerate(pairs)]
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        cell.call(paths[0], dev)
        _sync(dev)
        warm_route = cell.route(log.take())
        setup_s = time.perf_counter() - t0
        built = sorted(built_libraries() - libraries)
        print(f"[coreg_bench] {name}: set-up {setup_s:.3f} s, warm-up route "
              f"{warm_route}, built in set-up: {built or 'nothing'}",
              file=out, flush=True)
        cell.phases.clear()

        answers, durations, routes = [], [], {}
        failures = []
        n_trace = TRACE_FILES if trace_on else 0
        skip = TRACE_SKIP
        traced = {}
        stack = contextlib.ExitStack()
        launches0 = (warp_score.LAUNCHES, quad_score.LAUNCHES)
        t_start = time.perf_counter()
        t_end = t_start + seconds
        i, done = 0, False
        while not done:
            if trace_on and i == skip:
                traced["stages"] = stack.enter_context(obs.collect_stages())
                traced["prof"] = stack.enter_context(torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]
                    + ([torch.profiler.ProfilerActivity.CUDA]
                       if dev.type == "cuda" else [])))
                traced["launches"] = (warp_score.LAUNCHES,
                                      quad_score.LAUNCHES)
            k = (i + 1) % len(pairs)
            f0 = time.perf_counter()
            try:
                with torch.profiler.record_function(trace.FILE_SPAN):
                    res, header = cell.call(paths[k], dev)
                    _sync(dev)
                answers.append(port_answer(k, res, header))
            except Exception:  # a file that raises is attempted and failed
                failures.append(traceback.format_exc(limit=4))
            durations.append(time.perf_counter() - f0)
            r = cell.route(log.take())
            routes[r] = routes.get(r, 0) + 1
            i += 1
            now = time.perf_counter()
            done = now >= t_end
            if "prof" in traced and "files" not in traced \
                    and (i == skip + n_trace or done):
                # the traced stretch ends after n_trace files, or with the
                # window where that comes first
                traced["files"] = i - skip
                traced["launches"] = (warp_score.LAUNCHES - traced["launches"][0],
                                      quad_score.LAUNCHES - traced["launches"][1])
                stack.close()
        window_s = now - t_start
        launches = (warp_score.LAUNCHES - launches0[0],
                    quad_score.LAUNCHES - launches0[1])
        memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)
        found = forbidden_modules()
        if found:
            raise SystemExit(f"loaded in the run's process: {found}")
        if durations:
            q = np.percentile(durations, [0, 50, 85, 100])
            print(f"[coreg_bench] {name}: file seconds min {q[0]:.4f}, median "
                  f"{q[1]:.4f}, p85 {q[2]:.4f}, max {q[3]:.4f}; window "
                  f"{time.perf_counter() - t_start:.3f} s", file=out,
                  flush=True)
        if cell.phases:
            q = np.percentile(np.array(cell.phases), [25, 50, 75], axis=0)
            print(f"[coreg_bench] {name}: host seconds a file, quartiles: "
                  + "; ".join(f"{step} {q[0, j]:.4f} {q[1, j]:.4f} "
                              f"{q[2, j]:.4f}" for j, step in enumerate(
                                  ("Alignment()", "align_using_*",
                                   "return_corrected_header"))),
                  file=out, flush=True)
        print(f"[coreg_bench] {name}: routes {routes} (cell route "
              f"{wl['route']}); K1 launches {launches[0]}, K2 launches "
              f"{launches[1]} over {i} files", file=out, flush=True)

        run = {"setup_s": setup_s, "window_s": window_s, "attempted": i,
               "completed": len(answers), "file_seconds": durations}
        reduced = None
        if trace_on and "prof" in traced:
            host, devev = trace.split_events(traced["prof"].events())
            reduced = trace.reduce(host, devev)
            del traced["prof"]

        # the judgement, after the window and the memory reading
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        worst, refs = cell.judge_answers(pairs, answers, seed, dev)
        limits = wl["limits"]
        correct = not failures and bool(answers) and all(
            worst[k] <= limits[k] for k in judge.NUMBERS)

        result_metrics = {}
        card = card_info(dev)
        device_rec = {"platform": card["platform"], "kind": card["kind"],
                      "count": 1, "memory_peak_bytes": int(memory_peak)}
        result = {"correct": correct, "attempted": i,
                  "failed": len(failures)}
        if trace_on:
            rec = {"stages": traced.get("stages", {}),
                   "files": traced.get("files", 0),
                   "launches": {"K1": traced.get("launches", (0, 0))[0],
                                "K2": traced.get("launches", (0, 0))[1]},
                   "kernels": (reduced or {}).get("kernels", {}),
                   "busy_s": (reduced or {}).get("busy_s", 0.0),
                   "window_s": (reduced or {}).get("window_s", 0.0),
                   "counts": _counter(refs), "run": run}
            names = discover.metrics_for(bench, name, "per_layer")
            if reduced:
                device_rec.update(busy_s=reduced["busy_s"],
                                  window_s=reduced["window_s"])
        else:
            rec = {"run": run}
            names = discover.metrics_for(bench, name, "end_to_end")
        for metric in names:
            value = discover.reader(metric["name"])(rec)
            if value is not None and math.isfinite(value):
                result_metrics[metric["name"]] = {"value": value,
                                                  "unit": metric["unit"]}
        result["metrics"] = result_metrics
        result["device"] = device_rec
        if trace_on and reduced:
            result["breakdown"] = reduced["breakdown"]
        result["compiled"] = bool(built)  # this run's set-up built K1/K2
        # a lag scored on one side only reads inf: printed as 1e300
        result["checks"] = {k: {"value": min(worst[k], 1e300),
                                "limit": limits[k]} for k in judge.NUMBERS}
        for f in failures[:3]:
            print(f"[coreg_bench] a file raised:\n{f}", file=err)
        print(f"[coreg_bench] card: {card.get('kind')}, power limit "
              f"{card.get('power_limit', 'n/a')}", file=out, flush=True)
        for k in judge.NUMBERS:
            print(f"check {k}: {worst[k]!r} limit {limits[k]!r}", file=err)
        err.flush()
        return result
    finally:
        plog.removeHandler(log)
        shutil.rmtree(tmp, ignore_errors=True)


def _counter(refs):
    """Lazy counts of a kernel's work in this cell, for the roofline
    readers: the reference's finite pixels and finite pixel-lags of the
    first judged pair, on every ``COUNT_STRIDE``-th lag of the grid."""
    memo = {}

    def counts(kernel):
        if kernel in memo:
            return memo[kernel]
        k = min(refs) if refs else None
        if k is None:
            return None
        ref = refs[k]
        shape = ref.shape
        n = int(np.prod(shape))
        flat = np.arange(0, n, COUNT_STRIDE)
        idx = np.stack(np.unravel_index(flat, shape), axis=-1)
        ref.r(idx)
        summed = np.mean([ref.pairs[tuple(int(v) for v in row)]
                          for row in idx])
        h, w = ref.ref.shape
        memo[kernel] = {"h": h, "w": w, "n_ref": ref.n_ref(), "n_lags": n,
                        "n_summed": float(summed) * n}
        return memo[kernel]

    return counts


def check_card(chips):
    """Exit without a result unless ``chips`` CUDA cards are there."""
    if not torch.cuda.is_available():
        raise SystemExit("coreg_bench: no CUDA card (torch.cuda.is_available()"
                         " is false); no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"coreg_bench: the cell asks for {chips} card(s), "
                         f"{torch.cuda.device_count()} found")


def main(argv, t0):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = discover.benchmark()
    entry = discover.cell_entry(bench, args.workload)
    check_card(entry["chips"])
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t0=t0, bench=bench)
    print(json.dumps(result, allow_nan=True), flush=True)
    return 0
