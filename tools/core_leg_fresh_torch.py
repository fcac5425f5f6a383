#!/usr/bin/env python3
"""The bench's core leg, run after run in fresh processes: each run's
seconds and stage clocks, beside host probes of the process.

    python3 tools/core_leg_fresh_torch.py

Runs from the root of a checkout on a machine with a CUDA card.
``PROCESSES`` new Python processes, their modes in turns (default,
settled, settled, default, ...), each render
``bench_torch.synthesize_pair`` on the card and run the core leg's
engine call (``bench_torch.run_core``: 121x121 CRVAL lags on the 2048^2
pair, FFT path) ``RUNS`` times in a row, each run under
``obs.collect_stages()`` and ending with the hypercube on the host and
the device synchronized.  Per run it prints the seconds and the stage
clocks (host prep, the surfaces with their readout to the host, the host
combine).  Mode ``settled`` calls :func:`settle_host_heap` first;
``default`` leaves the C library's allocator as a fresh process has it.
Before the leg each process times two host probes: filling 64 MiB of new
numpy blocks of 8 MiB, twice (the second time after freeing the first
blocks: pages touched for the first time against reused ones), and the
host combine alone (``fast_corr._combine_scores`` on a fixed 66 x 14641
surface array, the core leg's shape, five times), and counts the CPUs it
may run on.

``bench_torch.timed_best`` warms once and keeps the best of the next two
runs, so runs 2 and 3 here are the ones the bench's core leg reports.
Prints one JSON line per process, then the card's nvidia-smi line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("default", "settled")
PROCESSES = 8
RUNS = 4

# glibc's mallopt parameters
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_MMAP_THRESHOLD_MAX = 32 << 20   # the largest mmap threshold glibc takes
HEAP_MIB = 256


def settle_host_heap(mib=HEAP_MIB):
    """Give the process's host heap ``mib`` MiB of pages it has touched.
    glibc's ``malloc`` maps a fresh process's multi-MB buffers into pages
    that the kernel zeroes on their first touch, until its adaptive
    thresholds and the heap's free space have grown.  This fixes the mmap
    threshold at its largest and the trim threshold above ``mib``, then
    touches and frees ``mib`` MiB in blocks under the threshold.  Returns
    False, changing nothing, where the C library has no ``mallopt``."""
    import numpy as np

    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = (ctypes.c_int, ctypes.c_int)
    mallopt.restype = ctypes.c_int
    if not (mallopt(_M_MMAP_THRESHOLD, _MMAP_THRESHOLD_MAX)
            and mallopt(_M_TRIM_THRESHOLD, 2 * mib << 20)):
        return False
    block = _MMAP_THRESHOLD_MAX // 2
    blocks = [np.ones(block // 8) for _ in range((mib << 20) // block)]
    del blocks
    return True


def host_probes(fast_corr):
    """The first-touch and combine probes (ms), and the CPUs the process
    may run on."""
    import numpy as np

    touch = []
    for _ in range(2):
        t0 = time.perf_counter()
        blocks = [np.empty(1 << 20) for _ in range(8)]
        for b in blocks:
            b.fill(1.0)
        touch.append(round((time.perf_counter() - t0) * 1e3, 2))
        del blocks
    rng = np.random.default_rng(0)
    S = rng.normal(size=(66, 121 * 121))
    dfrac = rng.uniform(-0.5, 0.5, size=(121 * 121, 2))
    combine = []
    for _ in range(5):
        t0 = time.perf_counter()
        fast_corr._combine_scores(S, dfrac, 2, "pearson")
        combine.append(round((time.perf_counter() - t0) * 1e3, 2))
    return {"touch_64mib_ms": touch, "combine_ms": combine,
            "cpus": len(os.sched_getaffinity(0))}


def child(mode, runs, device):
    """One fresh process: the core leg ``runs`` times; prints its JSON
    line."""
    sys.path.insert(0, REPO)
    import torch

    import bench_torch
    from euispice_coreg_tpu_torch.engine import fast_corr
    from euispice_coreg_tpu_torch.utils import obs
    from euispice_coreg_tpu_torch.utils.torchcfg import resolve_device

    settled = settle_host_heap() if mode == "settled" else None
    probes = host_probes(fast_corr)
    dev = resolve_device(device)
    small, ref, lon, lat, base = bench_torch.synthesize_pair(dev)
    ops = [t.to(torch.float32) for t in (small, ref, lon, lat)]
    rows = []

    def every_run(run, n=2):
        result = None
        for _ in range(runs):
            with obs.collect_stages() as st:
                t0 = time.perf_counter()
                result = run()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            rows.append({"s": round(dt, 4),
                         "stages_ms": {k: round(v * 1e3, 2)
                                       for k, v in st.items()}})
        return min(r["s"] for r in rows), {}, result

    bench_torch.timed_best = every_run
    _, _, err = bench_torch.run_core(*ops, base, dev)
    print(json.dumps({"mode": mode, "settled": settled, "error": err,
                      "probes": probes, "runs": rows}), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--child", choices=MODES,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        child(args.child, RUNS, "cuda")
        return 0
    failed = 0
    for k in range(PROCESSES):
        mode = MODES[(k + 1) // 2 % 2]
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", mode],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            failed += 1
            print(f"# {mode}: exit {out.returncode}\n{out.stderr[-4000:]}",
                  file=sys.stderr)
            continue
        print(out.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
