#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's, and the control's.

    python3 coreg_bench/control.py --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...]

For each of ``--seeds`` the cell's pairs are rendered and written as a run
makes them, the program aligns each pair once (after one warm-up call) and
every answer is judged as a run judges it: the lower readings.  For each of
``--control-seeds`` the control takes the program's place: the benchmark's
reference computed one precision below the configuration's float32, in
bfloat16 (its probe fit in float32), judged against the float64 reference:
the upper readings.  One JSON line per seed and side, each with
``correct`` as a run decides it from the cell's ``limits`` (the control's
has to read false), then a summary line with each number's largest program
reading and smallest control reading.
The benchmark's own runs never run the control.  Needs the cell's card.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT

import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402

import torch  # noqa: E402

from coreg_bench import harness  # noqa: E402
from coreg_bench.reference import judge  # noqa: E402


def program_readings(cell, seed, device, tmp):
    """The judged numbers of the program's answer for every pair of
    ``seed``, and the routes it took."""
    pairs = [cell.make_pair(cell.config, cell.workload, seed, k, device)
             for k in range(cell.workload["pairs"])]
    paths = [cell.write_pair(p, tmp, k) for k, p in enumerate(pairs)]
    log = harness.RouteLog()
    plog = harness.logging.getLogger(harness.PROGRAM_LOGGER)
    plog.addHandler(log)
    plog.setLevel(harness.logging.INFO)
    try:
        answers, routes = [], []
        for k, p in enumerate(paths):
            res, header = cell.call(p, device)
            answers.append(harness.port_answer(k, res, header))
            routes.append(cell.route(log.take()))
    finally:
        plog.removeHandler(log)
    worst, _ = cell.judge_answers(pairs, answers, seed, device)
    return worst, routes


def control_readings(cell, seed, device, dtype=torch.bfloat16):
    """The judged numbers of the control's answers for every pair of
    ``seed``."""
    worst = {k: 0.0 for k in judge.NUMBERS}
    for k in range(cell.workload["pairs"]):
        pair = cell.make_pair(cell.config, cell.workload, seed, k, device)
        sample = cell.sample(seed, k, pair["error"])
        ctrl = cell.reference(pair, device, dtype)
        ans = judge.ControlAnswer(ctrl, sample, cell.lags_arcsec, cell.crota,
                                  pair["hdr_small"])
        del ctrl
        ref = cell.reference(pair, device)
        nums = judge.judge(ref, ans.scores, ans.argmax, ans.header, sample,
                           cell.lags_arcsec, cell.crota, pair["hdr_small"])
        for key, v in nums.items():
            worst[key] = max(worst[key], v)
    return worst


def verdict(cell, nums):
    """``correct`` of these judged numbers under the cell's limits, as
    :func:`harness.run_cell` decides it."""
    limits = cell.workload["limits"]
    return all(nums[k] <= limits[k] for k in judge.NUMBERS)


def main(argv=None, device="cuda", data_root=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if device == "cuda":
        harness.check_card(1)
    dev = torch.device(device)
    cell = harness.Cell(args.workload, data_root)
    tmp = tempfile.mkdtemp(prefix="coreg_bench_control_")
    low = {k: 0.0 for k in judge.NUMBERS}
    high = {k: float("inf") for k in judge.NUMBERS}
    try:
        if args.seeds:
            warm = cell.make_pair(cell.config, cell.workload, 1, 0, dev)
            cell.call(cell.write_pair(warm, tmp, 0), dev)
        for seed in args.seeds:
            t = time.perf_counter()
            nums, routes = program_readings(cell, seed, dev, tmp)
            print(json.dumps({"who": "program", "seed": seed, **nums,
                              "correct": verdict(cell, nums),
                              "routes": routes,
                              "s": time.perf_counter() - t}), flush=True)
            low = {k: max(low[k], nums[k]) for k in low}
        for seed in args.control_seeds:
            t = time.perf_counter()
            nums = control_readings(cell, seed, dev)
            print(json.dumps({"who": "control", "seed": seed, **nums,
                              "correct": verdict(cell, nums),
                              "s": time.perf_counter() - t}), flush=True)
            high = {k: min(high[k], nums[k]) for k in high}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"workload": args.workload, "program_max": low,
                      "control_min": high,
                      "limits": cell.workload["limits"],
                      "card": harness.card_info(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
