"""Helpers of the benchmark's CPU tests: tiny cells under ``data/`` run
through the harness on the CPU, where the program's kernels run their plain
versions.  Run the tests from the repo root:
``python -m pytest --noconftest -p no:cacheprovider coreg_bench/tests -q``."""
import copy
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TINY = ("tiny_helio", "tiny_carr")


def tiny_bench(extra_cells=TINY):
    """BENCHMARK.json with the tiny cells added to every metric's list."""
    from coreg_bench import discover

    bench = copy.deepcopy(discover.benchmark())
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if "workloads" in m:
                m["workloads"].extend(extra_cells)
    for name in extra_cells:
        bench["workloads"].append({"name": name, "config": name,
                                   "traffic": name, "chips": 1,
                                   "why": "test fixture"})
    return bench


def run_tiny(name, trace=False, seed=4242424242, seconds=None, data=DATA,
             bench=None):
    """One run of a tiny cell on the CPU; a traced run's window is long
    enough to pass the files before the traced stretch."""
    from coreg_bench import harness

    if seconds is None:
        seconds = 6.0 if trace else 1.0
    return harness.run_cell(name, seed, seconds, trace,
                            t0=time.perf_counter(), device="cpu",
                            bench=bench or tiny_bench(), data_root=data)


@pytest.fixture(scope="session")
def tiny_results():
    """One untraced and one traced run of each tiny cell, shared."""
    return {(name, trace): run_tiny(name, trace)
            for name in TINY for trace in (False, True)}
