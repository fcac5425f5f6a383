"""Finds the benchmark's data by name.

* ``BENCHMARK.json`` at the checkout's root lists the cells and metrics;
* ``coreg_bench/configs/<config>.json`` is a deployment;
* ``coreg_bench/workloads/<cell>.json`` is a cell's traffic, route and limits;
* ``coreg_bench/metrics/<metric>.py`` reads one metric: a function
  ``read(rec)`` of the run's records, which returns a number or None when
  the run holds nothing for it to read;
* ``coreg_bench/frames/<frame>.py`` is the frame a configuration names:
  ``render``, ``align``, ``reference``, ``ROUTES`` and, where its files
  are not one uncompressed primary HDU each, ``write_pair``.

A cell, a configuration, a metric or a frame is added as files and
entries, without an edit of a file that is here.
"""
from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell_entry(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"coreg_bench: no workload named {name!r} in "
                     f"BENCHMARK.json")


def workload(name, data_root=None):
    return _json(os.path.join(data_root or HERE, "workloads", f"{name}.json"))


def config(name, data_root=None):
    return _json(os.path.join(data_root or HERE, "configs", f"{name}.json"))


def metrics_for(bench, cell, kind):
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports:
    those that list it, and those that list no cell."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def frame(name):
    """The module ``frames/<name>.py``."""
    return importlib.import_module(f"coreg_bench.frames.{name}")


@functools.lru_cache(maxsize=None)
def reader(name):
    """``read`` of ``metrics/<name>.py`` (a name may hold dots)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "coreg_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
