"""BENCHMARK.json, discovery by name and the result line, against the
benchmark's contract."""
import json
import os
import re
import shutil

import pytest

from _tiny import DATA, ROOT, run_tiny, tiny_bench, tiny_results  # noqa: F401
from coreg_bench import discover

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return discover.benchmark()


def test_benchmark_json_keys_names_and_limits(bench):
    assert set(bench) == TOP
    assert bench["command"] == ["python3", "coreg_bench/run.py"]
    assert bench["paths"] == ["coreg_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    cells = {w["name"] for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("coreg_bench/")
        assert any(w["config"] == c["name"] for w in bench["workloads"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for cell in cells:
        reported = [m["name"] for m in discover.metrics_for(
            bench, cell, "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert discover.metrics_for(bench, cell, "per_layer")
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_name_is_found(bench):
    for c in bench["configs"]:
        cfg = discover.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        wl = discover.workload(w["name"])
        assert wl["config"] == w["config"] and wl["chips"] == w["chips"]
        assert set(wl["limits"]) == {"r_gap", "argmax_gap", "header_gap"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(discover.reader(m["name"]))


@pytest.mark.parametrize("name", ["hri_fsi_helio_2048", "hri_fsi_carr_2048",
                                  "tiny_helio", "tiny_carr", "tiny_helio_ext",
                                  "tiny_spice"])
def test_each_configuration_finds_its_frame(name):
    """A configuration's ``frame`` is a module of ``frames/`` (or of the
    data root's ``frames/``) by that name, with what a run calls."""
    root = DATA if name.startswith("tiny") else None
    frame = discover.frame(discover.config(name, root)["frame"], root)
    for attr in ("align", "reference"):
        assert callable(getattr(frame, attr))
    assert callable(getattr(frame, "make_pair", None) or frame.render)
    assert all(len(r) == 2 for r in frame.ROUTES)


def test_a_cell_added_as_files_alone_runs(tmp_path):
    """A new configuration and cell are files and entries only: copy the
    tiny ones under new names and run the new cell."""
    data = tmp_path / "data"
    shutil.copytree(DATA, data)
    cfg = json.loads((data / "configs" / "tiny_helio.json").read_text())
    cfg["name"] = "added_cfg"
    (data / "configs" / "added_cfg.json").write_text(json.dumps(cfg))
    wl = json.loads((data / "workloads" / "tiny_helio.json").read_text())
    wl["config"] = "added_cfg"
    (data / "workloads" / "added_cell.json").write_text(json.dumps(wl))
    res = run_tiny("added_cell", data=str(data),
                   bench=tiny_bench(("added_cell",)))
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"files_per_s", "file_p85_s", "setup_s"}


def _check_line(res, bench, cell, kind):
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert {"metrics", "device"} <= set(res)
    units = {m["name"]: m["unit"]
             for m in discover.metrics_for(bench, cell, kind)}
    for name, v in res["metrics"].items():
        assert v["unit"] == units[name] and isinstance(v["value"], float)
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
    json.dumps(res, allow_nan=False)


@pytest.mark.parametrize("cell", ["tiny_helio", "tiny_carr"])
def test_result_line_untraced(tiny_results, cell):
    res = tiny_results[(cell, False)]
    _check_line(res, tiny_bench(), cell, "end_to_end")
    assert res["correct"] is True and res["failed"] == 0
    assert "files_per_s" in res["metrics"] and "setup_s" in res["metrics"]


@pytest.mark.parametrize("cell", ["tiny_helio", "tiny_carr"])
def test_result_line_traced(tiny_results, cell):
    res = tiny_results[(cell, True)]
    _check_line(res, tiny_bench(), cell, "per_layer")
    assert res["correct"] is True
    assert "fits_load_ms" in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    for key in ("device_ops", "idle_gaps"):
        assert len(res["breakdown"][key]) <= 10
