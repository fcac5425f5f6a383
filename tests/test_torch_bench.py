"""The port's bench (``bench_torch.py``) against the JAX bench (``bench.py``).

The bench's numerics are held to the JAX package by the engine parity
tests; this file holds its inputs and its protocol: the rendered pair and
Carrington scenes equal ``bench.py``'s within 1e-12 on the CPU, ``main``
prints every key of ``bench.py``'s JSON line with every leg timed, and the
script loads no JAX and raises without a card."""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import bench_torch  # noqa: E402

IMAGE_ATOL = 1e-12  # float64 renders: the same operations, numpy vs torch

LEG_SECONDS = ("wall_clock_s", "end_to_end_api_s", "carrington_121x121_2048_s",
               "carrington_api_s", "carrington_coarse_121x121_s",
               "mixed_grid_21x21x3_2048_s", "synras_spice_e2e_s",
               "iterative_spice_5x5_s")
LEGS = ("core", "api", "carr", "carr_api", "carr_coarse", "mixed", "synras",
        "iterative")


def bench_json_keys():
    """The keys of the dict that bench.py's main prints (read from its
    source: running it needs a TPU)."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("bench.py prints no dict")


@pytest.mark.parametrize("n_small,n_ref", [(96, 96), (80, 112)])
def test_synthesize_pair_matches_bench(monkeypatch, n_small, n_ref):
    for mod in (bench, bench_torch):
        monkeypatch.setattr(mod, "N_SMALL", n_small)
        monkeypatch.setattr(mod, "N_REF", n_ref)
    want = bench.synthesize_pair()
    got = bench_torch.synthesize_pair(torch.device("cpu"))
    assert got[4] == want[4]
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == torch.float64 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=IMAGE_ATOL)


# bench.py's three Carrington headers at n = 64, and one whose field of
# view reaches past the limb (NaN corners)
CARR_HEADERS = [(2.0, 150.0, 100.0, 0.3), (2.0, 174.0, 100.0, 0.3),
                (2.4, 148.0, 98.0, 0.0), (64.0, 150.0, 100.0, 0.3)]


@pytest.mark.parametrize("cdelt,crval1,crval2,crota", CARR_HEADERS)
def test_carrington_render_matches_bench(cdelt, crval1, crval2, crota):
    want_hdr = bench._carr_header(64, cdelt, crval1, crval2, crota=crota)
    got_hdr = bench_torch._carr_header(64, cdelt, crval1, crval2, crota=crota)
    assert list(got_hdr.items()) == list(want_hdr.items())
    want = bench._carr_render(want_hdr)
    got = bench_torch._carr_render(got_hdr, torch.device("cpu")).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_ATOL)
    if cdelt == 64.0:
        assert 0 < np.isnan(want).sum() < want.size


def test_carrington_reference_matches_bench(monkeypatch):
    from euispice_coreg_tpu.engine import carrington as jcarr

    monkeypatch.setattr(bench_torch, "CARR_SHAPE", (72, 56))
    lon_g, lat_g = jcarr.carrington_grid((117.0, 123.0), (-1.0, 7.0),
                                         (72, 56))
    want = bench._carr_scene(lon_g, lat_g)
    got = bench_torch._carr_reference(torch.device("cpu")).numpy()
    assert got.shape == want.shape == (56, 72)
    np.testing.assert_allclose(got, want, rtol=0, atol=IMAGE_ATOL)


def test_main_prints_every_bench_key(monkeypatch, capsys):
    """main on the CPU at small sizes (2048^2 -> 256^2 pair, 121 -> 41
    lags a side at the same steps, a 64^2 Carrington grid, 384^2 imager
    frames): one JSON line with every key of bench.py's and the port's
    own, every leg timed and its shift recovered."""
    monkeypatch.setattr(bench_torch, "N_SMALL", 256)
    monkeypatch.setattr(bench_torch, "N_REF", 256)
    monkeypatch.setattr(bench_torch, "GRID", 41)
    monkeypatch.setattr(bench_torch, "CARR_SHAPE", (64, 64))
    monkeypatch.setattr(bench_torch, "IMAGER_SHAPE", (384, 384))
    bench_torch.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert bench_json_keys() <= set(out)
    assert {"device", "host_cpu", "launches"} <= set(out)
    assert out["metric"] == ("lag-grid correlation evals/sec (2048^2 pair, "
                             "121x121 crval grid)")
    for key in LEG_SECONDS:
        assert isinstance(out[key], float) and out[key] > 0, key
    assert out["leg_errors"] is None
    assert out["value"] == pytest.approx(41 * 41 / out["wall_clock_s"],
                                         rel=1e-3)
    assert out["cpu_baseline_s_20core_est"] >= 0
    assert set(out["launches"]) == set(LEGS)
    # on the CPU the wrappers run the plain versions: no kernel launch
    assert all(v == {"K1": 0, "K2": 0} for v in out["launches"].values())
    assert set(out["stages"]) == set(LEGS) - {"synras"}
    assert out["device"] == {"name": "cpu", "power_limit_w": None, "count": 0}
    assert out["host_cpu"]["count"] == os.cpu_count()


def test_bench_torch_imports_no_jax():
    """bench_torch.py names no JAX, JAX-package or tests/fixtures import,
    and importing it loads none of them."""
    with open(os.path.join(REPO, "bench_torch.py")) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module.split(".")[0])
    assert not imported & {"jax", "jaxlib", "euispice_coreg_tpu", "fixtures"}
    code = ("import sys, bench_torch; print(sorted(k for k in sys.modules "
            "if k.split('.')[0] in ('jax', 'jaxlib', 'euispice_coreg_tpu', "
            "'fixtures')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_bench_torch_without_card_raises():
    """``python3 bench_torch.py`` (device cuda) with no card visible raises
    before any leg runs and prints no result."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert out.stdout == ""
