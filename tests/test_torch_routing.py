"""The ``"auto"`` router of mixed lag grids (``lag_search.route_mixed_grid``)
and ``Alignment._allow_fast_mode`` around it: on a CUDA device K1 or the
block path by the card's cost model, called here as pure functions with
``device_type="cuda"`` (no card needed); on the CPU the JAX package's rule,
held against the JAX ``Alignment``.  Also the two public helpers of the JAX
``hdrshift/alignment.py`` that the port carries."""
import io
import logging
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from euispice_coreg_tpu.hdrshift import alignment as jalignment
from euispice_coreg_tpu_torch.engine import lag_search, warp_score
from euispice_coreg_tpu_torch.hdrshift import alignment as talignment
from test_torch_alignment import run_both, write_pair

N = 2048
METHODS = ("correlation", "residus_masked", "residus")
# (n_crval1, n_crval2, n_combos, h, w) of the grids the card runs
SLICE_D = (21, 21, 27, N, N)  # 21^2 CRVAL x 3 CDELT1 x 3 CDELT2 x 3 CROTA
WIDE = (121, 121, 3, N, N)    # 121^2 CRVAL x 3 CROTA
G3 = (21, 21, 9, 1024, 192)   # the SPICE raster, 3 CDELT1 x 3 CROTA
TABLE = [SLICE_D, WIDE, G3, (21, 21, 75, N, N), (11, 11, 3, N, N),
         (51, 51, 3, N, N), (41, 41, 1, 512, 512), (101, 101, 9, 96, 96),
         (5, 5, 2, 8, 12), (1999, 1, 1, N, N), (20, 20, 5, N, N),
         (23, 29, 3, N, N)]


def route(grid, device_type="cuda", **kw):
    kw = {"order": 2, "method": "correlation", **kw}
    return lag_search.route_mixed_grid(*grid, device_type=device_type, **kw)


def jax_rule(n_lags):
    """The JAX package's own ``"auto"`` mapping, from its ``Alignment``."""
    return jalignment.Alignment._allow_fast_mode(
        SimpleNamespace(lag_search_mode="auto"), n_lags)


@pytest.mark.parametrize("grid,want", [
    (SLICE_D, "pallas"),   # K1 ~0.4 s against ~1 s of surfaces for 27 combos
    (WIDE, "block"),       # 3 combos of surfaces against K1 at 43923 lags
    (G3, "pallas"),        # 1280^2 transforms for a 1024 x 192 raster
], ids=["slice_d", "121x121x3", "g3"])
def test_card_routes_the_measured_grids(grid, want):
    assert route(grid) == want


def test_residus_masked_stays_on_the_block_path():
    """K1 computes no residue: above 2000 candidates the block path, as in
    the JAX package, below it the exact engine."""
    assert route(SLICE_D, method="residus_masked") == "block"
    assert route(WIDE, method="residus_masked") == "block"
    assert route((11, 11, 3, N, N), method="residus_masked") is True


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("grid", TABLE)
def test_order_1_never_routes_to_the_block_path(grid, method):
    """The block path has no order-1 stencil: K1 for correlation, else the
    exact engine."""
    got = route(grid, order=1, method=method)
    assert got != "block"
    assert got == ("pallas" if method == "correlation" else True)


@pytest.mark.parametrize("order", [0, 2])
@pytest.mark.parametrize("n_combos,shape", [
    (1, (N, N)), (3, (N, N)), (27, (N, N)), (75, (N, N)), (9, (1024, 192)),
    (3, (512, 512)), (3, (96, 96))])
def test_route_never_flips_back_to_k1_as_the_crval_grid_grows(n_combos,
                                                              shape, order):
    """K1 costs per lag, the block path per combo: with the combos fixed,
    once the block path wins it keeps winning as the CRVAL sub-grid grows."""
    routes = [route((n, n, n_combos, *shape), order=order)
              for n in range(1, 402, 4)]
    assert set(routes) <= {"pallas", "block"}
    first_block = routes.index("block") if "block" in routes else len(routes)
    assert all(r == "block" for r in routes[first_block:])
    if shape == (N, N) and n_combos == 3:
        assert routes[0] == "pallas" and routes[-1] == "block"


def _k1_case(shape, ref_shape):
    rng = np.random.default_rng(0)
    small = rng.normal(size=shape) + 5.0
    ref = rng.normal(size=ref_shape) + 5.0
    lon = np.broadcast_to(np.arange(shape[1]) * 1e-3, shape).copy()
    lat = np.broadcast_to(np.arange(shape[0])[:, None] * 1e-3, shape).copy()
    base = {"crval1": 0.0, "crval2": 0.0, "crpix1": shape[1] / 2,
            "crpix2": shape[0] / 2, "cdelt1": 1e-3, "cdelt2": 1e-3,
            "pc11": 1.0, "pc12": 0.0, "pc21": 0.0, "pc22": 1.0,
            "crota": 0.0}
    return small, ref, lon, lat, base


@pytest.mark.parametrize("ref_shape", [(12, 10), (12, 9), (11, 10)])
@pytest.mark.parametrize("order", [0, 1, 2, 3])
@pytest.mark.parametrize("method", METHODS)
def test_route_never_picks_k1_where_k1_declines(method, order, ref_shape):
    """Where ``warp_score.evaluate_lag_grid_warp`` returns None, the router
    never answers "pallas" (the engine would drop to the per-lag gather),
    and where it answers "pallas", K1 computes the grid."""
    shape = (12, 10)
    small, ref, lon, lat, base = _k1_case(shape, ref_shape)
    lags = ([0.0, 1e-3], [0.0], [0.0], [0.0], [-0.5, 0.0, 0.5])
    out = warp_score.evaluate_lag_grid_warp(
        small, ref, lon, lat, base, *lags, order=order, method=method,
        device="cpu")
    for grid in ((2, 1, 3, *shape), (200, 200, 3, *shape)):
        got = route(grid, order=order, method=method, ref_shape=ref_shape)
        if out is None:
            assert got != "pallas"
        elif got == "pallas":
            assert out.shape == (2, 1, 1, 1, 3) and np.isfinite(out).all()
    assert (out is not None) == (method == "correlation" and order < 3
                                 and ref_shape == shape)


@pytest.mark.parametrize("n_lags,grid", [
    (1999, (1999, 1, 1, N, N)), (2000, (20, 20, 5, N, N)),
    (2001, (23, 29, 3, N, N))])
def test_cpu_keeps_the_jax_rule_at_2000(n_lags, grid):
    assert grid[0] * grid[1] * grid[2] == n_lags
    assert route(grid, device_type="cpu") == jax_rule(n_lags)
    assert route(grid, device_type="cpu") == ("block" if n_lags > 2000
                                              else True)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_cpu_keeps_the_jax_rule_on_a_table_of_grids(order, method):
    for grid in TABLE:
        n_lags = grid[0] * grid[1] * grid[2]
        for n_shards in (1, 3):
            assert route(grid, device_type="cpu", order=order, method=method,
                         n_shards=n_shards) == jax_rule(n_lags)


def test_mesh_splits_both_routes():
    """Shards divide K1's lags and the block path's surface planes: both
    estimates fall with the shards, and the decisions of the measured
    grids stand on a mesh."""
    one = lag_search.estimate_mixed_grid_seconds(441, 27, N, N, order=2,
                                                 method="correlation")
    four = lag_search.estimate_mixed_grid_seconds(441, 27, N, N, order=2,
                                                  method="correlation",
                                                  n_shards=4)
    assert four[0] < one[0] and four[1] < one[1]
    assert route(SLICE_D, n_shards=4) == "pallas"
    assert route(WIDE, n_shards=4) == "block"


def test_route_is_logged(caplog):
    with caplog.at_level(logging.INFO, logger="euispice_coreg_tpu_torch"):
        route(SLICE_D)
        route(SLICE_D, device_type="cpu")
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 2
    assert lines[0].startswith("auto route: K1 est ")
    assert "27 combos x 441 crval lags, 2048x2048" in lines[0]
    assert lines[0].endswith("-> pallas")
    assert lines[1].endswith("-> block")


def _alignment(mode, device_type, order=2, method="correlation", mesh=None):
    """What ``_allow_fast_mode`` reads of an ``Alignment``."""
    return SimpleNamespace(lag_search_mode=mode, order=order, method=method,
                           device=SimpleNamespace(type=device_type),
                           mesh=mesh)


def _deg_axes(n1, n2, cdelt=(0.0,), crota=(0.0,)):
    lag = (np.arange(n1) - n1 // 2) / 3600.0
    lag2 = (np.arange(n2) - n2 // 2) / 3600.0
    return (lag, lag2, np.asarray(cdelt) / 3600.0, np.array([0.0]),
            np.asarray(crota, dtype=np.float64))


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_allow_fast_mode_explicit_modes_and_crval_grids(device_type):
    """"exact", "pallas", "fast" and "tile_fft" map as before on either
    device; a CRVAL-only grid keeps the JAX package's mapping (the FFT path
    runs whatever the knob)."""
    fast = talignment.Alignment._allow_fast_mode
    mixed = _deg_axes(21, 21, cdelt=(-0.5, 0.0, 0.5), crota=(-0.05, 0.0, 0.05))
    for mode, want in (("exact", False), ("pallas", "pallas"),
                       ("fast", "block"), ("tile_fft", "block")):
        assert fast(_alignment(mode, device_type), mixed, (N, N)) == want
    for n in (41, 45, 47, 121):
        got = fast(_alignment("auto", device_type), _deg_axes(n, n), (N, N))
        assert got == jax_rule(n * n)


def test_allow_fast_mode_auto_on_a_card_and_on_the_cpu():
    fast = talignment.Alignment._allow_fast_mode
    d = _deg_axes(21, 21, cdelt=(-0.5, 0.0, 0.5), crota=(-0.05, 0.0, 0.05))
    assert fast(_alignment("auto", "cuda"), d, (N, N)) == "pallas"
    assert fast(_alignment("auto", "cpu"), d, (N, N)) == jax_rule(21 * 21 * 9)
    wide = _deg_axes(121, 121, crota=(-0.05, 0.0, 0.05))
    assert fast(_alignment("auto", "cuda"), wide, (N, N)) == "block"
    assert fast(_alignment("auto", "cuda", mesh=["cuda:0"] * 2), wide,
                (N, N)) == "block"
    assert fast(_alignment("auto", "cuda", order=1), wide, (N, N)) == "pallas"


def test_k1_route_raises_instead_of_falling_back(monkeypatch):
    """"auto" on a card hands K1's route to the engine; where K1 cannot
    launch (here: no card) the engine raises, and the block path and the
    CPU never run in its place."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    ran = []
    monkeypatch.setattr(lag_search, "_evaluate_block_fast",
                        lambda *a, **k: ran.append("block"))
    monkeypatch.setattr(lag_search, "_evaluate_flat",
                        lambda *a, **k: ran.append("gather"))
    d = _deg_axes(21, 21, cdelt=(-0.5, 0.0, 0.5), crota=(-0.05, 0.0, 0.05))
    mode = talignment.Alignment._allow_fast_mode(_alignment("auto", "cuda"),
                                                 d, (16, 16))
    assert mode == "pallas"
    img = np.ones((16, 16))
    base = {"crval1": 0.0, "crval2": 0.0, "crpix1": 8.0, "crpix2": 8.0,
            "cdelt1": 1e-3, "cdelt2": 1e-3, "pc11": 1.0, "pc12": 0.0,
            "pc21": 0.0, "pc22": 1.0, "crota": 0.0}
    with pytest.raises(RuntimeError, match="cuda"):
        lag_search.evaluate_lag_grid(img, img, img, img, base, *d,
                                     device="cuda", allow_fast=mode)
    assert ran == []


def test_auto_takes_the_jax_engine_path_at_2001_candidates(tmp_path, caplog):
    """A 2001-candidate mixed grid (23 x 29 CRVAL x 3 CROTA) under "auto" on
    the CPU: the port's engine log line equals the JAX package's (the block
    path), and so does the hypercube (float64, atol 1e-6)."""
    p_large, p_small = write_pair(tmp_path, "fixture")
    lags = dict(lag_crval1=np.arange(23.0) - 3.0,
                lag_crval2=np.arange(29.0) - 18.0,
                lag_crota=[-0.5, 0.0, 0.5])
    with caplog.at_level(logging.INFO, logger="euispice_coreg_tpu"), \
            caplog.at_level(logging.INFO, logger="euispice_coreg_tpu_torch"):
        res_j, res_t, _, _ = run_both(tmp_path, p_large, p_small, "auto",
                                      "float64", **lags)

    def engine_lines(name):
        return [r.getMessage() for r in caplog.records
                if r.name == name and r.getMessage().startswith("engine path")]

    assert engine_lines("euispice_coreg_tpu_torch") == engine_lines(
        "euispice_coreg_tpu") == ["engine path: FFT block fast (mixed grid)"]
    assert res_t.corr.shape == res_j.corr.shape == (23, 29, 1, 1, 3, 1)
    np.testing.assert_allclose(res_t.corr, res_j.corr, atol=1e-6)
    assert res_t.max_index == res_j.max_index


def test_hidden_prints_silences_and_restores_stdout(capsys):
    for mod in (jalignment, talignment):
        before = sys.stdout
        with mod.HiddenPrints():
            print("silenced")
            assert sys.stdout is not before
        assert sys.stdout is before
        print("heard")
        assert capsys.readouterr().out == "heard\n"
    buf = io.StringIO()
    sys.stdout, saved = buf, sys.stdout
    try:
        with talignment.HiddenPrints():
            print("silenced")
        print("heard")
    finally:
        sys.stdout = saved
    assert buf.getvalue() == "heard\n"


@pytest.mark.parametrize("length,n", [(0, 3), (1, 3), (7, 3), (9, 3),
                                      (10, 1), (5, 8)])
def test_divide_chunks_matches_jax(length, n):
    items = list(range(length))
    got = list(talignment.divide_chunks(items, n))
    assert got == list(jalignment.divide_chunks(items, n))
    assert sum(got, []) == items
    arr = np.arange(length)
    for a, b in zip(talignment.divide_chunks(arr, n),
                    jalignment.divide_chunks(arr, n)):
        np.testing.assert_array_equal(a, b)
    assert all(len(c) == n for c in got[:-1])

