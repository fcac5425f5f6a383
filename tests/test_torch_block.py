"""The port's block path for mixed lag grids and its movie evaluator against
the JAX package's, float64 on the CPU (where the JAX package's FFTs are the
plain XLA route and its warps exact twins of ``sample_image``)."""
import logging

import numpy as np
import pytest

import fixtures as fx
from euispice_coreg_tpu.core.header import get_crota, wcs_params_from_header
from euispice_coreg_tpu.engine import fast_corr as jfast
from euispice_coreg_tpu.engine import lag_search as jlag
from euispice_coreg_tpu.utils import coords
from euispice_coreg_tpu_torch.engine import fast_corr, lag_search

L1 = np.arange(-2, 19, 4.0) / 3600.0
L2 = np.arange(-14, 7, 4.0) / 3600.0


def build_inputs(nan_border=True, crota=0.75, seed=0):
    """The engine's geometry (tests/test_fast_corr.py): the small image on
    its own grid, the reference resampled from a larger frame onto it."""
    dl, hl, ds, hs = fx.make_helioprojective_pair(
        true_shift_arcsec=(8.0, -4.0), small_crota=crota, seed=seed)
    if nan_border:
        ds[:2, :] = ds[-2:, :] = np.nan
        ds[:, :2] = ds[:, -2:] = np.nan
    ds[30:36, 40:50] = np.nan
    lon, lat = coords.header_world_grid(hs)
    xg, yg = coords.world_to_pixel_of_header(hl, lon, lat)
    ref = jlag.resample_to_grid(dl, xg, yg, order=2,
                                compute_dtype="float64").copy()
    ref[60:64, 10:20] = np.nan
    base = {**wcs_params_from_header(hs).as_dict(), "crota": get_crota(hs)}
    return ds, ref, lon, lat, base


def combos_of(base, deltas):
    return [lag_search._apply_lag_to_params_np(base, np.asarray(d))
            for d in deltas]


DELTAS = [(0.0, 0.0, 0.0, 0.0, -0.5), (0.0, 0.0, 0.0, 0.0, 0.0),
          (0.0, 0.0, 1e-5, -2e-5, 0.3), (0.0, 0.0, 0.0, 1e-5, 0.0)]


def test_apply_lag_to_params_np_matches_jax():
    """Host combo WCS: PC rebuilt only for nonzero cdelt/crota lags; equal
    to the JAX twin bit for bit."""
    *_, base = build_inputs()
    base = dict(base, pc12=0.01)  # a PC matrix no crota would rebuild
    for d in DELTAS + [(1e-4, -2e-4, 0.0, 0.0, 0.0)]:
        got = lag_search._apply_lag_to_params_np(base, np.asarray(d))
        want = jlag._apply_lag_to_params_np(base, np.asarray(d))
        assert got.keys() == want.keys()
        for k in want:
            assert np.float64(got[k]) == np.float64(want[k]), (d, k)
        rebuilt = any(d[2:])
        assert (got["pc12"] == base["pc12"]) != rebuilt


@pytest.mark.parametrize("kind", ["tan", "car"])
def test_displacements_with_grid_match_jax(kind):
    """``displacement_per_lag(grid=)`` and ``displacement_per_lag_multi``
    (one vectorised chain over C combos) against the JAX functions: atol
    1e-12; the multi form equals C single calls."""
    if kind == "tan":
        _, _, lon, lat, base = build_inputs()
    else:
        car = ("CRLN-CAR", "CRLT-CAR")
        hs = fx.make_header((64, 64), (15.0, 15.0), (120.3 * 3600, 0.1 * 3600),
                            0.4, ctype=car)
        lon, lat = coords.header_world_grid(hs, wrap=False)
        base = {**wcs_params_from_header(hs).as_dict(), "crota": 0.4}
    g1, g2 = np.meshgrid(L1, L2, indexing="ij")
    lags = np.stack([g1.ravel(), g2.ravel()], axis=-1)
    combos = combos_of(base, DELTAS)
    cs, spreads = fast_corr.displacement_per_lag_multi(
        combos, lags, lon, lat, kind, grid=base)
    cs_j, spreads_j = jfast.displacement_per_lag_multi(
        combos, lags, lon, lat, kind, grid=base)
    np.testing.assert_allclose(cs, cs_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(spreads, spreads_j, rtol=0, atol=1e-12)
    for k, combo in enumerate(combos):
        c, s = fast_corr.displacement_per_lag(combo, lags, lon, lat, kind,
                                              grid=base)
        cj, sj = jfast.displacement_per_lag(combo, lags, lon, lat, kind,
                                            grid=base)
        np.testing.assert_allclose(c, cj, rtol=0, atol=1e-12)
        assert s == pytest.approx(sj, abs=1e-12)
        np.testing.assert_allclose(cs[k], c, rtol=0, atol=1e-12)


def movie_case(seed=1):
    """Three frames with NaN holes and per-frame displacements."""
    rng = np.random.default_rng(seed)
    ds, ref, *_ = build_inputs(seed=seed)
    smalls = np.stack([np.roll(ds, k, axis=1) for k in range(3)])
    refs = np.stack([ref, np.roll(ref, -2, axis=0), ref])
    smalls[1, 5:9, 50:60] = np.nan
    cs = rng.uniform(-6.0, 6.0, size=(3, 17, 2))
    cs[0, 0] = (0.0, 0.0)
    return smalls, refs, cs


@pytest.mark.parametrize("method", ["correlation", "residus_masked"])
@pytest.mark.parametrize("order", [0, 2])
def test_movie_evaluator_matches_jax(order, method):
    """(F, L) scores with NaN holes against the JAX function: atol 1e-8,
    best lag of each frame equal; a tensor stack and an expand-ed reference
    give the same numbers."""
    import torch

    smalls, refs, cs = movie_case()
    if method == "residus_masked":
        smalls, refs = smalls + 5.0, refs + 5.0  # positive fields
    kw = dict(order=order, compute_dtype="float64", method=method)
    got = fast_corr.evaluate_movie_from_displacements(smalls, refs, cs,
                                                      device="cpu", **kw)
    want = jfast.evaluate_movie_from_displacements(smalls, refs, cs, **kw)
    assert got.shape == want.shape == (3, 17)
    np.testing.assert_allclose(got, want, atol=1e-8)
    pick = np.nanargmax if method == "correlation" else np.nanargmin
    for f in range(3):
        assert pick(got[f]) == pick(want[f])
    ref0 = torch.as_tensor(refs[0])
    exp = fast_corr.evaluate_movie_from_displacements(
        torch.as_tensor(smalls), ref0[None].expand(smalls.shape), cs,
        device="cpu", **kw)
    one = fast_corr.evaluate_movie_from_displacements(
        smalls, np.broadcast_to(refs[0], smalls.shape), cs, device="cpu",
        **kw)
    np.testing.assert_array_equal(exp, one)


def test_movie_evaluator_declines_like_jax():
    """``None`` on the JAX function's preconditions: raw residus, a shape
    mismatch, a bad cs array, shifts of a quarter frame or more."""
    smalls, refs, cs = movie_case()
    big = cs.copy()
    big[2, 3] = (30.0, 0.0)  # 30 px >= 96 // 4
    cases = [(smalls, refs, cs, "residus"),
             (smalls, refs[:, :-1], cs, "correlation"),
             (smalls, refs, cs[0], "correlation"),
             (smalls[:2], refs[:2], cs, "correlation"),
             (smalls, refs, big, "correlation")]
    for s, r, c, method in cases:
        assert jfast.evaluate_movie_from_displacements(
            s, r, c, method=method, compute_dtype="float64") is None
        assert fast_corr.evaluate_movie_from_displacements(
            s, r, c, method=method, device="cpu",
            compute_dtype="float64") is None


def block_both(monkeypatch, jax_route, l3=(0.0,), l4=(0.0,),
               l5=(-0.5, 0.0, 0.5), method="correlation", caplog=None):
    """The port's block path (one route: combo after combo) and the JAX
    package's, on the JAX fleet route or, with its stacking budget patched
    to 0, on its per-combo route."""
    ds, ref, lon, lat, base = build_inputs()
    if method == "residus_masked":
        ds, ref = ds + 5.0, ref + 5.0
    if jax_route == "per_combo":
        monkeypatch.setattr(jlag, "_FLEET_STACK_BUDGET_BYTES", 0)
    args = (ds, ref, lon, lat, base, L1, L2, l3, l4, l5)
    kw = dict(order=2, compute_dtype="float64", allow_fast="block",
              method=method)
    want = jlag.evaluate_lag_grid(*args, **kw)
    with caplog.at_level(logging.INFO, logger="euispice_coreg_tpu_torch"):
        got = lag_search.evaluate_lag_grid(*args, device="cpu", **kw)
    return got, want, args


@pytest.mark.parametrize("route", ["fleet", "per_combo"])
def test_block_path_matches_jax(monkeypatch, caplog, route):
    """``evaluate_lag_grid(allow_fast="block")`` on a crval x cdelt x crota
    grid against both routes of the JAX function: atol 1e-8, argmax equal,
    and the block path's log line."""
    got, want, _ = block_both(monkeypatch, route, l3=(0.0, 1e-5),
                              caplog=caplog)
    assert got.shape == want.shape == (len(L1), len(L2), 2, 1, 3)
    np.testing.assert_allclose(got, want, atol=1e-8)
    assert np.nanargmax(got) == np.nanargmax(want)
    lines = [r.getMessage() for r in caplog.records]
    assert "engine path: FFT block fast (mixed grid)" in lines


def test_block_residus_masked_matches_jax(monkeypatch, caplog):
    got, want, _ = block_both(monkeypatch, "fleet", method="residus_masked",
                              caplog=caplog)
    np.testing.assert_allclose(got, want, atol=1e-8)
    assert np.nanargmin(got) == np.nanargmin(want)


def test_block_constant_nonzero_crota(monkeypatch, caplog):
    """A constant crota lag ([0.75], the reference golden configs): the
    combo WCS rebuilds PC, the pre-warp carries it.  Against the JAX block
    path atol 1e-8; against the port's exact engine argmax equal, atol 0.02
    (tests/test_fast_corr.py)."""
    got, want, args = block_both(monkeypatch, "fleet", l5=(0.75,),
                                 caplog=caplog)
    np.testing.assert_allclose(got, want, atol=1e-8)
    exact = lag_search.evaluate_lag_grid(*args, order=2, device="cpu",
                                         compute_dtype="float64",
                                         allow_fast=False)
    assert np.nanargmax(got) == np.nanargmax(exact)
    np.testing.assert_allclose(got, exact, atol=0.02)


def test_block_matches_exact_engine():
    """Block vs the port's exact per-lag engine on a crval x crota grid:
    argmax equal, atol 0.02 (double interpolation; JAX
    tests/test_fast_corr.py:105-124)."""
    ds, ref, lon, lat, base = build_inputs()
    args = (ds, ref, lon, lat, base, L1, L2, [0.0], [0.0], [-0.5, 0.0, 0.5])
    kw = dict(order=2, device="cpu", compute_dtype="float64")
    block = lag_search.evaluate_lag_grid(*args, allow_fast="block", **kw)
    exact = lag_search.evaluate_lag_grid(*args, allow_fast=False, **kw)
    assert np.nanargmax(block) == np.nanargmax(exact)
    np.testing.assert_allclose(block, exact, atol=0.02)


def test_block_declines_to_exact_engine_like_jax(monkeypatch, caplog):
    """Spread above 0.05 px (100" pixels, a 2-degree crval lag, 320^2): the
    block path returns None before any combo is warped, and both packages
    run the exact engine."""
    hs = fx.make_header((320, 320), (100.0, 100.0), (0.0, 0.0), 0.3)
    lon, lat = coords.header_world_grid(hs)
    img = fx.scene_helioprojective(lon, lat)
    base = {**wcs_params_from_header(hs).as_dict(), "crota": get_crota(hs)}
    args = (img, img, lon, lat, base, [0.0, 2.0], [0.0], [0.0], [0.0],
            [0.0, 0.1])
    assert fast_corr.displacement_per_lag_multi(
        [base], np.array([[2.0, 0.0]]), lon, lat, "tan",
        grid=base)[1][0] > fast_corr.MAX_DISPLACEMENT_SPREAD_PX
    warps = []
    warp = lag_search._warp_by_params
    monkeypatch.setattr(lag_search, "_warp_by_params",
                        lambda *a, **k: warps.append(1) or warp(*a, **k))
    kw = dict(order=2, compute_dtype="float64", allow_fast="block")
    with caplog.at_level(logging.INFO, logger="euispice_coreg_tpu_torch"):
        got = lag_search.evaluate_lag_grid(*args, device="cpu", **kw)
    want = jlag.evaluate_lag_grid(*args, **kw)
    assert warps == []
    lines = [r.getMessage() for r in caplog.records]
    assert "engine path: per-lag gather" in lines
    assert "engine path: FFT block fast (mixed grid)" not in lines
    np.testing.assert_allclose(got, want, atol=1e-8)
