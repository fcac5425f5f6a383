"""The 1-degree roll of ``tests/test_crota_modes.py`` recovered through each
of the port's engine routes, held against the JAX package's.

Helioprojective: ``lag_search_mode`` ``"pallas"`` (K1), ``"fast"`` (the
per-combo FFT block path) and ``"exact"`` (the per-lag gather) through
``Alignment``.  Carrington: ``lag_mode`` ``"pallas"`` (K2), ``"tile_fft"``
(tile-FFT surfaces) and ``"fast"`` (the per-combo FFT path) through
``evaluate_lag_grid_carrington``.  Each case: the argmax is the true roll
and equal to the JAX package's; the values agree within the stated
tolerance; and a spy on the port's own functions shows that the route named
carried the search (on the CPU the kernel wrappers run their plain
versions, so the spy sits on the wrapper, not on a launch counter).

Tolerances: 1e-5 where both packages run the same algorithm; 3e-4 against
the JAX package's Pallas K2, which sums in float32 whatever the operands'
dtype (``tests/test_pallas_quad.py``'s own tolerance).
"""
import numpy as np
import pytest

import fixtures as fx
import test_crota_modes as jcm
from euispice_coreg_tpu.engine import carrington as jcarr
from euispice_coreg_tpu.hdrshift.alignment import Alignment as JAlignment
from euispice_coreg_tpu_torch import Alignment
from euispice_coreg_tpu_torch.core.header import Header
from euispice_coreg_tpu_torch.engine import (carrington, lag_search,
                                             quad_score, tile_fft,
                                             warp_score)

LAG_CROTA = np.arange(-2.0, 2.5, 0.5)
CARR_ROLLS = np.array([-1.0, 0.0, 1.0])


def spy(monkeypatch, module, name, log):
    """Replace ``module.name`` with a wrapper that notes in ``log[name]``
    whether each call returned a result."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        log.setdefault(name, []).append(out is not None)
        return out

    monkeypatch.setattr(module, name, wrapper)


# mode -> (the port function that must carry the search, tolerance)
HELIO_ROUTES = {"pallas": ("warp_score_sums", 1e-5),
                "fast": ("_evaluate_block_fast", 1e-5),
                "exact": ("_evaluate_flat", 1e-5)}


@pytest.mark.parametrize("mode", list(HELIO_ROUTES))
def test_helioprojective_crota_modes_match_jax(tmp_path, monkeypatch, mode):
    dl, hl, ds, hs = fx.make_helioprojective_pair(
        true_shift_arcsec=(0.0, 0.0), true_dcrota_deg=1.0)
    p_large, p_small = fx.write_pair_fits(tmp_path, dl, hl, ds, hs)
    kw = dict(large_fov_known_pointing=p_large, small_fov_to_correct=p_small,
              lag_crval1=np.array([0.0]), lag_crval2=np.array([0.0]),
              lag_crota=LAG_CROTA, small_fov_window=0, large_fov_window=0,
              lag_search_mode=mode)
    want = JAlignment(**kw, use_device_mesh=False) \
        .align_using_helioprojective(return_type="corr")
    ran = {}
    spy(monkeypatch, warp_score, "warp_score_sums", ran)
    spy(monkeypatch, lag_search, "_evaluate_block_fast", ran)
    spy(monkeypatch, lag_search, "_evaluate_flat", ran)
    port = Alignment(**kw, device="cpu")
    got = port.align_using_helioprojective(return_type="corr")

    route, atol = HELIO_ROUTES[mode]
    calls = ran.pop(route, [])
    assert calls and all(calls), (mode, route, calls)
    assert not any(any(v) for v in ran.values()), (mode, ran)
    assert got.shape == want.shape == (1, 1, 1, 1, len(LAG_CROTA), 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    mi = np.unravel_index(np.nanargmax(got), got.shape)
    assert mi == np.unravel_index(np.nanargmax(want), want.shape)
    assert port.lag_crota[mi[4]] == pytest.approx(1.0)


# mode -> (the port function that must carry the search, tolerance)
CARR_ROUTES = {"pallas": ("quad_score_sums", 3e-4),
               "tile_fft": ("evaluate_select_tile_fft", 1e-5),
               "fast": ("_carrington_block_fast", 1e-5)}


@pytest.mark.parametrize("mode", list(CARR_ROUTES))
def test_carrington_crota_modes_match_jax(monkeypatch, mode):
    hdr, small, ref, lonlims, latlims, shape = \
        jcm._carrington_roll_config(1.0)
    args = (lonlims, latlims, shape, [0.0], [0.0], [0.0], [0.0], CARR_ROLLS)
    kw = dict(d_solar_r=1.004, reference_date=hdr["DATE-OBS"],
              rate_wave="171", order=2, compute_dtype="float64",
              lag_mode=mode)
    want = jcarr.evaluate_lag_grid_carrington(small, ref, hdr, *args, **kw)
    ran = {}
    spy(monkeypatch, quad_score, "quad_score_sums", ran)
    spy(monkeypatch, tile_fft, "evaluate_select_tile_fft", ran)
    spy(monkeypatch, carrington, "_carrington_block_fast", ran)
    got = carrington.evaluate_lag_grid_carrington(
        small, ref, Header(dict(hdr.items())), *args, device="cpu", **kw)

    route, atol = CARR_ROUTES[mode]
    calls = ran.pop(route, [])
    assert calls and all(calls), (mode, route, calls)
    assert not any(any(v) for v in ran.values()), (mode, ran)
    assert got.shape == want.shape == (1, 1, 1, 1, len(CARR_ROLLS))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    mi = np.unravel_index(np.nanargmax(got), got.shape)
    assert mi == np.unravel_index(np.nanargmax(want), want.shape)
    assert CARR_ROLLS[mi[4]] == pytest.approx(1.0)
