"""The port's FFT fast path (CRVAL-only grids) against the JAX package's,
float64 on the CPU (where the JAX path is the plain XLA FFT route)."""
import numpy as np
import pytest

import fixtures as fx
from euispice_coreg_tpu.core.header import get_crota, wcs_params_from_header
from euispice_coreg_tpu.engine import fast_corr as jfast
from euispice_coreg_tpu.utils import coords
from euispice_coreg_tpu_torch.engine import fast_corr


def build_case(n=128, cdelt=2.0, seed=0):
    _, _, ds, hs = fx.make_helioprojective_pair(
        true_shift_arcsec=(8.0, -4.0), small_naxis=(n, n),
        small_cdelt=(cdelt, cdelt), seed=seed)
    lon, lat = coords.header_world_grid(hs)
    ref = fx.scene_helioprojective(lon, lat, seed=seed)
    ds = ds.copy()
    ds[10:20, 30:40] = np.nan
    ref = ref.copy()
    ref[50:60, 5:15] = np.nan
    base = {**wcs_params_from_header(hs).as_dict(), "crota": get_crota(hs)}
    return ds, ref, lon, lat, base


@pytest.mark.parametrize("method", ["correlation", "residus_masked"])
@pytest.mark.parametrize("order", [0, 2])
def test_crval_grid_matches_jax(order, method):
    """4 x 4 CRVAL grid, NaN holes: atol 1e-8, argmax (argmin for the
    residue) equal."""
    ds, ref, lon, lat, base = build_case()
    l1 = np.array([-4.0, 0.0, 4.3, 8.1]) / 3600.0
    l2 = np.array([-6.2, -3.9, 0.0, 2.0]) / 3600.0
    want = jfast.evaluate_crval_grid_fast(
        ds, ref, lon, lat, base, l1, l2, order=order, kind="tan",
        compute_dtype="float64", mesh=None, method=method)
    got = fast_corr.evaluate_crval_grid_fast(
        ds, ref, lon, lat, base, l1, l2, order=order, kind="tan",
        device="cpu", compute_dtype="float64", method=method)
    assert got.shape == want.shape == (4, 4)
    np.testing.assert_allclose(got, want, atol=1e-8)
    pick = np.nanargmax if method == "correlation" else np.nanargmin
    assert pick(got) == pick(want)


def test_displacements_match_jax():
    ds, ref, lon, lat, base = build_case(n=96)
    lags = np.array([[0.0, 0.0], [3e-3, -1e-3], [-2e-3, 4e-3]])
    c, s = fast_corr.displacement_per_lag(base, lags, lon, lat, "tan")
    cj, sj = jfast.displacement_per_lag(base, lags, lon, lat, "tan")
    np.testing.assert_allclose(c, cj, rtol=0, atol=1e-12)
    assert s == pytest.approx(sj, abs=1e-12)


@pytest.mark.parametrize("case", ["spread", "frame"])
def test_declines_like_jax(case):
    """Both packages return None: curvature spread above 0.05 px, or
    shifts of a quarter frame or more."""
    if case == "spread":
        # 100" pixels, 2-degree lag: 72 px shift, 0.056 px spread
        hs = fx.make_header((320, 320), (100.0, 100.0), (0.0, 0.0), 0.3)
        l1 = np.array([2.0])
    else:
        hs = fx.make_header((96, 96), (5.0, 5.0), (0.0, 0.0), 0.3)
        l1 = np.array([0.0, 130.0 / 3600.0])  # 26 px >= 96 / 4
    lon, lat = coords.header_world_grid(hs)
    img = fx.scene_helioprojective(lon, lat)
    base = {**wcs_params_from_header(hs).as_dict(), "crota": get_crota(hs)}
    l2 = np.array([0.0])
    assert jfast.evaluate_crval_grid_fast(
        img, img, lon, lat, base, l1, l2, compute_dtype="float64") is None
    assert fast_corr.evaluate_crval_grid_fast(
        img, img, lon, lat, base, l1, l2, device="cpu",
        compute_dtype="float64") is None


def test_fast_path_applicability_matches_jax():
    for args in (([0.0], [0.0], [0.0], 2), ([0.0], [0.0], [0.0], 1),
                 ([1e-6], [0.0], [0.0], 2), ([0.0], [0.0], [0.0, 0.1], 0)):
        assert fast_corr.fast_path_applicable(*args) == \
            jfast.fast_path_applicable(*args)
