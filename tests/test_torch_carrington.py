"""The port's Carrington engine (engine/carrington.py) against the JAX
package on the same inputs, made from tests/fixtures.py and numpy seeds
(the public entry point: tests/test_torch_carrington_api.py)."""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures as fx
from euispice_coreg_tpu.engine import carrington as jcarr
from euispice_coreg_tpu.utils import timeutils as jtime
from euispice_coreg_tpu_torch.core.header import Header
from euispice_coreg_tpu_torch.engine import carrington as carr
from euispice_coreg_tpu_torch.utils import timeutils

LONLIMS, LATLIMS, SHAPE = (115.0, 125.0), (-2.0, 8.0), (128, 128)
# the CRVAL grid of test_pallas_quad's select fixture (degrees)
L1 = np.arange(0.0, 41.0, 10.0) / 3600.0
L2 = np.arange(-30.0, 11.0, 10.0) / 3600.0
ONE = np.array([0.0])


@pytest.fixture(scope="module")
def pair():
    """make_carrington_pair, its small-header scalars and the reference
    reprojected onto the grid by the JAX package in float64."""
    dl, hl, ds, hs = fx.make_carrington_pair(true_shift_arcsec=(20.0, -10.0))
    ref = jcarr.reproject_to_carrington(
        dl, hl, LONLIMS, LATLIMS, SHAPE, d_solar_r=1.004,
        reference_date=hl["DATE-OBS"], rate_wave="171",
        compute_dtype="float64")
    return dl, hl, ds, hs, ref


def port_header(hdr):
    return Header(dict(hdr.items()))


def test_header_scalars_and_timeutils_match_jax(pair):
    _, hl, _, hs, _ = pair
    for hdr in (hl, hs):
        for r in (1.0, 1.004):
            assert carr.header_spherical_scalars(port_header(hdr), r) == \
                jcarr.header_spherical_scalars(hdr, r)
    for a, b in (("2022-03-17T09:50:45.281", "2022-03-16T00:00:00"),
                 ("2021-01-01", "2022-03-17T09:50:50.5Z")):
        assert timeutils.time_diff_days(a, b) == jtime.time_diff_days(a, b)


def test_geometry_matches_jax(pair):
    """float64, numpy and torch forms: atol 1e-9 (deg, unit sphere, px),
    the differential rotation for every rate band."""
    _, _, _, hs, _ = pair
    sc = jcarr.header_spherical_scalars(hs, 1.004)
    lon, lat = carr.carrington_grid(LONLIMS, LATLIMS, (40, 30))
    jlon, jlat = jcarr.carrington_grid(LONLIMS, LATLIMS, (40, 30))
    np.testing.assert_array_equal(lon, jlon)
    np.testing.assert_array_equal(lat, jlat)
    dt = 1.7
    for rate_wave in (None, *carr.DIFF_ROT_COEFFS):
        np.testing.assert_allclose(
            carr.diff_rot_shift_deg(lat, dt, rate_wave),
            jcarr.diff_rot_shift_deg(jlat, dt, rate_wave), atol=1e-9)
        t_shift = carr.diff_rot_shift_deg(torch.as_tensor(lat),
                                          torch.tensor(dt, dtype=torch.float64),
                                          rate_wave, xp=torch)
        np.testing.assert_allclose(t_shift.numpy(),
                                   jcarr.diff_rot_shift_deg(jlat, dt, rate_wave),
                                   atol=1e-9)
    np.testing.assert_allclose(carr.surface_rotation_drift_deg(lat, dt),
                               jcarr.surface_rotation_drift_deg(jlat, dt),
                               atol=1e-9)
    lon_rot = lon - carr.diff_rot_shift_deg(lat, dt, "171")
    geo = carr.observer_geometry(lon_rot, lat, sc["obs_lon"], sc["obs_lat"])
    jgeo = jcarr.observer_geometry(lon_rot, lat, sc["obs_lon"],
                                   sc["obs_lat"])
    t = {k: torch.tensor(v, dtype=torch.float64) for k, v in sc.items()}
    tgeo = carr.observer_geometry(
        torch.as_tensor(lon_rot), torch.as_tensor(lat), t["obs_lon"],
        t["obs_lat"], xp=torch)
    for a, b, c in zip(geo, jgeo, tgeo):
        np.testing.assert_allclose(a, b, atol=1e-9)
        np.testing.assert_allclose(c.numpy(), b, atol=1e-9)
    x0, y0 = carr._pixel_origin(sc["crval1_arcsec"], sc["crval2_arcsec"],
                                sc["crpix1"], sc["crpix2"], sc["roll"],
                                sc["cdelt1_arcsec"], sc["cdelt2_arcsec"],
                                xp=np)
    jx0, jy0 = jcarr._pixel_origin(sc["crval1_arcsec"], sc["crval2_arcsec"],
                                   sc["crpix1"], sc["crpix2"], sc["roll"],
                                   sc["cdelt1_arcsec"], sc["cdelt2_arcsec"],
                                   xp=np)
    assert abs(x0 - jx0) < 1e-9 and abs(y0 - jy0) < 1e-9
    args = (sc["dist"], sc["roll"], x0, y0, sc["cdelt1_arcsec"],
            sc["cdelt2_arcsec"])
    want = jcarr.spherical_project(*jgeo, *args, xp=np)
    got_np = carr.spherical_project(*geo, *args, xp=np)
    got_t = carr.spherical_project(*tgeo, *(torch.tensor(v, dtype=torch.float64)
                                            for v in args))
    for a, b, c in zip(got_np, want, got_t):
        np.testing.assert_allclose(a, b, atol=1e-9)
        np.testing.assert_allclose(c.numpy(), b, atol=1e-9)
    px, py = np.meshgrid(np.arange(0.0, 80.0, 7.0), np.arange(0.0, 80.0, 9.0))
    for a, b in zip(carr.spherical_unproject(px, py, sc),
                    jcarr.spherical_unproject(px, py, sc)):
        np.testing.assert_allclose(a, b, atol=1e-9)


@pytest.mark.parametrize("order", [1, 2])
def test_reproject_to_carrington_matches_jax(pair, order):
    """float64 device warp (grid from arange, rotation, projection,
    sample_image) against the JAX warp: atol 1e-6 on the image, NaN
    pattern equal."""
    dl, hl, _, _, _ = pair
    kw = dict(d_solar_r=1.004, reference_date="2022-03-18T00:00:00",
              rate_wave="171", order=order)
    want = jcarr.reproject_to_carrington(dl, hl, LONLIMS, LATLIMS, SHAPE,
                                         compute_dtype="float64", **kw)
    got = carr.reproject_to_carrington(dl, port_header(hl), LONLIMS, LATLIMS,
                                       SHAPE, device="cpu",
                                       compute_dtype="float64", **kw)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_reproject_solar_surface_matches_jax(pair):
    """Host float64 coordinates, device sampling: float64 atol 1e-6, with a
    day of surface rotation between the two headers."""
    dl, hl, _, hs, _ = pair
    hs2 = hs.copy()
    hs2["DATE-OBS"] = "2022-03-18T09:50:45.281"
    want = jcarr.reproject_solar_surface(dl, hl, hs2, d_solar_r=1.004,
                                         compute_dtype=jnp.float64)
    got = carr.reproject_solar_surface(dl, port_header(hl), port_header(hs2),
                                       d_solar_r=1.004, device="cpu",
                                       compute_dtype="float64")
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_probe_fit_matches_jax_float64(pair):
    """The float64 probe fit against JAX ``_probe_fit_products(...,
    compute_dtype="float64")``: coefficients applied at the grid corners
    within 1e-6 px, fit residual and detector/grid scale equal."""
    _, _, _, hs, _ = pair
    sc = jcarr.header_spherical_scalars(hs, 1.004)
    combo = carr._combo(sc, 0.0, 0.0, 0.2)
    g1, g2 = np.meshgrid(np.linspace(-60, 60, 7), np.linspace(-40, 40, 5),
                         indexing="ij")
    dc1, dc2 = g1.ravel(), g2.ravel()
    d = carr.probe_design(SHAPE)
    dlon = (LONLIMS[1] - LONLIMS[0]) / (SHAPE[0] - 1)
    dlat = (LATLIMS[1] - LATLIMS[0]) / (SHAPE[1] - 1)
    ok, coeffs, fit_err, scale = carr._probe_fit_products(
        combo, LONLIMS, LATLIMS, dc1, dc2, 0.3, "171", dlon, dlat, d,
        device="cpu")
    jok, jcoeffs, jfit_err, _, _, jscale = jcarr._probe_fit_products(
        combo, LONLIMS, LATLIMS, SHAPE, dc1, dc2, 0.3, "171", "float64",
        d["pxf"], d["pyf"], dlon, dlat, d["pinv"], d["design"],
        d["coeff_rescale"], d["probe_shape"])
    assert ok and jok
    corners = np.array([[0, 0], [127, 0], [0, 127], [127, 127], [64, 50]],
                       dtype=float)
    basis = np.stack([corners[:, 0], corners[:, 1], np.ones(5),
                      corners[:, 0] ** 2, corners[:, 1] ** 2,
                      corners[:, 0] * corners[:, 1]], axis=-1)
    np.testing.assert_allclose(np.einsum("pq,lqk->lpk", basis, coeffs),
                               np.einsum("pq,lqk->lpk", basis, jcoeffs),
                               atol=1e-6)
    assert fit_err == pytest.approx(jfit_err, abs=1e-9)
    assert scale == pytest.approx(jscale, rel=1e-12)


def select_common(hs, hl, dtype="float32"):
    sc = jcarr.header_spherical_scalars(hs, 1.004)
    delta_t = jtime.time_diff_days(str(hs["DATE-OBS"]), str(hl["DATE-OBS"]))
    return sc, dict(delta_t=delta_t, rate_wave="171", lonlims=LONLIMS,
                    latlims=LATLIMS, shape=SHAPE, l1=L1, l2=L2, l3=ONE,
                    l4=ONE, l5=ONE, order=2, method="correlation",
                    compute_dtype=dtype)


def test_carrington_select_matches_jax_xla_select(pair):
    """K2's select path (plain version on the CPU) against JAX
    ``_carrington_select(use_pallas=False)`` (the XLA select evaluator) on
    test_pallas_quad's fixture: float32, atol 5e-4, argmax equal."""
    _, hl, ds, hs, ref = pair
    sc, common = select_common(hs, hl)
    want = jcarr._carrington_select(ds, ref, sc, use_pallas=False,
                                    batch_size=4, **common)
    got = carr._carrington_select(ds, ref, sc, device="cpu", **common)
    assert want is not None and got is not None
    np.testing.assert_allclose(got, want, atol=5e-4)
    assert np.unravel_index(np.nanargmax(got), got.shape) == \
        np.unravel_index(np.nanargmax(want), want.shape)


@pytest.mark.parametrize("mode,dtype,atol", [
    ("exact", "float64", 1e-6),    # per-lag gather, both packages
    ("auto", "float32", 5e-4),     # select: K2 plain vs the XLA evaluator
    ("pallas", "float32", 3e-4),   # select: K2 plain vs pallas interpret
])
def test_evaluate_lag_grid_carrington_matches_jax(pair, mode, dtype, atol,
                                                  caplog):
    """Per ``lag_mode``, the same path in both packages; values within the
    JAX package's own tolerance for that path, argmax equal."""
    _, hl, ds, hs, ref = pair
    kw = dict(d_solar_r=1.004, reference_date=hl["DATE-OBS"],
              rate_wave="171", order=2, compute_dtype=dtype, lag_mode=mode)
    axes = (L1, L2, ONE, ONE, [0.0, 0.3]) if mode == "exact" else \
        (L1, L2, ONE, ONE, ONE)
    want = jcarr.evaluate_lag_grid_carrington(
        ds, ref, hs, LONLIMS, LATLIMS, SHAPE, *axes, **kw)
    with caplog.at_level(logging.INFO, logger="euispice_coreg_tpu_torch"):
        got = carr.evaluate_lag_grid_carrington(
            ds, ref, port_header(hs), LONLIMS, LATLIMS, SHAPE, *axes,
            device="cpu", **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol)
    assert np.nanargmax(got) == np.nanargmax(want)
    path = ("engine path: carrington per-lag gather" if mode == "exact"
            else "engine path: carrington linearized select")
    assert path in caplog.messages
    if mode != "exact":
        assert "carrington select: K2 quad kernel (25 lags)" in caplog.messages


@pytest.mark.parametrize("case", ["flat", "oversampled"])
def test_auto_paths_on_small_grids(case, caplog):
    """A 64^2 field at disk centre, float64, ``lag_mode="auto"``.

    ``flat``: a grid at the detector's own pitch takes the per-combo FFT
    path in both packages: atol 1e-6, argmax equal.
    ``oversampled``: a grid ~20x finer than the detector puts the lags
    40 grid px away, beyond the FFT path's frame bound and the JAX select
    evaluator's 24-px window cap, so the JAX package gathers; the port stays
    on the select path with K2 (it has no window cap).  The two differ by
    the double interpolation: atol 2e-2, argmax equal (ROADMAP section 3).
    """
    extra = dict(fx.CARR_EXTRA, CRLT_OBS=0.0)
    hs = fx.make_header((64, 64), (2.0, 2.0), (0.0, 0.0), 0.0, extra=extra)
    ds = fx.render_carrington_view(hs)
    if case == "flat":
        lonlims, latlims, atol = (118.1, 121.9), (-1.9, 1.9), 1e-6
        path = "engine path: carrington FFT fast"
    else:
        lonlims, latlims, atol = (119.9, 120.1), (-0.1, 0.1), 2e-2
        path = "engine path: carrington linearized select"
    shape = (64, 64)
    lon, lat = jcarr.carrington_grid(lonlims, latlims, shape)
    ref = fx.scene_carrington(lon + 0.004, lat)
    axes = (np.arange(-4.0, 5.0, 2.0) / 3600.0,
            np.arange(-2.0, 3.0, 2.0) / 3600.0, ONE, ONE, ONE)
    kw = dict(d_solar_r=1.004, order=2, compute_dtype="float64",
              lag_mode="auto")
    want = jcarr.evaluate_lag_grid_carrington(ds, ref, hs, lonlims, latlims,
                                              shape, *axes, **kw)
    with caplog.at_level(logging.INFO, logger="euispice_coreg_tpu_torch"):
        got = carr.evaluate_lag_grid_carrington(
            ds, ref, port_header(hs), lonlims, latlims, shape, *axes,
            device="cpu", **kw)
    assert path in caplog.messages
    np.testing.assert_allclose(got, want, atol=atol)
    assert np.nanargmax(got) == np.nanargmax(want)


def test_raw_residus_takes_the_gather(pair, caplog):
    """K2 computes correlation and residus_masked only; the raw ``residus``
    score (NaN-poisoned on padded grids) leaves the select path for the
    per-lag gather, so ``"pallas"`` gives the ``"exact"`` numbers (the JAX
    package scores it with its XLA select evaluator instead)."""
    _, hl, ds, hs, ref = pair
    kw = dict(d_solar_r=1.004, reference_date=hl["DATE-OBS"],
              rate_wave="171", method="residus", device="cpu")
    args = (ds, ref, port_header(hs), LONLIMS, LATLIMS, SHAPE, L1[:2], L2[:2],
            ONE, ONE, ONE)
    with caplog.at_level(logging.INFO, logger="euispice_coreg_tpu_torch"):
        got = carr.evaluate_lag_grid_carrington(*args, lag_mode="pallas",
                                                **kw)
    assert "engine path: carrington per-lag gather" in caplog.messages
    want = carr.evaluate_lag_grid_carrington(*args, lag_mode="exact", **kw)
    np.testing.assert_array_equal(got, want)


def test_tile_fft_mode_is_not_ported(pair, caplog):
    """``"tile_fft"`` is ported (the name is historical): on this fixture
    both packages score all 25 lags on tile-FFT surfaces, float32 within
    1e-4 of each other, argmax equal."""
    _, hl, ds, hs, ref = pair
    kw = dict(d_solar_r=1.004, reference_date=hl["DATE-OBS"],
              rate_wave="171", lag_mode="tile_fft")
    axes = (L1, L2, ONE, ONE, ONE)
    want = jcarr.evaluate_lag_grid_carrington(ds, ref, hs, LONLIMS, LATLIMS,
                                              SHAPE, *axes, **kw)
    with caplog.at_level(logging.INFO, logger="euispice_coreg_tpu_torch"):
        got = carr.evaluate_lag_grid_carrington(
            ds, ref, port_header(hs), LONLIMS, LATLIMS, SHAPE, *axes,
            device="cpu", **kw)
    assert "carrington select: tile-FFT surfaces (25 lags)" in \
        caplog.messages
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.nanargmax(got) == np.nanargmax(want)
