"""The port's core numerics (wcs, sample_image, scores) against the JAX
package on the same seeded inputs, float64 on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import map_coordinates

from euispice_coreg_tpu.core import resample as jresample
from euispice_coreg_tpu.core import score as jscore
from euispice_coreg_tpu.core import wcs as jwcs
from euispice_coreg_tpu_torch.core import resample, score, wcs


def _params(kind, seed=0):
    rng = np.random.default_rng(seed)
    crota = rng.uniform(-2.0, 2.0)
    cdelt = (rng.uniform(0.5, 5.0) / 3600.0, rng.uniform(0.5, 5.0) / 3600.0)
    lam = cdelt[1] / cdelt[0]
    rho = np.deg2rad(crota)
    if kind == "tan":
        crval = (rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3))
    else:
        crval = (rng.uniform(0.0, 360.0), 0.0)
        cdelt = (cdelt[0] * 200, cdelt[1] * 200)
    return {"crval1": crval[0], "crval2": crval[1],
            "crpix1": rng.uniform(40, 90), "crpix2": rng.uniform(40, 90),
            "cdelt1": cdelt[0], "cdelt2": cdelt[1],
            "pc11": np.cos(rho), "pc12": -lam * np.sin(rho),
            "pc21": np.sin(rho) / lam, "pc22": np.cos(rho)}


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("kind", ["tan", "car"])
def test_wcs_pixel_world_matches_jax(kind):
    """pixel->world and world->pixel, TAN and CAR: atol 1e-9 (deg / px)."""
    p = _params(kind, seed=1)
    rng = np.random.default_rng(2)
    px = rng.uniform(-10, 140, size=(32, 48))
    py = rng.uniform(-10, 140, size=(32, 48))
    lon_j, lat_j = jwcs.pixel_to_world(p, jnp.asarray(px), jnp.asarray(py),
                                       kind=kind)
    lon_t, lat_t = wcs.pixel_to_world(p, _t(px), _t(py), kind=kind)
    np.testing.assert_allclose(lon_t.numpy(), np.asarray(lon_j), atol=1e-9)
    np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j), atol=1e-9)

    x_j, y_j = jwcs.world_to_pixel(p, lon_j, lat_j, kind=kind)
    x_t, y_t = wcs.world_to_pixel(p, lon_t, lat_t, kind=kind)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-9)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-9)
    np.testing.assert_allclose(x_t.numpy(), px, atol=1e-9)
    np.testing.assert_allclose(y_t.numpy(), py, atol=1e-9)


def test_wcs_batched_params_and_numpy_path():
    """(L, 1, 1) per-lag parameters broadcast like the JAX vmap, and the
    xp=np host path gives the torch numbers."""
    p = _params("tan", seed=3)
    rng = np.random.default_rng(4)
    lon = rng.uniform(-0.3, 0.3, size=(16, 16))
    lat = rng.uniform(-0.3, 0.3, size=(16, 16))
    shifts = np.array([0.0, 1e-3, -2e-3])
    pb = dict(p, crval1=(p["crval1"] + shifts)[:, None, None])
    x_j, y_j = jwcs.world_to_pixel(pb, jnp.asarray(lon), jnp.asarray(lat))
    pt = dict(pb, crval1=_t(pb["crval1"]))
    x_t, y_t = wcs.world_to_pixel(pt, _t(lon), _t(lat))
    assert x_t.shape == (3, 16, 16)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-9)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-9)
    x_n, y_n = wcs.world_to_pixel(pb, lon, lat, xp=np)
    np.testing.assert_allclose(x_n, x_t.numpy(), atol=1e-12)
    np.testing.assert_allclose(
        wcs.ang2pipi_deg(np.array([179.0, 181.0, -181.0, 540.0])),
        [179.0, -179.0, 179.0, 180.0])


def test_wcs_tan_behind_horizon_is_nan():
    p = _params("tan", seed=5)
    x, y = wcs.world_to_pixel(p, _t([p["crval1"] + 120.0]), _t([0.0]))
    assert torch.isnan(x).all() and torch.isnan(y).all()


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_sample_image_matches_jax_and_scipy(order):
    """Orders 0-3, NaN pixels, NaN and edge/outside coordinates:
    atol 1e-10 (float64) against JAX sample_image and scipy."""
    rng = np.random.default_rng(10 + order)
    img = rng.normal(size=(23, 31))
    img_nan = img.copy()
    img_nan[5, 7] = np.nan
    x = rng.uniform(-1.5, 31.5, size=(40, 50))
    y = rng.uniform(-1.5, 23.5, size=(40, 50))
    # exact edges, just inside / outside, and NaN coordinates
    x[0, :6] = [0.0, 30.0, 1e-12, 30.0 - 1e-12, -1e-12, 30.0 + 1e-12]
    y[0, :6] = [0.0, 22.0, 11.0, 11.0, 11.0, 11.0]
    x[1, 0] = np.nan
    y[1, 1] = np.nan
    for image in (img, img_nan):
        got = resample.sample_image(_t(image), _t(x), _t(y), order=order)
        want_j = np.asarray(jresample.sample_image(
            jnp.asarray(image), jnp.asarray(x), jnp.asarray(y), order=order))
        np.testing.assert_allclose(got.numpy(), want_j, atol=1e-10)
    finite = np.isfinite(x) & np.isfinite(y)
    want_s = map_coordinates(img, [y[finite], x[finite]], order=order,
                             mode="constant", cval=np.nan, prefilter=False)
    got = resample.sample_image(_t(img), _t(x), _t(y), order=order).numpy()
    np.testing.assert_allclose(got[finite], want_s, atol=1e-10)
    assert np.isnan(got[~finite]).all()


def test_sample_image_batched_coordinates():
    rng = np.random.default_rng(20)
    img = rng.normal(size=(17, 19))
    x = rng.uniform(0, 18, size=(3, 5, 7))
    y = rng.uniform(0, 16, size=(3, 5, 7))
    got = resample.sample_image(_t(img), _t(x), _t(y), order=2)
    assert got.shape == (3, 5, 7)
    for b in range(3):
        one = resample.sample_image(_t(img), _t(x[b]), _t(y[b]), order=2)
        np.testing.assert_array_equal(got[b].numpy(), one.numpy())


def _score_inputs(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(1.0, 5.0, size=(24, 20))
    b = a + rng.normal(0.0, 0.3, size=a.shape)
    a[3, 4] = np.nan
    b[7, 1] = np.nan
    b[0, :5] = np.nan
    return a, b


@pytest.mark.parametrize("method", ["correlation", "residus",
                                    "residus_masked"])
def test_scores_match_jax(method):
    """masked_pearson, residus, residus_masked: rtol 1e-10."""
    a, b = _score_inputs(30)
    want = float(jscore.SCORE_FUNCTIONS[method](jnp.asarray(a),
                                                jnp.asarray(b)))
    got = float(score.SCORE_FUNCTIONS[method](_t(a), _t(b)))
    if method == "residus":  # NaN-propagating by design
        assert np.isnan(want) and np.isnan(got)
        a2 = np.where(np.isfinite(a) & np.isfinite(b), a, 2.0)
        b2 = np.where(np.isfinite(a) & np.isfinite(b), b, 2.0)
        want = float(jscore.residus(jnp.asarray(a2), jnp.asarray(b2)))
        got = float(score.residus(_t(a2), _t(b2)))
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("method", ["correlation", "residus_masked"])
def test_scores_batch_over_leading_axis(method):
    a, b = _score_inputs(31)
    rng = np.random.default_rng(32)
    bs = np.stack([b, b + rng.normal(0.0, 0.1, b.shape), b[::-1]])
    got = score.SCORE_FUNCTIONS[method](_t(a), _t(bs))
    want = [float(jscore.SCORE_FUNCTIONS[method](jnp.asarray(a),
                                                 jnp.asarray(x)))
            for x in bs]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
