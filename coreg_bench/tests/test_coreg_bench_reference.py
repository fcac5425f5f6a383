"""The plain reference against hand-built cases at a tiny size."""
import math

import numpy as np
import pytest
import torch
from scipy.ndimage import map_coordinates

from _tiny import DATA  # noqa: F401
from coreg_bench.reference import geometry as g
from coreg_bench.reference import judge
from coreg_bench.reference.hypercube import CarrReference, HelioReference
from coreg_bench.reference.sampling import pearson, sample

D = torch.float64


def test_sample_is_scipy_order2_without_prefilter():
    rng = np.random.default_rng(3)
    img = rng.normal(size=(17, 23))
    x = rng.uniform(-1.0, 23.0, 400)
    y = rng.uniform(-1.0, 17.0, 400)
    want = map_coordinates(img, [y, x], order=2, mode="constant",
                           cval=np.nan, prefilter=False)
    got = sample(torch.as_tensor(img), torch.as_tensor(x),
                 torch.as_tensor(y)).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = np.isfinite(want)
    assert np.max(np.abs(got[ok] - want[ok])) < 1e-12


def test_pearson_is_numpy_corrcoef_over_finite_pixels():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(9, 11))
    b = 0.3 * a + rng.normal(size=(2, 9, 11))
    b[0, 2, 3] = np.nan
    got = pearson(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    for k in range(2):
        m = np.isfinite(b[k])
        assert got[k] == pytest.approx(np.corrcoef(a[m], b[k][m])[0, 1],
                                       abs=1e-12)


HDR = {"CRVAL1": 120.0, "CRVAL2": 80.0, "CRPIX1": 32.5, "CRPIX2": 32.5,
       "CDELT1": 6.0, "CDELT2": 6.0, "PC1_1": 1.0, "PC1_2": 0.0,
       "PC2_1": 0.0, "PC2_2": 1.0, "CROTA": 0.0}


def test_tan_round_trip_and_lagged_wcs():
    p = g.tan_params(dict(HDR, CROTA=0.75, **dict(zip(
        ("PC1_1", "PC1_2", "PC2_1", "PC2_2"), g.pc_matrix(0.75, 6.0, 6.0)))))
    y, x = torch.meshgrid(torch.arange(64, dtype=D), torch.arange(64, dtype=D),
                          indexing="ij")
    lon, lat = g.tan_pixel_to_world(p, x, y)
    xb, yb = g.tan_world_to_pixel(p, lon, lat)
    assert float((xb - x).abs().max()) < 1e-9
    assert float((yb - y).abs().max()) < 1e-9
    q = g.lagged(p, 1 / 3600, 0.0, 0.0, 0.0, 0.0)
    assert q["pc12"] == p["pc12"] and q["crval1"] == p["crval1"] + 1 / 3600
    q = g.lagged(p, 0.0, 0.0, 0.0, 0.0, 0.05)
    assert q["pc11"] == pytest.approx(math.cos(math.radians(0.8)))


def _helio_case(shift_px):
    """A smooth image, the reference on its own grid and the image to align
    ``shift_px`` pixels off along x (CRVAL1 = 6 arcsec a pixel)."""
    y, x = np.mgrid[0:64, 0:64].astype(np.float64)
    def scene(xx):
        return 100 + np.exp(-((xx - 30) ** 2 + (y - 34) ** 2) / 60.0)
    return scene(x), scene(x + shift_px)


def test_helio_reference_peaks_at_the_hand_built_shift():
    large, small = _helio_case(2.0)
    lags = [np.arange(-3, 4) * 6 / 3600, np.array([0.0]), np.array([0.0]),
            np.array([0.0]), np.array([0.0])]
    ref = HelioReference(large, small, HDR, HDR, lags)
    idx = np.array([[i, 0, 0, 0, 0] for i in range(7)])
    r = ref.r(idx)
    # the image to align shows at x what the reference shows at x + 2: a
    # CRVAL1 lag of +2 px (+12 arcsec) samples it at x - 2, where both are
    # the same smoothed scene
    assert int(np.nanargmax(r)) == 5
    assert r[5] == pytest.approx(1.0, abs=1e-12)
    assert ref.pairs[(5, 0, 0, 0, 0)] < ref.pairs[(3, 0, 0, 0, 0)]


def test_gaussian_fit_recovers_a_sub_lag_peak():
    lag = np.arange(-5, 6) * 1.0
    def scores(idx):
        idx = np.atleast_2d(idx)
        return 0.2 + 0.7 * np.exp(-((lag[idx[:, 0]] - 1.3) ** 2
                                    + (lag[idx[:, 1]] + 0.4) ** 2) / 8.0)
    given = {"CRVAL1": 10.0, "CRVAL2": 20.0, "CDELT1": 1.0, "CDELT2": 1.0,
             "CROTA": 0.5}
    lags = [lag, lag, np.array([0.0]), np.array([0.0])]
    hdr = judge.fitted_header(scores, (6, 5, 0, 0, 0), lags,
                              np.array([0.0]), given)
    assert hdr["CRVAL1"] == pytest.approx(11.3, abs=1e-6)
    assert hdr["CRVAL2"] == pytest.approx(19.6, abs=1e-6)
    assert hdr["CROTA"] == 0.5 and hdr["CDELT1"] == 1.0


def test_judge_numbers_on_a_hand_built_answer():
    class Ref:
        def __init__(self):
            self.scores = {}
        def r(self, idx):
            idx = np.atleast_2d(idx)
            for row in idx:
                self.scores[tuple(row)] = 1.0 - 0.01 * (row[0] - 3) ** 2
            return 1.0 - 0.01 * (idx[:, 0] - 3.0) ** 2
    lag = np.arange(7) - 3.0
    lags = [lag, np.array([0.0]), np.array([0.0]), np.array([0.0])]
    given = {"CRVAL1": 0.0, "CRVAL2": 0.0, "CDELT1": 1.0, "CDELT2": 1.0,
             "CROTA": 0.0}
    sample = np.array([[i, 0, 0, 0, 0] for i in range(7)])
    ref = Ref()
    good = judge.fitted_header(ref.r, (3, 0, 0, 0, 0), lags,
                               np.array([0.0]), given)
    nums = judge.judge(ref, ref.r, (3, 0, 0, 0, 0), good, sample, lags,
                       np.array([0.0]), given)
    assert nums == {"r_gap": 0.0, "argmax_gap": 0.0, "header_gap": 0.0}
    bad = judge.judge(ref, lambda idx: ref.r(idx) + 1e-3, (4, 0, 0, 0, 0),
                      dict(good, CROTA=1e-3), sample, lags, np.array([0.0]),
                      given)
    assert bad["r_gap"] == pytest.approx(1e-3)
    assert bad["argmax_gap"] == pytest.approx(0.01)
    assert bad["header_gap"] >= 3.6


SPHERE = {"NAXIS1": 64, "NAXIS2": 64, "CRVAL1": 150.0, "CRVAL2": 100.0,
          "CRPIX1": 32.5, "CRPIX2": 32.5, "CDELT1": 60.0, "CDELT2": 60.0,
          "CROTA": 0.3, "DSUN_OBS": 7.48e10, "CRLN_OBS": 120.0,
          "CRLT_OBS": 3.0, "DATE-OBS": "2022-03-17T09:50:45",
          "WAVELNTH": 174}


def test_sphere_round_trip():
    sc = g.sphere_scalars(SPHERE, 1.004)
    px = torch.tensor([10.0, 32.0, 50.0], dtype=D)
    py = torch.tensor([20.0, 32.0, 40.0], dtype=D)
    lon, lat = g.detector_to_sphere(sc, px, py)
    bx, by = g.sphere_to_detector(sc, lon, lat)
    assert float((bx - px).abs().max()) < 1e-8
    assert float((by - py).abs().max()) < 1e-8


def test_carr_reference_zero_lag_is_the_identity_and_scores_one():
    img = 100 + np.random.default_rng(5).normal(size=(64, 64))
    lags = [np.array([-30.0, 0.0, 30.0]) / 3600, np.array([0.0]),
            np.array([0.0]), np.array([0.0]), np.array([0.0])]
    ref = CarrReference(img, img, SPHERE, SPHERE, lags,
                        lonlims=(118.0, 122.0), latlims=(1.0, 5.0),
                        shape=(48, 48), d_solar_r=1.004,
                        reference_date=SPHERE["DATE-OBS"])
    c = ref.coeffs(0.0, 0.0)
    assert float(c.abs().max()) < 1e-9
    # the same image through the same header: at the zero lag the grid is
    # sampled at its own pixels, the spline's smoothing against the image
    j = torch.arange(48, dtype=D).expand(48, 48)
    i = torch.arange(48, dtype=D)[:, None].expand(48, 48)
    want = float(pearson(ref.ref, sample(ref.warped, j, i)))
    r = ref.r(np.array([[k, 0, 0, 0, 0] for k in range(3)]))
    assert r[1] == pytest.approx(want, abs=1e-12)
    assert r[1] > 0.99 and r[0] < r[1] and r[2] < r[1]
