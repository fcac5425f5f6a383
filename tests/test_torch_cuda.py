"""Tests that need a CUDA card: the K1 and K2 kernels against their plain
versions and the engine paths on the card against the CPU.  They skip without a card.
This file imports no JAX (the machine with the card has none), so it also
runs there without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from euispice_coreg_tpu_torch.core import wcs
from euispice_coreg_tpu_torch.engine import lag_search, warp_score

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def make_case(kind, n=256, seed=0):
    """Smooth scene pair on one comparison grid with NaN holes."""
    rng = np.random.default_rng(seed)
    rho = np.deg2rad(0.6)
    if kind == "tan":
        cdelt, crval = 2.0 / 3600.0, (0.03, 0.02)
    else:
        cdelt, crval = 0.01, (120.0, 0.0)
    base = {"crval1": crval[0], "crval2": crval[1], "crpix1": n / 2 + 0.3,
            "crpix2": n / 2 - 0.2, "cdelt1": cdelt, "cdelt2": cdelt,
            "pc11": np.cos(rho), "pc12": -np.sin(rho), "pc21": np.sin(rho),
            "pc22": np.cos(rho), "crota": 0.6}
    x, y = np.meshgrid(np.arange(n, dtype=float), np.arange(n, dtype=float))
    lon, lat = wcs.pixel_to_world(base, x, y, kind=kind, xp=np)
    u = (x - n / 2) / n
    v = (y - n / 2) / n
    centers = rng.uniform(-0.4, 0.4, size=(12, 2))

    def scene(du):
        out = np.full(u.shape, 10.0)
        for cx, cy in centers:
            out += np.exp(-((u + du - cx) ** 2 + (v - cy) ** 2) / 0.01)
        return out

    small, ref = scene(3.0 / n), scene(0.0)
    small[10:20, 30:40] = np.nan
    ref[50:60, 5:15] = np.nan
    return small, ref, lon, lat, base


@pytest.mark.parametrize("kind", ["tan", "car"])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_kernel_matches_plain_version(cuda, kind, order):
    """Kernel vs plain version on the same card tensors: six sums within
    1e-5 of each sum's largest magnitude, r within 1e-5, argmax equal."""
    small, ref, lon, lat, base = make_case(kind)
    c = base["cdelt1"]
    lags = np.array([[0, 0, 0, 0, 0], [3 * c, 0, 0, 0, 0],
                     [2.5 * c, -c, 0, 0, 0.1], [0, 0, 0.01 * c, 0, 0],
                     [-30 * c, 12 * c, 0, 0, -0.5]], dtype=float)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=cuda)

    ref_c = t(ref - np.nanmean(ref))
    canvas = torch.nn.functional.pad(
        t(small - np.nanmean(small))[None, None], (2, 2, 2, 2),
        mode="reflect")[0, 0].contiguous()
    table = t(warp_score.lag_table(base, lags))
    kw = dict(pad=2, order=order, kind=kind)
    before = warp_score.LAUNCHES
    got = warp_score.warp_score_sums(canvas, ref_c, t(lon), t(lat), table,
                                     **kw)
    assert warp_score.LAUNCHES == before + 1
    want = warp_score.warp_score_sums_reference(canvas, ref_c, t(lon),
                                                t(lat), table, **kw)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want).max(axis=0))
    r_got = warp_score.pearson_from_sums(got)
    r_want = warp_score.pearson_from_sums(want)
    np.testing.assert_allclose(r_got, r_want, atol=1e-5)
    assert np.nanargmax(r_got) == np.nanargmax(r_want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_exact_engine_on_card_uses_k1(cuda, dtype):
    """The exact engine on the card launches K1 and gives the CPU per-lag
    gather's numbers: atol 1e-5 (float32) / 1e-10 (float64)."""
    small, ref, lon, lat, base = make_case("tan", seed=1)
    c = base["cdelt1"]
    axes = ([0.0, 3 * c], [-c, 0.0], [0.0], [0.0, 0.01 * c], [0.0, 0.2])
    before = warp_score.LAUNCHES
    got = lag_search.evaluate_lag_grid(small, ref, lon, lat, base, *axes,
                                       device=cuda, compute_dtype=dtype,
                                       allow_fast=False)
    assert warp_score.LAUNCHES > before
    want = lag_search.evaluate_lag_grid(small, ref, lon, lat, base, *axes,
                                        device="cpu", compute_dtype=dtype,
                                        allow_fast=False)
    atol = 1e-5 if dtype == "float32" else 1e-10
    np.testing.assert_allclose(got, want, atol=atol)


def test_fast_path_on_card_matches_cpu(cuda):
    """The FFT path (cuFFT on the card, float64 surfaces) against the CPU
    in float64: atol 1e-10."""
    small, ref, lon, lat, base = make_case("tan", seed=2)
    c = base["cdelt1"]
    l1 = np.arange(-3, 4) * c
    l2 = np.arange(-2, 3) * c
    kw = dict(order=2, compute_dtype="float64", allow_fast=True)
    got = lag_search.evaluate_lag_grid(small, ref, lon, lat, base, l1, l2,
                                       [0.0], [0.0], [0.0], device=cuda, **kw)
    want = lag_search.evaluate_lag_grid(small, ref, lon, lat, base, l1, l2,
                                        [0.0], [0.0], [0.0], device="cpu",
                                        **kw)
    np.testing.assert_allclose(got, want, atol=1e-10)


def quad_case(n=200, seed=3):
    """Smooth positive scene with NaN holes, a shifted reference, and lags
    with shifts, affine and quadratic terms."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    warped = 60.0 + np.sin(xx / 9.0) * np.cos(yy / 13.0) \
        + 0.1 * rng.standard_normal((n, n))
    ref = np.roll(warped, (3, -5), axis=(0, 1)) \
        + 0.05 * rng.standard_normal((n, n))
    warped[40:55, 20:60] = np.nan
    ref[100:120, 150:190] = np.nan
    coeffs = np.zeros((5, 6, 2))
    coeffs[0, 2] = (37.3, -41.4)
    coeffs[1, 2] = (-5.0, 3.0)
    coeffs[2, 2] = (5.3, -2.1)
    coeffs[2, 0, 0] = 4e-3
    coeffs[2, 4, 1] = -4e-6
    coeffs[3, 0, 0] = 0.1           # beyond the TPU kernel's residual bound
    coeffs[4, 5] = (2e-6, -1.5e-6)
    return warped, ref, coeffs


@pytest.mark.parametrize("method", ["correlation", "residus_masked"])
def test_k2_matches_plain_version(cuda, method):
    """K2 vs its plain version on the same card tensors, orders 0/1/2: sums
    within 1e-5 of each sum's largest magnitude, score within 1e-5, argmax
    equal."""
    from euispice_coreg_tpu_torch.engine import quad_score

    warped, ref, coeffs = quad_case()

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=cuda)

    canvas, ref_c = quad_score.quad_canvases(t(warped), t(ref), method=method)
    table = t(quad_score.coeff_table(coeffs))
    finish = (warp_score.pearson_from_sums if method == "correlation"
              else quad_score.residus_from_sums)
    for order in (0, 1, 2):
        kw = dict(pad=quad_score.PAD, order=order, method=method)
        before = quad_score.LAUNCHES
        got = quad_score.quad_score_sums(canvas, ref_c, table, **kw)
        assert quad_score.LAUNCHES == before + 1
        want = quad_score.quad_score_sums_reference(canvas, ref_c, table, **kw)
        got, want = got.cpu().numpy(), want.cpu().numpy()
        assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want).max(axis=0))
        np.testing.assert_allclose(finish(got), finish(want), atol=1e-5)
        assert np.nanargmax(finish(got)) == np.nanargmax(finish(want))


def test_carrington_engine_on_card_matches_cpu(cuda):
    """The Carrington engine on the card (``"pallas"``: the K2 select path;
    ``"exact"``: the gather) against the CPU (K2's plain version, the
    gather), float64: atol 1e-9."""
    from euispice_coreg_tpu_torch.core.header import Header
    from euispice_coreg_tpu_torch.engine import carrington, quad_score

    hdr = Header({
        "NAXIS1": 96, "NAXIS2": 96, "CRVAL1": 150.0, "CRVAL2": 100.0,
        "CRPIX1": 48.5, "CRPIX2": 48.5, "CDELT1": 8.0, "CDELT2": 8.0,
        "CUNIT1": "arcsec", "CUNIT2": "arcsec", "CROTA": 0.3,
        "DSUN_OBS": 0.5 * 1.496e11, "CRLN_OBS": 120.0, "CRLT_OBS": 3.0,
        "DATE-OBS": "2022-03-17T09:50:45"})
    sc = carrington.header_spherical_scalars(hdr, 1.004)
    px, py = np.meshgrid(np.arange(96.0), np.arange(96.0))
    lon, lat = carrington.spherical_unproject(px, py, sc)
    small = np.where(np.isfinite(lon),
                     100.0 + np.sin(np.nan_to_num(lon) * 2.0)
                     * np.cos(np.nan_to_num(lat) * 3.0), np.nan)
    lonlims, latlims, shape = (115.0, 125.0), (-2.0, 8.0), (112, 112)
    glon, glat = carrington.carrington_grid(lonlims, latlims, shape)
    ref = 100.0 + np.sin((glon + 0.01) * 2.0) * np.cos(glat * 3.0)
    axes = (np.arange(0.0, 31.0, 10.0) / 3600.0,
            np.arange(-20.0, 1.0, 10.0) / 3600.0, [0.0], [0.0], [0.0, 0.2])
    for mode in ("pallas", "exact"):
        kw = dict(d_solar_r=1.004, reference_date="2022-03-17T09:50:45",
                  rate_wave="171", compute_dtype="float64", lag_mode=mode)
        before = quad_score.LAUNCHES
        got = carrington.evaluate_lag_grid_carrington(
            small, ref, hdr, lonlims, latlims, shape, *axes, device=cuda,
            **kw)
        assert (quad_score.LAUNCHES > before) == (mode == "pallas")
        want = carrington.evaluate_lag_grid_carrington(
            small, ref, hdr, lonlims, latlims, shape, *axes, device="cpu",
            **kw)
        np.testing.assert_allclose(got, want, atol=1e-9)


def test_block_path_on_card_matches_cpu(cuda):
    """The block path (warps and float64 surfaces on the card) against the
    same call on CPU tensors, float64: atol 1e-9."""
    small, ref, lon, lat, base = make_case("tan", seed=4)
    c = base["cdelt1"]
    axes = (np.arange(-3, 4) * c, np.arange(-2, 3) * c, [0.0, 0.005 * c],
            [0.0], [-0.1, 0.0, 0.1])
    kw = dict(order=2, compute_dtype="float64", allow_fast="block")
    got = lag_search.evaluate_lag_grid(small, ref, lon, lat, base, *axes,
                                       device=cuda, **kw)
    want = lag_search.evaluate_lag_grid(
        *(torch.as_tensor(a) for a in (small, ref, lon, lat)), base,
        *axes, device="cpu", **kw)
    assert got.shape == (7, 5, 2, 1, 3)
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_movie_evaluator_on_card_matches_per_frame(cuda):
    """The movie evaluator against per-frame ``evaluate_from_displacements``
    on the card, orders 0 and 2, both methods: atol 1e-9."""
    from euispice_coreg_tpu_torch.engine import fast_corr

    rng = np.random.default_rng(5)
    frames = [make_case("tan", seed=s)[:2] for s in (6, 7, 8)]
    smalls = torch.as_tensor(np.stack([f[0] for f in frames]), device=cuda)
    refs = torch.as_tensor(np.stack([f[1] for f in frames]), device=cuda)
    cs = rng.uniform(-8.0, 8.0, size=(3, 25, 2))
    for order in (0, 2):
        for method in ("correlation", "residus_masked"):
            kw = dict(order=order, device=cuda, compute_dtype="float64",
                      method=method)
            got = fast_corr.evaluate_movie_from_displacements(smalls, refs,
                                                              cs, **kw)
            for f in range(3):
                want = fast_corr.evaluate_from_displacements(
                    smalls[f], refs[f], cs[f], 0.0, **kw)
                np.testing.assert_allclose(got[f], want, atol=1e-9)
