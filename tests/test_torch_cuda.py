"""Tests that need a CUDA card: the K1 kernel against its plain version and
the engine paths on the card against the CPU.  They skip without a card.
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
