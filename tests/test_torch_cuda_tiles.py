"""Card tests of the lag-tile kernels K1 and K2 where their tiles are
ragged: a 517 x 301 grid (no multiple of the 8 x 32 pixel tile) with NaN
holes, and lag counts 1, LT + 1, 13 and 441 (LT, the lags of a block, read
from the build), against the plain versions on the same card tensors, in
float32 and float64.  Two launches must give bit-identical sums.  They skip
without a card.  This file imports no JAX, so it also runs on a machine
without it, without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_tiles.py
"""
import numpy as np
import pytest
import torch

from euispice_coreg_tpu_torch.core import wcs
from euispice_coreg_tpu_torch.engine import _build, quad_score, warp_score

pytestmark = pytest.mark.cuda

SHAPE = (517, 301)  # rows x columns
DTYPES = {"float32": torch.float32, "float64": torch.float64}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def lag_counts(lag_tile):
    return sorted({1, lag_tile + 1, 13, 441})


def holes(img, rng):
    h, w = img.shape
    for _ in range(3):
        r0, c0 = rng.integers(0, h - 40), rng.integers(0, w - 40)
        img[r0:r0 + 17, c0:c0 + 23] = np.nan
    return img


def blobs(u, v, rng):
    out = np.full(u.shape, 10.0)
    for cx, cy in rng.uniform(-0.4, 0.4, size=(12, 2)):
        out += np.exp(-((u - cx) ** 2 + (v - cy) ** 2) / 0.01)
    return out


def check(got, again, want, finish, pick):
    """Sums within 1e-5 of each sum's largest magnitude, scores within 1e-5,
    the same best lag, every lag with pixels, two launches bit-identical."""
    assert torch.equal(got, again)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.all(want[:, 0] > 0)
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want).max(axis=0))
    np.testing.assert_allclose(finish(got), finish(want), atol=1e-5)
    assert pick(finish(got)) == pick(finish(want))


def k1_case(kind, dtype, device, seed=0):
    """Centred canvas, ref, lon, lat on a SHAPE grid and the base WCS: the
    small image is the scene moved by 3 px along x."""
    h, w = SHAPE
    rng = np.random.default_rng(seed)
    rho = np.deg2rad(0.6)
    cdelt, crval = ((2.0 / 3600.0, (0.03, 0.02)) if kind == "tan"
                    else (0.01, (120.0, 0.0)))
    base = {"crval1": crval[0], "crval2": crval[1], "crpix1": (w + 1) / 2,
            "crpix2": (h + 1) / 2, "cdelt1": cdelt, "cdelt2": cdelt,
            "pc11": np.cos(rho), "pc12": -np.sin(rho), "pc21": np.sin(rho),
            "pc22": np.cos(rho), "crota": 0.6}
    x, y = np.meshgrid(np.arange(w, dtype=float), np.arange(h, dtype=float))
    lon, lat = wcs.pixel_to_world(base, x, y, kind=kind, xp=np)
    u, v = (x - w / 2) / w, (y - h / 2) / h
    small = holes(blobs(u + 3.0 / w, v, np.random.default_rng(seed + 1)), rng)
    ref = holes(blobs(u, v, np.random.default_rng(seed + 1)), rng)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    canvas = torch.nn.functional.pad(
        t(small - np.nanmean(small))[None, None], (2,) * 4,
        mode="reflect")[0, 0].contiguous()
    return canvas, t(ref - np.nanmean(ref)), t(lon), t(lat), base


def k1_lags(n_lags, cdelt, seed):
    """Lags around the true shift (3 px along x), the truth among them."""
    rng = np.random.default_rng(seed)
    lags = np.zeros((n_lags, 5))
    lags[:, 0] = (3.0 + rng.uniform(-4, 4, n_lags)) * cdelt
    lags[:, 1] = rng.uniform(-4, 4, n_lags) * cdelt
    lags[:, 2] = rng.uniform(-0.005, 0.005, n_lags) * cdelt
    lags[:, 4] = rng.uniform(-0.1, 0.1, n_lags)
    lags[n_lags // 2] = (3.0 * cdelt, 0.0, 0.0, 0.0, 0.0)
    return lags


def k2_case(method, dtype, device, seed=0):
    """Kernel operands of a smooth positive image with NaN holes and its
    reference moved by (dx, dy) = (5, -3)."""
    h, w = SHAPE
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    warped = 60.0 + np.sin(xx / 9.0) * np.cos(yy / 13.0) \
        + 0.1 * rng.standard_normal((h, w))
    ref = np.roll(warped, (3, -5), axis=(0, 1)) \
        + 0.05 * rng.standard_normal((h, w))
    warped, ref = holes(warped, rng), holes(ref, rng)
    return quad_score.quad_canvases(
        torch.as_tensor(warped, dtype=dtype, device=device),
        torch.as_tensor(ref, dtype=dtype, device=device), method=method)


def k2_lags(n_lags, seed):
    """Shifts, affine and quadratic terms around the truth, the truth among
    them."""
    rng = np.random.default_rng(seed)
    c = np.zeros((n_lags, 6, 2))
    c[:, 2, 0] = 5.0 + rng.uniform(-6, 6, n_lags)
    c[:, 2, 1] = -3.0 + rng.uniform(-6, 6, n_lags)
    c[:, 0, 0] = rng.uniform(-2e-3, 2e-3, n_lags)
    c[:, 4, 1] = rng.uniform(-2e-6, 2e-6, n_lags)
    c[n_lags // 2] = 0.0
    c[n_lags // 2, 2] = (5.0, -3.0)
    return c


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["tan", "car"])
def test_k1_ragged_tiles_match_plain_version(cuda, kind, dtype):
    canvas, ref, lon, lat, base = k1_case(kind, DTYPES[dtype], cuda)
    lag_tile = warp_score.build_tiles(_build.load("warp_score"),
                                      "warp_score")[0]
    for k, n_lags in enumerate(lag_counts(lag_tile)):
        lags = k1_lags(n_lags, base["cdelt1"], seed=n_lags)
        table = torch.as_tensor(warp_score.lag_table(base, lags),
                                dtype=DTYPES[dtype], device=cuda)
        kw = dict(pad=2, order=(2 - k) % 3, kind=kind)
        before = warp_score.LAUNCHES
        got = warp_score.warp_score_sums(canvas, ref, lon, lat, table, **kw)
        again = warp_score.warp_score_sums(canvas, ref, lon, lat, table, **kw)
        assert warp_score.LAUNCHES == before + 2
        want = warp_score.warp_score_sums_reference(canvas, ref, lon, lat,
                                                    table, **kw)
        check(got, again, want, warp_score.pearson_from_sums, np.nanargmax)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("method", ["correlation", "residus_masked"])
def test_k2_ragged_tiles_match_plain_version(cuda, method, dtype):
    canvas, ref = k2_case(method, DTYPES[dtype], cuda)
    lag_tile = warp_score.build_tiles(_build.load("quad_score"),
                                      "quad_score")[0]
    finish, pick = ((warp_score.pearson_from_sums, np.nanargmax)
                    if method == "correlation"
                    else (quad_score.residus_from_sums, np.nanargmin))
    for k, n_lags in enumerate(lag_counts(lag_tile)):
        table = torch.as_tensor(quad_score.coeff_table(k2_lags(n_lags, k)),
                                dtype=DTYPES[dtype], device=cuda)
        kw = dict(pad=quad_score.PAD, order=(2 - k) % 3, method=method)
        before = quad_score.LAUNCHES
        got = quad_score.quad_score_sums(canvas, ref, table, **kw)
        again = quad_score.quad_score_sums(canvas, ref, table, **kw)
        assert quad_score.LAUNCHES == before + 2
        want = quad_score.quad_score_sums_reference(canvas, ref, table, **kw)
        check(got, again, want, finish, pick)


def test_partial_buffer_stays_bounded_at_many_lags(cuda):
    """14641 lags on a 2048^2 grid: one launch, a grid and a partial buffer
    of the size launch_geometry gives (a few MB), sums equal to the same
    lags scored in chunks of 1000 within 1e-12 of each sum's largest
    magnitude (a chunk has another number of pixel groups, so another
    summation order), and every 37th lag as the plain version scores it
    (the tolerances of check)."""
    n = 2048
    rng = np.random.default_rng(9)
    img = torch.as_tensor(100.0 + rng.standard_normal((n, n)),
                          dtype=torch.float32, device=cuda)
    canvas, ref = quad_score.quad_canvases(img, img.roll(3, 1),
                                           method="correlation")
    table = torch.as_tensor(quad_score.coeff_table(k2_lags(14641, 3)),
                            dtype=torch.float32, device=cuda)
    tiles, groups = warp_score.launch_geometry(
        n, n, 14641, warp_score.build_tiles(_build.load("quad_score"),
                                            "quad_score"))
    assert tiles * groups <= 2 * warp_score.TARGET_BLOCKS
    assert 14641 * groups * 6 * 8 < 16e6
    kw = dict(pad=quad_score.PAD, order=2, method="correlation")
    whole = quad_score.quad_score_sums(canvas, ref, table, **kw)
    chunks = torch.cat([
        quad_score.quad_score_sums(canvas, ref, table[s:s + 1000], **kw)
        for s in range(0, 14641, 1000)])
    rows = torch.arange(0, 14641, 37, device=cuda)
    want = quad_score.quad_score_sums_reference(canvas, ref, table[rows],
                                                **kw)
    check(whole[rows], whole[rows], want, warp_score.pearson_from_sums,
          np.nanargmax)
    whole, chunks = whole.cpu().numpy(), chunks.cpu().numpy()
    assert np.isfinite(whole).all()
    assert np.all(np.abs(chunks - whole)
                  <= 1e-12 * np.abs(whole).max(axis=0))
