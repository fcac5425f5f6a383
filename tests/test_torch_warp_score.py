"""K1's plain version (the CPU side of engine/warp_score.py) against the JAX
package's exact per-lag engine and its Pallas kernel in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures as fx
from euispice_coreg_tpu.core.header import get_crota, wcs_params_from_header
from euispice_coreg_tpu.engine import lag_search as jlag
from euispice_coreg_tpu.engine import pallas_common as jpc
from euispice_coreg_tpu.engine import pallas_warp as jwarp
from euispice_coreg_tpu.utils import coords
from euispice_coreg_tpu_torch.engine import warp_score
from euispice_coreg_tpu_torch.utils.torchcfg import from_jax_state


def build_case(kind, n=128, seed=0):
    """Small/ref pair on one comparison grid with NaN holes, TAN or CAR."""
    if kind == "tan":
        _, _, ds, hs = fx.make_helioprojective_pair(
            true_shift_arcsec=(8.0, -4.0), small_naxis=(n, n),
            small_cdelt=(2.0, 2.0), seed=seed)
        lon, lat = coords.header_world_grid(hs)
        ref = fx.scene_helioprojective(lon, lat, seed=seed)
    else:
        hs = fx.make_header((n, n), (15.0, 15.0), (120.3 * 3600, 0.0), 0.4,
                            ctype=("CRLN-CAR", "CRLT-CAR"))
        lon, lat = coords.header_world_grid(hs, wrap=False)
        ref = fx.scene_carrington(lon, lat, seed=seed)
        ds = fx.scene_carrington(lon + 0.01, lat - 0.005, seed=seed)
    ds = ds.copy()
    ds[10:20, 30:40] = np.nan
    ref = ref.copy()
    ref[50:60, 5:15] = np.nan
    base = {**wcs_params_from_header(hs).as_dict(), "crota": get_crota(hs)}
    return ds, ref, lon, lat, base, hs


def lag_axes(cdelt_deg):
    """2 x 2 crval x 2 cdelt1 x 1 x 2 crota = 16 lags with a cdelt and a
    crota lag."""
    return ([0.0, 3.0 * cdelt_deg], [-2.0 * cdelt_deg, 0.0],
            [0.0, 0.02 * cdelt_deg], [0.0], [0.0, 0.5])


@pytest.mark.parametrize("kind", ["tan", "car"])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_plain_k1_matches_jax_exact_engine(kind, order):
    """float64: atol 1e-6 against JAX ``lag_search._evaluate_flat``, argmax
    equal."""
    ds, ref, lon, lat, base, _ = build_case(kind)
    axes = lag_axes(base["cdelt1"])
    grids = np.meshgrid(*axes, indexing="ij")
    lags = np.stack([g.ravel() for g in grids], axis=-1)
    base_j = {k: jnp.asarray(v, dtype=jnp.float64) for k, v in base.items()}
    want = np.asarray(jlag._evaluate_flat(
        jnp.asarray(lags), jnp.asarray(ds), jnp.asarray(ref),
        jnp.asarray(lon), jnp.asarray(lat), base_j, order=order,
        method="correlation", kind=kind, batch_size=8)).reshape(
        tuple(len(a) for a in axes))
    got = warp_score.evaluate_lag_grid_warp(
        ds, ref, lon, lat, base, *axes, order=order, kind=kind,
        device="cpu", compute_dtype="float64")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.nanargmax(got) == np.nanargmax(want)


@pytest.mark.parametrize("kind,order", [("tan", 2), ("car", 1)])
def test_plain_k1_matches_jax_pallas_interpret(kind, order):
    """float32, 128^2, 4 lags: atol 2e-4 (the JAX pallas test's own)
    against ``pallas_warp.evaluate_lag_grid_pallas(interpret=True)``."""
    ds, ref, lon, lat, base, _ = build_case(kind, seed=1)
    c = base["cdelt1"]
    axes = ([0.0, 3.0 * c], [-2.0 * c], [0.0], [0.0], [0.0, 0.3])
    want = jwarp.evaluate_lag_grid_pallas(
        ds, ref, lon, lat, base, *axes, order=order, kind=kind,
        interpret=True)
    got = warp_score.evaluate_lag_grid_warp(
        ds, ref, lon, lat, base, *axes, order=order, kind=kind,
        device="cpu", compute_dtype="float32")
    assert want is not None
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert np.nanargmax(got) == np.nanargmax(want)


def test_lag_table_matches_jax_apply_lag():
    """Per-lag WCS table: float64 host math equals JAX apply_lag_to_params
    (crval-only lags keep PC verbatim, cdelt/crota lags rebuild it)."""
    _, _, _, _, base, _ = build_case("tan")
    lags = np.array([[1e-3, -2e-3, 0.0, 0.0, 0.0],
                     [0.0, 0.0, 1e-6, 0.0, 0.0],
                     [0.0, 0.0, 0.0, -2e-6, 0.3]])
    table = warp_score.lag_table(base, lags)
    base_j = {k: jnp.asarray(v, dtype=jnp.float64) for k, v in base.items()}
    for i, d in enumerate(lags):
        want = jlag.apply_lag_to_params(base_j, jnp.asarray(d))
        got = dict(zip(warp_score.TABLE_KEYS, table[i]))
        for k in warp_score.TABLE_KEYS:
            assert got[k] == pytest.approx(float(want[k]), rel=1e-14,
                                           abs=1e-18)


def test_pearson_from_sums_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(5, 300))
    b = a + rng.normal(scale=0.5, size=a.shape)
    sums = np.stack([np.full(5, 300.0), a.sum(1), (a * a).sum(1), b.sum(1),
                     (b * b).sum(1), (a * b).sum(1)], axis=-1)
    np.testing.assert_allclose(warp_score.pearson_from_sums(sums),
                               jpc.pearson_from_sums(sums), rtol=1e-14)
    np.testing.assert_allclose(
        warp_score.pearson_from_sums(sums),
        [np.corrcoef(x, y)[0, 1] for x, y in zip(a, b)], rtol=1e-10)


def test_lag_chunks_join_seamlessly(monkeypatch):
    """Lags split over several launches give the one-launch result."""
    ds, ref, lon, lat, base, _ = build_case("tan", n=96)
    axes = lag_axes(base["cdelt1"])
    whole = warp_score.evaluate_lag_grid_warp(
        ds, ref, lon, lat, base, *axes, order=2, device="cpu",
        compute_dtype="float64")
    monkeypatch.setattr(warp_score, "MAX_LAGS", 5)
    chunked = warp_score.evaluate_lag_grid_warp(
        ds, ref, lon, lat, base, *axes, order=2, device="cpu",
        compute_dtype="float64")
    np.testing.assert_array_equal(chunked, whole)


def test_k1_declines_like_jax():
    """Only JAX's own declines: a method other than correlation, order 3,
    or a reference of another shape."""
    ds, ref, lon, lat, base, _ = build_case("tan", n=96)
    args = (ds, ref, lon, lat, base, [0.0], [0.0], [0.0], [0.0], [0.0])
    for kw in ({"method": "residus"}, {"method": "residus_masked"},
               {"order": 3}):
        assert warp_score.evaluate_lag_grid_warp(*args, device="cpu",
                                                 **kw) is None
        assert jwarp.evaluate_lag_grid_pallas(*args, interpret=True,
                                              **kw) is None
    assert warp_score.evaluate_lag_grid_warp(
        ds, ref[:-1], lon, lat, base, [0.0], [0.0], [0.0], [0.0], [0.0],
        device="cpu") is None
    # a 45-degree rotation lag: JAX declines on its 8-px residual bound, the
    # port has no bound and scores it
    out = warp_score.evaluate_lag_grid_warp(
        ds, ref, lon, lat, base, [0.0], [0.0], [0.0], [0.0], [45.0],
        device="cpu")
    assert out is not None and np.isfinite(out).all()


def test_launch_geometry_bounds_grid_and_partials():
    """The kernels' grid (csrc/sampling.cuh), from the tiles a build
    reports (lags per block, pixel tile rows and columns): every lag in one
    lag tile (the last one ragged), at most one pixel group per pixel tile,
    about TARGET_BLOCKS blocks, so the (L, groups, 6) float64 partial buffer
    stays a few MB at 14641 lags."""
    for h, w, n_lags, lag_tile in ((2048, 2048, 14641, 4),
                                   (2048, 2048, 1323, 2), (517, 301, 1, 8),
                                   (517, 301, 441, 1), (8, 32, 3, 2),
                                   (3, 3, 65535, 4)):
        tiles, groups = warp_score.launch_geometry(h, w, n_lags,
                                                   (lag_tile, 8, 32))
        pixel_tiles = -(-h // 8) * -(-w // 32)
        assert (tiles - 1) * lag_tile < n_lags <= tiles * lag_tile
        assert 1 <= groups <= min(pixel_tiles, warp_score.TARGET_BLOCKS)
        assert groups == 1 or tiles * groups < warp_score.TARGET_BLOCKS \
            + tiles
    tiles, groups = warp_score.launch_geometry(2048, 2048, 14641, (4, 8, 32))
    assert (tiles, groups) == (3661, 3)
    assert 14641 * groups * 6 * 8 < 3e6  # bytes of the partial buffer
    assert warp_score.launch_geometry(517, 301, 441, (1, 8, 32)) == (441, 19)
    assert warp_score.launch_geometry(8, 32, 3, (2, 8, 32)) == (2, 1)
    # the pixel tile is the build's: 16 tiles of 8 x 32, 4 of 32 x 32
    assert warp_score.launch_geometry(64, 64, 1, (1, 8, 32)) == (1, 16)
    assert warp_score.launch_geometry(64, 64, 1, (1, 32, 32)) == (1, 4)


def _operands():
    ds, ref, lon, lat, base, _ = build_case("tan", n=96)
    base, small, ref_t, lon_t, lat_t = from_jax_state(
        base, ds, ref, lon, lat, device="cpu", dtype=torch.float32)
    canvas = torch.nn.functional.pad(
        torch.nan_to_num(small)[None, None], (2, 2, 2, 2),
        mode="reflect")[0, 0].contiguous()
    table = torch.as_tensor(warp_score.lag_table(base, np.zeros((3, 5))),
                            dtype=torch.float32)
    return canvas, ref_t, lon_t, lat_t, table


def test_wrapper_checks_operands():
    canvas, ref, lon, lat, table = _operands()
    kw = dict(pad=2, order=2, kind="tan")
    assert warp_score.warp_score_sums(canvas, ref, lon, lat, table,
                                      **kw).shape == (3, 6)
    with pytest.raises(TypeError):
        warp_score.warp_score_sums(canvas, ref.double(), lon, lat, table,
                                   **kw)
    with pytest.raises(ValueError):
        warp_score.warp_score_sums(canvas[:-1], ref, lon, lat, table, **kw)
    with pytest.raises(ValueError):
        warp_score.warp_score_sums(canvas, ref.t(), lon, lat, table, **kw)
    with pytest.raises(ValueError):
        warp_score.warp_score_sums(canvas, ref, lon, lat, table[:, :9]
                                   .contiguous(), **kw)
    with pytest.raises(ValueError):
        warp_score.warp_score_sums(canvas, ref, lon, lat, table, pad=2,
                                   order=3, kind="tan")
