"""The port's tile-FFT Carrington evaluator (engine/tile_fft.py) and its
hybrid against the JAX package on the same inputs, made with numpy seeds
(the JAX side on the CPU takes ``rfft2``: ``precise_fft.use_precise_fft``
is False there)."""
import logging

import numpy as np
import pytest
import torch

import fixtures as fx
from euispice_coreg_tpu.core.header import Header as JHeader
from euispice_coreg_tpu.core.header import pc_from_crota
from euispice_coreg_tpu.engine import carrington as jcarr
from euispice_coreg_tpu.engine import pallas_quad as jpq
from euispice_coreg_tpu.engine import tile_fft as jtf
from euispice_coreg_tpu_torch import Alignment
from euispice_coreg_tpu_torch.core.header import Header
from euispice_coreg_tpu_torch.engine import carrington as carr
from euispice_coreg_tpu_torch.engine import quad_score
from euispice_coreg_tpu_torch.engine import tile_fft as tf

LOGGER = "euispice_coreg_tpu_torch"


def bench_like_config(n=256, grid=9, cdelt=16.0):
    """Oversampled Carrington config shaped like the benchmark leg (the
    fixture of the JAX package's tests/test_tile_fft.py)."""
    extra = {"DSUN_OBS": 0.5 * 1.496e11, "CRLN_OBS": 120.0, "CRLT_OBS": 3.0,
             "DATE-OBS": "2022-03-17T09:50:45", "WAVELNTH": 174}
    pc = pc_from_crota(0.3, cdelt, cdelt)
    hdr = JHeader({
        "NAXIS1": n, "NAXIS2": n, "CRVAL1": 150.0, "CRVAL2": 100.0,
        "CRPIX1": (n + 1) / 2, "CRPIX2": (n + 1) / 2,
        "CDELT1": cdelt, "CDELT2": cdelt,
        "CUNIT1": "arcsec", "CUNIT2": "arcsec", "CROTA": 0.3,
        "PC1_1": pc[0], "PC1_2": pc[1], "PC2_1": pc[2], "PC2_2": pc[3],
        **extra,
    })
    sc = jcarr.header_spherical_scalars(hdr, 1.004)
    px, py = np.meshgrid(np.arange(n, dtype=np.float64),
                         np.arange(n, dtype=np.float64))
    lon_c, lat_c = jcarr.spherical_unproject(px, py, sc)
    small = np.where(np.isfinite(lon_c),
                     scene(np.nan_to_num(lon_c), np.nan_to_num(lat_c)),
                     np.nan)
    lonlims, latlims, shape = (117.0, 123.0), (-1.0, 7.0), (n, n)
    lon_g, lat_g = jcarr.carrington_grid(lonlims, latlims, shape)
    ref = scene(lon_g, lat_g)
    step = 2.0 / 3600.0
    l1 = (np.arange(grid) - grid // 2) * step
    return hdr, small, ref, lonlims, latlims, shape, l1


def scene(lo, la):
    out = np.full(lo.shape, 100.0)
    rng = np.random.default_rng(11)
    for _ in range(25):
        cx = rng.uniform(116, 124)
        cy = rng.uniform(-3, 7)
        w_ = rng.uniform(0.3, 1.5)
        out += rng.uniform(0.5, 3) * np.exp(
            -(((lo - cx) ** 2) + ((la - cy) ** 2)) / (2 * w_ * w_))
    return out


@pytest.fixture(scope="module")
def cfg():
    return bench_like_config()


def canvases(seed, n=256, holes=True):
    """The JAX tests' pre-warped canvas and reference: a smooth pattern,
    noise, a masked border band and an interior NaN block."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ref = (100 + np.sin(xx / 9.0) * np.cos(yy / 13.0) * 10
           + rng.normal(size=(n, n)))
    warped = (100 + np.sin((xx + 1.2) / 9.0) * np.cos((yy - 0.8) / 13.0) * 10
              + rng.normal(size=(n, n)))
    if holes:
        ref[:6, :] = np.nan
        warped[40:44, 80:90] = np.nan
    return warped, ref


def gradient_coeffs(L, gx=0.02, gy=-0.015, span=3.0):
    """Per-lag constant shifts with a linear displacement gradient (dx grows
    with u by ``gx``, dy with v by ``gy``)."""
    coeffs = np.zeros((L, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-span, span, L)
    coeffs[:, 2, 1] = np.linspace(2.0 * span / 3, -2.0 * span / 3, L)
    coeffs[:, 0, 0] = gx
    coeffs[:, 1, 1] = gy
    return coeffs


def hybrid_coeffs():
    """Gradient-dominated lag set (tests/test_tile_fft.py): dx gradient
    grows with the lag index, so the full-set gate fails for every shape
    while the first lags pass one by one."""
    coeffs = np.zeros((9, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-2.0, 2.0, 9)
    coeffs[:, 2, 1] = np.linspace(1.5, -1.5, 9)
    coeffs[:, 0, 0] = np.linspace(0.0, 0.009, 9)
    return coeffs


def port(coeffs, warped, ref, **kw):
    return tf.evaluate_select_tile_fft(coeffs, warped, ref, device="cpu",
                                       **kw)


@pytest.mark.parametrize("method,order,dtype,rtol", [
    ("correlation", 2, "float64", 1e-9),
    ("residus_masked", 0, "float64", 1e-9),
    ("correlation", 0, "float32", 1e-4),
    ("residus_masked", 2, "float32", 1e-4),
])
def test_evaluate_select_tile_fft_matches_jax(method, order, dtype, rtol):
    """Same coefficients, canvas and reference, the tile shape auto-picked
    (detector/grid scale 0.1): the same shape in both packages, scores
    within 1e-9 (float64) or 1e-4 (float32) of the JAX package's, argmax
    (argmin for residues) equal."""
    h = w = 128
    warped, ref = canvases(7, n=h)
    coeffs = gradient_coeffs(9)
    kw = dict(order=order, h=h, w=w, method=method, compute_dtype=dtype,
              scale_det_per_grid=0.1)
    assert tf.pick_tile_shape(coeffs, h, w, 0.1) == \
        jtf.pick_tile_shape(coeffs, h, w, 0.1)
    want = jtf.evaluate_select_tile_fft(coeffs, warped, ref, **kw)
    got = port(coeffs, warped, ref, **kw)
    assert want is not None and got is not None and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol)
    best = np.argmax if method == "correlation" else np.argmin
    assert best(got) == best(want)


PICK_COEFFS = {
    "gradient": gradient_coeffs(7),
    "hybrid": hybrid_coeffs(),
    # anisotropic: strong x-gradient of dx only, +-30 px shifts
    "anisotropic": gradient_coeffs(5, gx=1.5e-3, gy=0.0, span=30.0),
    "quadratic": np.random.default_rng(5).normal(
        scale=[[1e-3], [1e-3], [5.0], [1e-6], [1e-6], [1e-6]],
        size=(40, 6, 2)),
}


@pytest.mark.parametrize("case", sorted(PICK_COEFFS))
def test_pickers_and_bounds_match_jax(case, monkeypatch):
    """The host planners copied from the JAX package give identical
    outputs: the tile-bound helpers of pallas_quad, the square and
    rectangular pickers, and the hybrid picker with the JAX package's rate
    constants and budget put into the port; the port's device offset
    bounds equal the host ones of both packages."""
    coeffs = PICK_COEFFS[case]
    monkeypatch.setattr(tf, "_est_stage1_seconds", jtf._est_stage1_seconds)
    monkeypatch.setattr(tf, "_EST_PALLAS_S_PER_LAG",
                        jtf._EST_PALLAS_S_PER_LAG)
    monkeypatch.setattr(tf, "MEM_BUDGET_BYTES", jtf._mem_budget_bytes())
    monkeypatch.setattr(tf, "TILE_BATCH", jtf._TILE_BATCH)
    for h, w in ((256, 256), (2048, 2048), (300, 517)):
        for th, tw in ((64, 64), (128, 96), (384, 512)):
            n_ty, n_tx = -(-h // th), -(-w // tw)
            args = (coeffs, h, w, n_ty, n_tx)
            np.testing.assert_array_equal(
                tf._tile_bounds_per_lag(*args, th=th, tw=tw),
                jpq._tile_bounds_per_lag(*args, th=th, tw=tw))
            assert tf._shift_bound(*args, th=th, tw=tw) == \
                jpq._shift_bound(*args, th=th, tw=tw)
            assert tf._tile_bounds(*args, th=th, tw=tw) == \
                jpq._tile_bounds(*args, th=th, tw=tw)
            host = tf._per_tile_offset_bounds(coeffs, th, tw, n_ty, n_tx)
            jhost = jtf._per_tile_offset_bounds(coeffs, th, tw, n_ty, n_tx)
            dev = tf._tile_offset_bounds(torch.as_tensor(coeffs), th, tw,
                                         n_ty, n_tx)
            for a, b, c in zip(host, jhost, dev):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(c, b)
        for scale in (1.0, 0.1):
            assert tf.pick_tile_size(coeffs, h, w, scale) == \
                jtf.pick_tile_size(coeffs, h, w, scale)
            assert tf.pick_tile_shape(coeffs, h, w, scale) == \
                jtf.pick_tile_shape(coeffs, h, w, scale)
            for dtype in ("float32", "float64"):
                got = tf.pick_tile_shape_hybrid(coeffs, h, w, scale,
                                                compute_dtype=dtype)
                want = jtf.pick_tile_shape_hybrid(coeffs, h, w, scale,
                                                  compute_dtype=dtype)
                assert (got is None) == (want is None)
                if got is not None:
                    assert got[0] == want[0]
                    np.testing.assert_array_equal(got[1], want[1])


def run_engine(cfg, mode, *, jax_side, method="correlation",
               dtype="float64", l5=(0.0,), window=None):
    hdr, small, ref, lonlims, latlims, shape, l1 = cfg
    if window is not None:
        lonlims, latlims, ref = window
    kw = dict(d_solar_r=1.004, reference_date=hdr["DATE-OBS"],
              rate_wave="171", order=2, method=method, compute_dtype=dtype,
              lag_mode=mode)
    axes = (l1, l1, [0.0], [0.0], list(l5))
    if jax_side:
        return jcarr.evaluate_lag_grid_carrington(
            small, ref, hdr, lonlims, latlims, shape, *axes, **kw)
    return carr.evaluate_lag_grid_carrington(
        small, ref, Header(dict(hdr.items())), lonlims, latlims, shape,
        *axes, device="cpu", **kw)


def test_evaluate_lag_grid_carrington_tile_fft_matches_jax(cfg, caplog):
    """lag_mode="tile_fft" on the bench-like 256^2 config, float64: the
    whole lag set on tile-FFT surfaces in both packages, values within 1e-6
    of the JAX package's, argmax equal, and equal to the port's "exact"
    (per-lag gather) argmax with the peak within 1e-3."""
    want = run_engine(cfg, "tile_fft", jax_side=True)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        got = run_engine(cfg, "tile_fft", jax_side=False)
    assert "carrington select: tile-FFT surfaces (81 lags)" in \
        caplog.messages
    assert not any("K2 quad kernel" in m for m in caplog.messages)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.nanargmax(got) == np.nanargmax(want)
    exact = run_engine(cfg, "exact", jax_side=False)
    assert np.nanargmax(got) == np.nanargmax(exact)
    assert abs(np.nanmax(got) - np.nanmax(exact)) < 1e-3


def test_tile_fft_residus_mode_matches_k2(cfg):
    """residus_masked under "tile_fft" against the same pre-warp scored by
    K2 (its plain version): argmin equal, values within 1e-3 (the JAX
    package's tolerance against its select evaluator)."""
    got = run_engine(cfg, "tile_fft", jax_side=False,
                     method="residus_masked")
    k2 = run_engine(cfg, "pallas", jax_side=False, method="residus_masked")
    assert np.nanargmin(got) == np.nanargmin(k2)
    np.testing.assert_allclose(got, k2, atol=1e-3)


def test_tile_fft_rotation_lags_via_combo_rewarp(caplog):
    """Rotation lags through the engine on a strongly oversampled window:
    the engine re-warps per (cdelt, crota) combo, so tile-FFT sees
    translation-only lag sets per combo.  Every combo on tile-FFT in the
    port, values within 5e-3 of the peak scale of the same pre-warps scored
    by K2, and within 1e-6 of the JAX package's tile-FFT run (float64)."""
    cfg = bench_like_config()
    lonlims, latlims, shape = (119.94, 120.06), (2.44, 2.56), (256, 256)
    lon_g, lat_g = jcarr.carrington_grid(lonlims, latlims, shape)
    window = (lonlims, latlims, scene(lon_g, lat_g))
    cfg3 = cfg[:6] + ((np.arange(3) - 1) * (2.0 / 3600.0),)
    lrot = (-0.5, 0.0, 0.5)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        c_t = run_engine(cfg3, "tile_fft", jax_side=False, l5=lrot,
                         window=window)
    legs = [m for m in caplog.messages if m.startswith("carrington select:")]
    assert legs == ["carrington select: tile-FFT surfaces (9 lags)"] * 3
    c_k = run_engine(cfg3, "pallas", jax_side=False, l5=lrot, window=window)
    scale = np.nanmax(np.abs(c_k)) + 1e-30
    np.testing.assert_allclose(c_t, c_k, atol=5e-3 * scale)
    c_j = run_engine(cfg3, "tile_fft", jax_side=True, l5=lrot, window=window)
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=1e-6)


def test_gate_reject_falls_back(tmp_path, monkeypatch, caplog):
    """When the gate and the hybrid decline, lag_search_mode="tile_fft"
    scores every lag on K2 through the public API and still recovers the
    injected (+20", -10")."""
    dl, hl, ds, hs = fx.make_carrington_pair(true_shift_arcsec=(20.0, -10.0))
    p_large, p_small = fx.write_pair_fits(tmp_path, dl, hl, ds, hs)
    monkeypatch.setattr(tf, "pick_tile_shape", lambda *a, **k: None)
    monkeypatch.setattr(tf, "pick_tile_shape_hybrid", lambda *a, **k: None)
    A = Alignment(p_large, p_small, lag_crval1=np.arange(0.0, 41.0, 10.0),
                  lag_crval2=np.arange(-30.0, 11.0, 10.0),
                  small_fov_window=0, large_fov_window=0,
                  lag_search_mode="tile_fft", device="cpu")
    with caplog.at_level(logging.INFO, logger=LOGGER):
        corr = A.align_using_carrington(
            lonlims=(115.0, 125.0), latlims=(-2.0, 8.0), shape=(128, 128),
            return_type="corr")
    assert "carrington tile-FFT gate failed, trying K2" in caplog.messages
    assert "carrington select: K2 quad kernel (25 lags)" in caplog.messages
    mi = np.unravel_index(np.nanargmax(corr), corr.shape)
    assert A.lag_crval1[mi[0]] == pytest.approx(20.0)
    assert A.lag_crval2[mi[1]] == pytest.approx(-10.0)


def test_per_tile_boxes_match_global_box(monkeypatch):
    """Per-tile offset boxes (each anchored at its tile's own offset range,
    which a strong displacement gradient moves apart by several pixels)
    give the scores of one global box for every tile."""
    h = w = 256
    T = 128
    warped, ref = canvases(7)
    coeffs = gradient_coeffs(5)
    o_min_t, _ = tf._per_tile_offset_bounds(coeffs, T, T, 2, 2)
    spread = o_min_t.max(axis=0) - o_min_t.min(axis=0)
    assert spread.max() >= 2, f"anchors degenerate: spread={spread}"

    kw = dict(order=2, h=h, w=w, method="correlation",
              compute_dtype="float64", tile_size=T)
    got = port(coeffs, warped, ref, **kw)
    orig = tf._tile_offset_bounds

    def global_bounds(cf, th_, tw_, n_ty_, n_tx_):
        omin, omax = orig(cf, th_, tw_, n_ty_, n_tx_)
        n = n_ty_ * n_tx_
        return (np.tile(omin.min(axis=0), (n, 1)),
                np.tile(omax.max(axis=0), (n, 1)))

    monkeypatch.setattr(tf, "_tile_offset_bounds", global_bounds)
    plans = []
    orig_plan = tf.plan_tiles
    monkeypatch.setattr(tf, "plan_tiles",
                        lambda *a, **k: plans.append(orig_plan(*a, **k))
                        or plans[-1])
    want = port(coeffs, warped, ref, **kw)
    assert got is not None and want is not None
    assert len({tuple(r) for r in plans[0].o_tab}) == 1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_tile_batch_matches_unbatched():
    """tile_batch > 1 (stage-1 transforms batched over tiles, with a short
    last step: 4 tiles at batch 3) reproduces tile_batch=1."""
    warped, ref = canvases(9, n=128)
    coeffs = gradient_coeffs(7)
    kw = dict(order=2, h=128, w=128, method="correlation",
              compute_dtype="float64", tile_size=64)
    base = port(coeffs, warped, ref, tile_batch=1, **kw)
    assert base is not None
    for b in (2, 3, 4):
        got = port(coeffs, warped, ref, tile_batch=b, **kw)
        np.testing.assert_allclose(got, base, rtol=1e-10, atol=1e-12)


def test_rectangular_tiles_match_square():
    """Rectangular tiles (both axis orders and a non-dividing shape with
    edge tiles) reproduce square-tile values on gradient-free lags, and keep
    the ranking (values within the approximation) with a gradient."""
    warped, ref = canvases(21, n=128)
    coeffs = gradient_coeffs(7, gx=0.01, gy=-0.008)
    kw = dict(order=2, h=128, w=128, method="correlation",
              compute_dtype="float64")
    base = port(coeffs, warped, ref, tile_size=64, **kw)
    cflat = coeffs.copy()
    cflat[:, 0, 0] = 0.0
    cflat[:, 1, 1] = 0.0
    base_flat = port(cflat, warped, ref, tile_size=64, **kw)
    assert base is not None and base_flat is not None
    for shape in ((64, 32), (32, 64), (64, 48)):
        got = port(cflat, warped, ref, tile_size=shape, **kw)
        np.testing.assert_allclose(got, base_flat, rtol=1e-8, atol=1e-10)
        got_g = port(coeffs, warped, ref, tile_size=shape, **kw)
        assert np.argmax(got_g) == np.argmax(base)
        np.testing.assert_allclose(got_g, base, atol=5e-3)


@pytest.mark.parametrize("case", ["smooth", "interior_nan_bands"])
def test_per_lag_hybrid_splits_and_matches_exact(case):
    """Gradient-dominated lag sets fail the full-set gate, the hybrid picks
    a shape that passes a prefix of the lags; tile-FFT on those, K2's plain
    version on the rest.  Against the JAX package's merge (its tile-FFT and
    its Pallas kernel in interpret mode, float32): atol 5e-4, argmax equal;
    against K2 on every lag: the failing lags equal, the rest within the
    tile approximation (5e-3).  ``interior_nan_bands``: full-width NaN
    bands on both canvases (the NaN masking rides the surface planes)."""
    h = w = 256
    if case == "smooth":
        warped, ref = canvases(17)
    else:
        warped, ref = canvases(29, holes=False)
        warped[96:112, :] = np.nan
        warped[200:206, 30:220] = np.nan
        ref[150:158, :] = np.nan
    coeffs = hybrid_coeffs()
    L = coeffs.shape[0]
    assert tf.pick_tile_shape(coeffs, h, w, 1.0) is None
    hyb = tf.pick_tile_shape_hybrid(coeffs, h, w, 1.0,
                                    compute_dtype="float64")
    assert hyb is not None
    (th, tw), mask = hyb
    assert 0 < mask.sum() < L
    assert mask[:int(mask.sum())].all() and not mask[int(mask.sum()):].any()

    got = np.empty(L)
    got[mask] = port(coeffs[mask], warped, ref, order=2, h=h, w=w,
                     compute_dtype="float64", tile_size=(th, tw))
    got[~mask] = quad_score.evaluate_select_quad(
        coeffs[~mask], warped, ref, order=2, device="cpu")
    k2_all = quad_score.evaluate_select_quad(coeffs, warped, ref, order=2,
                                             device="cpu")
    np.testing.assert_allclose(got[~mask], k2_all[~mask], rtol=1e-12)
    np.testing.assert_allclose(got, k2_all, atol=5e-3)
    assert np.argmax(got) == np.argmax(k2_all)

    jax_all = jpq.evaluate_select_carr_pallas(
        coeffs, warped, ref, order=2, h=h, w=w, method="correlation",
        interpret=True)
    want = np.empty(L)
    want[mask] = jtf.evaluate_select_tile_fft(
        coeffs[mask], warped, ref, order=2, h=h, w=w, method="correlation",
        compute_dtype="float64", tile_size=(th, tw))
    want[~mask] = jax_all[~mask]
    np.testing.assert_allclose(got, want, atol=5e-4)
    assert np.argmax(got) == np.argmax(want)


def test_mem_guard_declines_wide_span():
    """Wide per-lag offset spans need surface boxes beyond the budget: the
    evaluator and the hybrid picker decline before any device work, and the
    same geometry runs under a budget that admits it."""
    h = w = 256
    rng = np.random.default_rng(3)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ref = 100 + np.sin(xx / 9.0) * np.cos(yy / 13.0) * 10
    warped = np.roll(ref, (2, -3), axis=(0, 1)) + rng.normal(size=(h, w))
    # pure translations over +-80 px: no within-tile deviation, a ~160 px
    # per-tile box span
    coeffs = np.zeros((25, 6, 2))
    coeffs[:, 2, 0] = np.linspace(-80.0, 80.0, 25)
    coeffs[:, 2, 1] = np.linspace(60.0, -60.0, 25)
    kw = dict(order=2, h=h, w=w, compute_dtype="float64", tile_size=64)
    assert port(coeffs, warped, ref, mem_budget_bytes=2e6, **kw) is None
    assert tf.pick_tile_shape_hybrid(coeffs, h, w, 1.0,
                                     mem_budget_bytes=2e6) is None
    out = port(coeffs, warped, ref, mem_budget_bytes=8e9, **kw)
    assert out is not None and np.isfinite(out).all()
    hyb = tf.pick_tile_shape_hybrid(coeffs, h, w, 1.0, mem_budget_bytes=8e9)
    assert hyb is not None and hyb[1].all()


def test_hybrid_screen_declines_when_kernel_is_cheaper(monkeypatch):
    """The hybrid picker's stage-1 screen: with the planning throughput
    collapsed, every shape's estimated transforms cost more than K2 on the
    passing lags and the hybrid declines."""
    coeffs = hybrid_coeffs()
    assert tf.pick_tile_shape_hybrid(coeffs, 256, 256, 1.0) is not None
    monkeypatch.setattr(tf, "_EST_STAGE1_ELEMS_PER_S", 1.0)
    assert tf.pick_tile_shape_hybrid(coeffs, 256, 256, 1.0) is None


def test_grouped_scan_matches_single_pass(monkeypatch):
    """A budget that fits the r stack and 5 tiles' boxes runs 16 tiles as 4
    groups with an (L, 6) running sum: the scores of the single pass, and
    one group's boxes freed before the next group's are made (only one
    group is ever resident)."""
    import weakref

    warped, ref = canvases(11)
    coeffs = gradient_coeffs(7, gx=0.004, gy=0.0, span=2.0)
    kw = dict(order=2, h=256, w=256, method="correlation",
              compute_dtype="float64", tile_size=64)
    plans = []
    orig_plan = tf.plan_tiles
    monkeypatch.setattr(tf, "plan_tiles",
                        lambda *a, **k: plans.append(orig_plan(*a, **k))
                        or plans[-1])
    sizes = {}
    orig_group = tf._hbm_group_plan

    def spy(*a):
        g, rpad, bt = orig_group(*a)
        sizes.update(rpad=rpad, bt=bt)
        return g, rpad, bt

    monkeypatch.setattr(tf, "_hbm_group_plan", spy)
    want = port(coeffs, warped, ref, **kw)
    assert want is not None and plans[-1].group == 16

    boxes = []
    orig_surfaces = tf._tiles_surfaces

    def surfaces(*a, **k):
        assert all(b() is None for b in boxes), "two groups resident"
        S = orig_surfaces(*a, **k)
        boxes.append(weakref.ref(S))
        return S

    monkeypatch.setattr(tf, "_tiles_surfaces", surfaces)
    got = port(coeffs, warped, ref,
               mem_budget_bytes=sizes["rpad"] + 5 * sizes["bt"] + 1, **kw)
    assert plans[-1].group == 5 and len(boxes) == 4
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_inverse_matches_jax_partial_dft_box():
    """The port's inverse (irfft2 of the half spectra cropped to the box)
    against the JAX package's real-folded partial-DFT box (its TPU form,
    ``_folded_dft_mats`` and the two contractions of ``_tiles_surfaces``)
    on one tile's 66 surface planes, float64: within 1e-9 of the planes'
    peak."""
    warped, ref = canvases(13, n=128)
    coeffs = gradient_coeffs(7)
    dt = torch.float64
    plan = tf.plan_tiles(coeffs, order=2, h=128, w=128, compute_dtype=dt,
                         tile_size=64, device="cpu")
    g, r = tf._build_fields(torch.as_tensor(warped), torch.as_tensor(ref), 2,
                            "pearson", plan.hp, plan.wp)
    r_pad = tf._pad_r(r, plan.o_min, plan.o_max, plan.hp, plan.wp)
    G, R = tf._tile_spectra(g, r_pad, plan, [3])
    P = tf._products(G, R, 2, "pearson").numpy()        # (1, 66, my, K)
    my, mx, by, bx = plan.my, plan.mx, plan.by, plan.bx
    got = tf._inverse(torch.as_tensor(P), my, mx, by, bx).numpy()

    K = mx // 2 + 1
    _, _, Iy2, Ix2 = (np.asarray(m) for m in
                      jtf._folded_dft_mats(my, mx, by, bx, np.float64))
    Pstk = np.concatenate([P.real, P.imag], axis=2)      # (1, 66, 2my, K)
    Z = np.einsum("zy,csyk->cszk", Iy2, Pstk)
    want = np.einsum("cspyk,pkx->csyx", Z.reshape(1, 66, 2, by, K), Ix2)
    assert got.shape == want.shape == (1, 66, by, bx)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-9 * np.abs(want).max())


def test_tile_fft_mesh_of_several_devices_raises():
    """A mesh of several devices runs: the tile axis split over two or
    three shards, 4 tiles, gives the unsharded scores within 1e-12; a mesh
    of one device too."""
    warped, ref = canvases(3, n=128)
    coeffs = gradient_coeffs(3)
    kw = dict(order=2, h=128, w=128, compute_dtype="float64", tile_size=64)
    want = port(coeffs, warped, ref, **kw)
    assert want is not None
    for n in (1, 2, 3):
        got = port(coeffs, warped, ref, mesh=[torch.device("cpu")] * n, **kw)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_auto_on_a_card_holds_the_whole_set_to_k2(cfg, monkeypatch, caplog):
    """Routing: "auto" tries tile-FFT only on a card ("vs_k2"), the explicit
    "tile_fft" everywhere ("always", the JAX package's gates).  Under
    "vs_k2" the card's cost model decides: no gate at all where K2's
    estimate is under tile-FFT's fixed overhead; a whole-set plan whose
    stage-1 estimate plus that overhead exceeds K2's estimate declines
    (where "always", under the 15 s ceiling, runs it) and, having passed
    the gate, goes to K2 without the hybrid; one under it runs (ROADMAP
    section 3)."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert carr._tile_fft_mode("auto", cuda) == "vs_k2"
    assert carr._tile_fft_mode("auto", cpu) is None
    for dev in (cpu, cuda):
        assert carr._tile_fft_mode("tile_fft", dev) == "always"
        for mode in ("pallas", "fast", "exact"):
            assert carr._tile_fft_mode(mode, dev) is None

    hdr, small, ref, lonlims, latlims, shape, l1 = cfg
    sc = carr.header_spherical_scalars(Header(dict(hdr.items())), 1.004)
    kw = dict(order=2, method="correlation", device="cpu",
              compute_dtype="float64")
    args = (small, ref, sc, 0.0, "171", lonlims, latlims, shape, l1, l1,
            [0.0], [0.0], [0.0])
    k2 = carr._carrington_select(*args, **kw)

    def run(mode):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=LOGGER):
            out = carr._carrington_select(*args, tile_fft_mode=mode, **kw)
        return out, caplog.messages

    # 81 lags at 256^2: K2's estimate is far under the overhead
    got, lines = run("vs_k2")
    assert any(m.startswith("tile-FFT skipped: K2 est") for m in lines)
    assert "carrington select: K2 quad kernel (81 lags)" in lines
    assert not any(m.startswith("tile-FFT plan") for m in lines)
    np.testing.assert_array_equal(got, k2)

    plans = []
    orig_plan = tf.plan_tiles
    monkeypatch.setattr(tf, "plan_tiles",
                        lambda *a, **k: plans.append(orig_plan(*a, **k))
                        or plans[-1])
    always, lines = run("always")
    assert "carrington select: tile-FFT surfaces (81 lags)" in lines
    p = plans[-1]
    n_surf, n_rf = tf._plane_counts(2)
    # a throughput that puts this plan's stage-1 estimate at 1 s, and K2
    # rates that put its estimate for the 81 lags at 0.5 s and at 10 s
    monkeypatch.setattr(tf, "_EST_STAGE1_ELEMS_PER_S",
                        p.n_tiles * (n_surf + n_rf + 3) * p.my * p.mx / 1.0)
    grids = 81 * shape[0] * shape[1] / tf._EST_K2_GRID_PIXELS
    monkeypatch.setattr(tf, "_EST_PALLAS_S_PER_LAG", 0.5 / grids)
    hybrid_picks = []
    orig_hybrid = tf.pick_tile_shape_hybrid
    monkeypatch.setattr(tf, "pick_tile_shape_hybrid",
                        lambda *a, **k: hybrid_picks.append(k)
                        or orig_hybrid(*a, **k))
    got, lines = run("vs_k2")
    assert any(m.startswith("tile-FFT declined: est stage-1 transform "
                            "time 1.000 s > 0.457 s") for m in lines)
    assert not any(m.startswith("carrington select: tile-FFT surfaces")
                   for m in lines)
    # the whole set passed the gate: no hybrid, K2 scores every lag
    assert "carrington tile-FFT: the whole set passed the gate and was " \
        "declined against K2, no hybrid" in lines
    assert not hybrid_picks
    np.testing.assert_array_equal(got, k2)
    got, lines = run("always")
    np.testing.assert_array_equal(got, always)
    monkeypatch.setattr(tf, "_EST_PALLAS_S_PER_LAG", 10.0 / grids)
    got, lines = run("vs_k2")
    assert "carrington select: tile-FFT surfaces (81 lags)" in lines
    np.testing.assert_array_equal(got, always)
    assert np.nanargmax(always) == np.nanargmax(k2)
