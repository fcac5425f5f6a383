"""Single-process sharding over a list of devices (``utils/mesh.py``) and
every sharded path of the port, on the CPU: ``mesh=["cpu"] * 3`` with lag,
tile and frame counts that 3 does not divide, and fewer lags than shards.

Sharded against unsharded, the port is held to 1e-12 (the plain versions
are independent per lag, the tile sums move at rounding only), argmax
equal.  Against the JAX package's own sharded path, on a virtual CPU mesh of
three devices, each path is held to the tolerance of its existing parity
test, named in each test."""
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import fixtures as fx
import test_pallas_quad as tpq
import test_torch_carrington as tcarr
import test_torch_fast_corr as tfc
import test_torch_movie as tmov
import test_torch_tile_fft as ttf
import test_torch_warp_score as tws
from euispice_coreg_tpu.engine import carrington as jcarr
from euispice_coreg_tpu.engine import fast_corr as jfast
from euispice_coreg_tpu.engine import lag_search as jlag
from euispice_coreg_tpu.engine import pallas_quad as jquad
from euispice_coreg_tpu.engine import tile_fft as jtf
from euispice_coreg_tpu.jitter_correction import jitter_correction as jjit
from euispice_coreg_tpu.pxlshift import AlignmentPixels as JAlignmentPixels
from euispice_coreg_tpu_torch import Alignment
from euispice_coreg_tpu_torch.engine import (carrington, fast_corr,
                                              lag_search, quad_score,
                                              tile_fft, warp_score)
from euispice_coreg_tpu_torch.jitter_correction import (
    align_movie_to_reference, jitter_correction_imagers)
from euispice_coreg_tpu_torch.pxlshift import AlignmentPixels
from euispice_coreg_tpu_torch.utils import mesh as mesh_mod

MESH3 = ["cpu"] * 3
SHARDED_TOL = 1e-12
LOGGER = "euispice_coreg_tpu_torch"


def jax_mesh3():
    return Mesh(np.array(jax.devices()[:3]), axis_names=("lags",))


def assert_same(got, want, tol=SHARDED_TOL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert np.nanargmax(got) == np.nanargmax(want)


# ---------------------------------------------------------------------------
# utils/mesh.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 7, 13])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_split_covers_every_index_once_in_order(n, k):
    ranges = mesh_mod.split(n, ["cpu"] * k)
    assert len(ranges) == k
    assert [i for a, b in ranges for i in range(a, b)] == list(range(n))
    sizes = [b - a for a, b in ranges]
    assert sizes == [len(p) for p in np.array_split(np.arange(n), k)]


def test_resolve_mesh():
    assert mesh_mod.resolve_mesh(None) is None
    assert mesh_mod.resolve_mesh(MESH3) == (torch.device("cpu"),) * 3
    assert mesh_mod.resolve_mesh((torch.device("cpu"),)) == \
        (torch.device("cpu"),)
    with pytest.raises(TypeError):
        mesh_mod.resolve_mesh("cpu")
    with pytest.raises(ValueError):
        mesh_mod.resolve_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            mesh_mod.resolve_mesh(["cuda:0", "cuda:1"])


def test_default_mesh(monkeypatch):
    """None on the CPU and on one card, every card on several, never the
    CPU; ``Alignment(use_device_mesh=True)`` takes it and never raises for
    a device count."""
    assert mesh_mod.default_mesh("cpu") is None
    assert mesh_mod.default_mesh(torch.device("cpu")) is None
    A = Alignment("a", "b", device="cpu")
    assert A.mesh is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count in (1, 8):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        want = None if count == 1 else tuple(
            torch.device("cuda", i) for i in range(count))
        assert mesh_mod.default_mesh("cuda") == want
        assert Alignment("a", "b", device="cuda").mesh == want
        assert Alignment("a", "b", device="cuda",
                         use_device_mesh=False).mesh is None
    assert mesh_mod.default_mesh("cpu") is None


def test_replicate_copies_once_per_distinct_device():
    x = torch.arange(6.0).reshape(3, 2).T            # not contiguous
    out = mesh_mod.replicate(x, mesh_mod.resolve_mesh(MESH3))
    assert len(out) == 3 and out[0] is out[1] is out[2]
    assert out[0].is_contiguous()
    np.testing.assert_array_equal(out[0].numpy(), x.numpy())
    t = torch.arange(4.0)
    assert all(r is t for r in mesh_mod.replicate(t, MESH3))


def test_round_robin_takes_the_shards_in_turn():
    ranges = mesh_mod.split(7, MESH3)                 # 3, 2, 2 lags
    got = list(mesh_mod.round_robin(ranges, 2))
    assert got == [(0, 0, 2), (1, 3, 5), (2, 5, 7), (0, 2, 3)]
    parts = {s: torch.arange(s, e) for _k, s, e in got}
    np.testing.assert_array_equal(mesh_mod.gather(parts).numpy(),
                                  np.arange(7))


# ---------------------------------------------------------------------------
# the port sharded against the port unsharded
# ---------------------------------------------------------------------------

def tan_case(n=64):
    ds, ref, lon, lat, base, _ = tws.build_case("tan", n=n)
    return ds, ref, lon, lat, base


def crval_axes(base, n_lags):
    c = base["cdelt1"]
    return ((np.arange(n_lags) - n_lags // 2) * c, [0.0], [0.0], [0.0],
            [0.0])


@pytest.mark.parametrize("n_lags", [2, 7, 13])
def test_k1_lag_shards_match_unsharded(n_lags):
    """K1 (its plain version on the CPU) through ``evaluate_lag_grid(...,
    allow_fast="pallas")``: the lags split 3 ways."""
    ds, ref, lon, lat, base = tan_case()
    axes = crval_axes(base, n_lags)
    axes = (axes[0], axes[0][:2], axes[2], axes[3], [0.0, 0.3])
    kw = dict(order=2, kind="tan", device="cpu", compute_dtype="float64",
              allow_fast="pallas")
    want = lag_search.evaluate_lag_grid(ds, ref, lon, lat, base, *axes, **kw)
    got = lag_search.evaluate_lag_grid(ds, ref, lon, lat, base, *axes,
                                       mesh=MESH3, **kw)
    assert_same(got, want)
    again = warp_score.evaluate_lag_grid_warp(
        ds, ref, lon, lat, base, *axes, order=2, kind="tan", device="cpu",
        compute_dtype="float64", mesh=MESH3)
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("n_lags", [2, 7])
def test_gather_lag_shards_match_unsharded(n_lags):
    """The per-lag gather (residus_masked: no K1, no FFT)."""
    ds, ref, lon, lat, base = tan_case()
    ds, ref = np.abs(ds) + 5.0, np.abs(ref) + 5.0
    axes = crval_axes(base, n_lags)
    kw = dict(order=1, method="residus_masked", kind="tan", device="cpu",
              compute_dtype="float64", allow_fast=False, batch_size=2)
    want = lag_search.evaluate_lag_grid(ds, ref, lon, lat, base, *axes, **kw)
    got = lag_search.evaluate_lag_grid(ds, ref, lon, lat, base, *axes,
                                       mesh=MESH3, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=SHARDED_TOL)
    assert np.nanargmin(got) == np.nanargmin(want)


@pytest.mark.parametrize("order,method", [(2, "correlation"),
                                          (0, "residus_masked")])
def test_fft_plane_shards_match_unsharded(order, method, caplog):
    """The FFT path: one pair's surface planes split over 3 (and 7)
    devices."""
    ds, ref, lon, lat, base = tan_case()
    if method == "residus_masked":
        ds, ref = np.abs(ds) + 5.0, np.abs(ref) + 5.0
    l1 = np.array([-4.0, 0.0, 4.3, 8.1, 2.0]) / 3600.0
    l2 = np.array([-6.2, 0.0, 2.0]) / 3600.0
    kw = dict(order=order, kind="tan", device="cpu", compute_dtype="float64",
              method=method)
    want = lag_search.evaluate_lag_grid(ds, ref, lon, lat, base, l1, l2,
                                        [0.0], [0.0], [0.0], **kw)
    for mesh in (MESH3, ["cpu"] * 7):
        with caplog.at_level(logging.INFO, logger=LOGGER):
            got = lag_search.evaluate_lag_grid(ds, ref, lon, lat, base, l1,
                                               l2, [0.0], [0.0], [0.0],
                                               mesh=mesh, **kw)
        assert "engine path: FFT fast (crval grid)" in caplog.messages
        np.testing.assert_allclose(got, want, rtol=0, atol=SHARDED_TOL)


def test_block_path_shards_match_unsharded(caplog):
    """The block path: each combo's surface planes split over 3 devices."""
    ds, ref, lon, lat, base = tan_case()
    c = base["cdelt1"]
    axes = (np.array([-1.0, 0.0, 2.0]) * c, np.array([0.0, 1.0]) * c,
            [0.0, 0.01 * c], [0.0], [0.0, 0.2])
    kw = dict(order=2, kind="tan", device="cpu", compute_dtype="float64",
              allow_fast="block")
    want = lag_search.evaluate_lag_grid(ds, ref, lon, lat, base, *axes, **kw)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        got = lag_search.evaluate_lag_grid(ds, ref, lon, lat, base, *axes,
                                           mesh=MESH3, **kw)
    assert "engine path: FFT block fast (mixed grid)" in caplog.messages
    assert_same(got, want)


@pytest.mark.parametrize("n_frames", [2, 5])
def test_movie_frame_shards_match_unsharded(n_frames):
    """The movie evaluator with its frame axis split 3 ways (2 frames: one
    shard empty), numpy and tensor stacks."""
    rng = np.random.default_rng(4)
    ds, ref, *_ = tan_case()
    smalls = np.stack([np.roll(ds, k, axis=1) for k in range(n_frames)])
    refs = np.stack([np.roll(ref, -k, axis=0) for k in range(n_frames)])
    cs = rng.uniform(-4.0, 4.0, size=(n_frames, 11, 2))
    kw = dict(order=2, device="cpu", compute_dtype="float64")
    want = fast_corr.evaluate_movie_from_displacements(smalls, refs, cs, **kw)
    got = fast_corr.evaluate_movie_from_displacements(smalls, refs, cs,
                                                      mesh=MESH3, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=SHARDED_TOL)
    t = fast_corr.evaluate_movie_from_displacements(
        torch.as_tensor(smalls), torch.as_tensor(refs), cs, mesh=MESH3, **kw)
    np.testing.assert_array_equal(t, got)
    for f in range(n_frames):
        one = fast_corr.evaluate_from_displacements(smalls[f], refs[f], cs[f],
                                                    0.0, **kw)
        np.testing.assert_allclose(got[f], one, rtol=0, atol=SHARDED_TOL)


def k2_coeffs(L, seed=0):
    rng = np.random.default_rng(seed)
    coeffs = np.zeros((L, 6, 2))
    coeffs[:, 2] = rng.uniform(-9.0, 9.0, size=(L, 2))
    coeffs[:, 0, 0] = 2e-3
    coeffs[:, 4, 1] = -3e-5
    return coeffs


@pytest.mark.parametrize("n_lags", [2, 7, 13])
@pytest.mark.parametrize("method", ["correlation", "residus_masked"])
def test_k2_lag_shards_match_unsharded(n_lags, method):
    """K2 (its plain version on the CPU): the lags split 3 ways; two
    sharded calls bit-identical."""
    warped, ref = tpq.make_scene(h=64, w=48, with_nans=True)
    if method == "residus_masked":
        warped, ref = np.abs(warped) + 5.0, np.abs(ref) + 5.0
    coeffs = k2_coeffs(n_lags)
    kw = dict(order=2, method=method, device="cpu", compute_dtype="float64")
    want = quad_score.evaluate_select_quad(coeffs, warped, ref, **kw)
    got = quad_score.evaluate_select_quad(coeffs, warped, ref, mesh=MESH3,
                                          **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=SHARDED_TOL)
    np.testing.assert_array_equal(
        quad_score.evaluate_select_quad(coeffs, warped, ref, mesh=MESH3,
                                        **kw), got)


def test_tile_fft_tile_shards_match_unsharded(monkeypatch):
    """Tile-FFT with 16 tiles split 3 ways (6, 5, 5), groups of 4 tiles per
    device, the batch clamped to a device's share; the partial sums added
    on the first device."""
    warped, ref = ttf.canvases(5, n=128)
    coeffs = ttf.gradient_coeffs(7)
    kw = dict(order=2, h=128, w=128, compute_dtype="float64", tile_size=32,
              device="cpu")
    want = tile_fft.evaluate_select_tile_fft(coeffs, warped, ref, **kw)
    plans = []
    orig = tile_fft.plan_tiles
    monkeypatch.setattr(tile_fft, "plan_tiles",
                        lambda *a, **k: plans.append(orig(*a, **k))
                        or plans[-1])
    got = tile_fft.evaluate_select_tile_fft(coeffs, warped, ref, mesh=MESH3,
                                            tile_batch=16, **kw)
    assert plans[-1].n_tiles == 16 and plans[-1].batch == 6
    assert_same(got, want)
    n_surf, n_rf = tile_fft._plane_counts(2)
    plan = plans[-1]
    rpad = n_rf * (plan.hp + int(plan.o_max[1] - plan.o_min[1])) * (
        plan.wp + int(plan.o_max[0] - plan.o_min[0])) * 8
    bt = n_surf * plan.by * plan.bx * 8
    grouped = tile_fft.evaluate_select_tile_fft(
        coeffs, warped, ref, mesh=MESH3, mem_budget_bytes=rpad + 4 * bt + 1,
        **kw)
    assert plans[-1].group == 4
    assert_same(grouped, want)


@pytest.mark.parametrize("mode", ["exact", "pallas", "tile_fft", "auto"])
def test_carrington_modes_shard(mode, caplog):
    """``evaluate_lag_grid_carrington(mesh=)`` under each lag mode: the
    gather, K2, tile-FFT (whole set) and the block FFT path."""
    cfg = ttf.bench_like_config(n=128, grid=3)
    hdr, small, ref, lonlims, latlims, shape, l1 = cfg
    from euispice_coreg_tpu_torch.core.header import Header

    kw = dict(d_solar_r=1.004, reference_date=hdr["DATE-OBS"],
              rate_wave="171", order=2, compute_dtype="float64",
              lag_mode=mode, device="cpu")
    axes = (l1, l1[:2], [0.0], [0.0], [0.0])
    args = (small, ref, Header(dict(hdr.items())), lonlims, latlims, shape)
    want = carrington.evaluate_lag_grid_carrington(*args, *axes, **kw)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=LOGGER):
        got = carrington.evaluate_lag_grid_carrington(*args, *axes,
                                                      mesh=MESH3, **kw)
    leg = {"exact": "engine path: carrington per-lag gather",
           "pallas": "carrington select: K2 quad kernel (6 lags)",
           "tile_fft": "carrington select: tile-FFT surfaces (6 lags)",
           "auto": "engine path: carrington FFT fast"}[mode]
    assert leg in caplog.messages, caplog.messages
    assert_same(got, want)


def test_alignment_passes_its_mesh_on(tmp_path, caplog):
    """``Alignment`` hands ``self.mesh`` to the engine: a mesh of three CPU
    shards gives the unsharded hypercube, helioprojective (FFT path) and
    Carrington (K2)."""
    dl, hl, ds, hs = fx.make_helioprojective_pair(small_naxis=(64, 64))
    p_large, p_small = fx.write_pair_fits(tmp_path, dl, hl, ds, hs)
    lag = np.arange(-8.0, 9.0, 4.0)
    outs = []
    for mesh in (None, MESH3):
        A = Alignment(p_large, p_small, lag_crval1=lag, lag_crval2=lag,
                      small_fov_window=0, large_fov_window=0,
                      compute_dtype="float64", device="cpu")
        assert A.mesh is None
        A.mesh = mesh
        outs.append(A.align_using_helioprojective(return_type="corr"))
    assert_same(outs[1], outs[0])


def movie_paths(tmp_path):
    p_ref, paths, _ = tmov.write_movie(tmp_path)
    return p_ref, paths


def test_align_movie_fleet_matches_per_frame(tmp_path, caplog):
    """``align_movie_to_reference(mesh=)``: the fleet route (its log line),
    4 frames split 3 ways; every frame's hypercube, fitted shift and
    written CRVAL equal to the per-frame route's."""
    p_ref, paths = movie_paths(tmp_path)
    kw = dict(lag_crval1=tmov.LAGS, lag_crval2=tmov.LAGS,
              window_files_input=0, reference_window=0,
              compute_dtype="float64", device="cpu")
    out_s, out_f = tmp_path / "serial", tmp_path / "fleet"
    os.makedirs(out_s)
    os.makedirs(out_f)
    serial = align_movie_to_reference(paths, p_ref, str(out_s), **kw)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        fleet = align_movie_to_reference(paths, p_ref, str(out_f),
                                         mesh=MESH3, **kw)
    assert ("fleet movie search: 4 frames x 121 lags on 3 devices"
            in caplog.messages)
    assert sorted(fleet) == sorted(serial) == [0, 1, 2, 3]
    for k in serial:
        assert_same(fleet[k].corr, serial[k].corr)
        np.testing.assert_allclose(fleet[k].shift_arcsec,
                                   serial[k].shift_arcsec, atol=1e-9)
    names = [os.path.basename(p) for p in paths]
    np.testing.assert_allclose(tmov.read_crvals([out_f / n for n in names]),
                               tmov.read_crvals([out_s / n for n in names]),
                               atol=1e-9)


def test_fleet_preconditions_fall_back(tmp_path, caplog):
    """The per-frame loop runs for a mesh of one device and for a lag mode
    other than auto/fast; the fleet for a mesh of one device repeated."""
    p_ref, paths = movie_paths(tmp_path)
    kw = dict(lag_crval1=tmov.LAGS[::2], lag_crval2=tmov.LAGS[::2],
              window_files_input=0, reference_window=0, device="cpu")
    for mesh, extra, fleet in ((["cpu"], {}, False),
                               (MESH3, {"lag_search_mode": "exact"}, False),
                               (["cpu", "cpu"], {}, True)):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=LOGGER):
            res = align_movie_to_reference(paths[:2], p_ref, mesh=mesh,
                                           **kw, **extra)
        assert len(res) == 2
        assert any(m.startswith("fleet movie search")
                   for m in caplog.messages) == fleet


def test_jitter_fleet_matches_per_frame(tmp_path, caplog):
    """``jitter_correction_imagers(mesh=)``, helioprojective, CRVAL-only:
    each sublist one fleet search; the corrected CRVALs equal to the
    per-frame route's."""
    _, paths = movie_paths(tmp_path)
    out_s, out_f = tmp_path / "serial", tmp_path / "fleet"
    os.makedirs(out_s)
    os.makedirs(out_f)
    kw = dict(window_files_input=0, sublist_length=2, overlap=1,
              alignement_method="helioprojective", lag_crval1=tmov.LAGS,
              lag_crval2=tmov.LAGS, device="cpu")
    serial = jitter_correction_imagers(paths, str(out_s), **kw)
    with caplog.at_level(logging.INFO, logger=LOGGER):
        fleet = jitter_correction_imagers(paths, str(out_f), mesh=MESH3, **kw)
    assert sum(m.startswith("fleet movie search")
               for m in caplog.messages) == 2
    assert sorted(fleet) == sorted(serial) == [1, 2, 3]
    for k in serial:
        np.testing.assert_allclose(fleet[k].corr, serial[k].corr, rtol=0,
                                   atol=1e-9)
    names = [os.path.basename(p) for p in paths]
    np.testing.assert_allclose(tmov.read_crvals([out_f / n for n in names]),
                               tmov.read_crvals([out_s / n for n in names]),
                               atol=1e-6)


def test_pxlshift_rotation_fleet_matches_loop(tmp_path):
    """``AlignmentPixels.find_best_parameters``: the rotation fleet, on one
    device and with 4 rotations split 3 ways, gives the hypercube of a loop
    of :func:`fast_corr.pearson_integer_shifts` over the rotated
    canvases."""
    p_large, p_small = tmov.make_pxl_pair(tmp_path)
    lag_dx, lag_dy = np.arange(-4, 5), np.arange(-3, 4)
    drot = [-2.0, 0.0, 1.0, 2.0]
    A = AlignmentPixels(p_large, 0, p_small, 0, device="cpu")
    single = A.find_best_parameters(lag_dx, lag_dy, drot)
    want = np.stack([fast_corr.pearson_integer_shifts(
        A._canvas(d, "degree"), A.data_large, lag_dx, lag_dy, device="cpu")
        for d in drot], axis=-1)
    got = AlignmentPixels(p_large, 0, p_small, 0, device="cpu") \
        .find_best_parameters(lag_dx, lag_dy, drot, mesh=MESH3)
    assert got.shape == single.shape == (9, 7, 4)
    assert_same(single, want)
    assert_same(got, want)


# ---------------------------------------------------------------------------
# the port sharded against the JAX package sharded (3-device CPU mesh)
# ---------------------------------------------------------------------------

def test_k1_and_gather_match_jax_sharded():
    """The JAX sharded exact engine (``_sharded_evaluator``, the engine K1
    ports) against the port's K1 and gather on 3 shards, 7 x 2 x 2 lags:
    float64, atol 1e-6 (tests/test_torch_warp_score.py's), argmax
    equal."""
    ds, ref, lon, lat, base = tan_case()
    c = base["cdelt1"]
    axes = ((np.arange(7) - 3) * c, [0.0, c], [0.0], [0.0], [0.0, 0.3])
    want = jlag.evaluate_lag_grid(
        ds, ref, lon, lat, base, *axes, order=2, kind="tan",
        compute_dtype=jnp.float64, mesh=jax_mesh3(), allow_fast=False)
    for mode in ("pallas", False):
        got = lag_search.evaluate_lag_grid(
            ds, ref, lon, lat, base, *axes, order=2, kind="tan",
            device="cpu", compute_dtype="float64", allow_fast=mode,
            mesh=MESH3)
        assert_same(got, want, tol=1e-6)


def test_fft_path_matches_jax_sharded():
    """``evaluate_crval_grid_fast`` sharded in both packages (JAX: the
    field batch over the mesh): atol 1e-8 (tests/test_torch_fast_corr.py's),
    argmax equal."""
    ds, ref, lon, lat, base = tfc.build_case(n=64)
    l1 = np.array([-4.0, 0.0, 4.3, 8.1, 2.0]) / 3600.0
    l2 = np.array([-6.2, -3.9, 0.0, 2.0]) / 3600.0
    kw = dict(order=2, kind="tan", compute_dtype="float64")
    want = jfast.evaluate_crval_grid_fast(ds, ref, lon, lat, base, l1, l2,
                                          mesh=jax_mesh3(), **kw)
    got = fast_corr.evaluate_crval_grid_fast(ds, ref, lon, lat, base, l1, l2,
                                             device="cpu", mesh=MESH3, **kw)
    assert_same(got, want, tol=1e-8)


def test_movie_matches_jax_sharded():
    """The movie evaluator, 5 frames over 3 shards in both packages: atol
    1e-8 (tests/test_torch_block.py's), each frame's best lag equal."""
    rng = np.random.default_rng(2)
    ds, ref, *_ = tan_case()
    smalls = np.stack([np.roll(ds, k, axis=1) for k in range(5)])
    refs = np.stack([np.roll(ref, -k, axis=0) for k in range(5)])
    cs = rng.uniform(-4.0, 4.0, size=(5, 9, 2))
    kw = dict(order=2, compute_dtype="float64")
    want = jfast.evaluate_movie_from_displacements(smalls, refs, cs,
                                                   mesh=jax_mesh3(), **kw)
    got = fast_corr.evaluate_movie_from_displacements(
        smalls, refs, cs, device="cpu", mesh=MESH3, **kw)
    assert got.shape == want.shape == (5, 9)
    np.testing.assert_allclose(got, want, atol=1e-8)
    for f in range(5):
        assert np.nanargmax(got[f]) == np.nanargmax(want[f])


def test_k2_matches_jax_sharded():
    """K2 on 3 shards against the JAX Pallas quad kernel sharded over the
    lag axis (interpret mode on the CPU mesh), 12 lags: float32, atol 3e-4
    (tests/test_pallas_quad.py's), argmax equal."""
    warped, ref = tpq.make_scene(h=128, w=96, with_nans=True)
    coeffs = k2_coeffs(12, seed=3)
    want = jquad.evaluate_select_carr_pallas(coeffs, warped, ref, order=2,
                                             h=128, w=96, mesh=jax_mesh3())
    got = quad_score.evaluate_select_quad(coeffs, warped, ref, order=2,
                                          device="cpu", mesh=MESH3)
    assert want is not None
    assert_same(got, want, tol=3e-4)


def test_tile_fft_matches_jax_sharded():
    """Tile-FFT with the tile axis over 3 shards in both packages (JAX:
    one psum), 16 tiles: float64, atol 1e-9
    (tests/test_torch_tile_fft.py's), argmax equal."""
    warped, ref = ttf.canvases(9, n=128)
    coeffs = ttf.gradient_coeffs(7)
    kw = dict(order=2, h=128, w=128, compute_dtype="float64", tile_size=32)
    want = jtf.evaluate_select_tile_fft(coeffs, warped, ref, mesh=jax_mesh3(),
                                        **kw)
    got = tile_fft.evaluate_select_tile_fft(coeffs, warped, ref, device="cpu",
                                            mesh=MESH3, **kw)
    assert want is not None
    assert_same(got, want, tol=1e-9)


@pytest.mark.parametrize("mode,dtype,atol", [
    ("exact", "float64", 1e-6),    # per-lag gather, both packages
    ("pallas", "float32", 3e-4),   # select: K2 plain vs pallas interpret
])
def test_carrington_matches_jax_sharded(mode, dtype, atol):
    """``evaluate_lag_grid_carrington(mesh=)`` in both packages, 4 x 3
    lags: the tolerances of tests/test_torch_carrington.py for the mode,
    argmax equal."""
    dl, hl, ds, hs = fx.make_carrington_pair(true_shift_arcsec=(20.0, -10.0))
    ref = jcarr.reproject_to_carrington(
        dl, hl, tcarr.LONLIMS, tcarr.LATLIMS, tcarr.SHAPE, d_solar_r=1.004,
        reference_date=hl["DATE-OBS"], rate_wave="171",
        compute_dtype="float64")
    kw = dict(d_solar_r=1.004, reference_date=hl["DATE-OBS"],
              rate_wave="171", order=2, compute_dtype=dtype, lag_mode=mode)
    axes = (tcarr.L1[:4], tcarr.L2[:3], tcarr.ONE, tcarr.ONE, tcarr.ONE)
    args = (tcarr.LONLIMS, tcarr.LATLIMS, tcarr.SHAPE)
    want = jcarr.evaluate_lag_grid_carrington(ds, ref, hs, *args, *axes,
                                              mesh=jax_mesh3(), **kw)
    got = carrington.evaluate_lag_grid_carrington(
        ds, ref, tcarr.port_header(hs), *args, *axes, device="cpu",
        mesh=MESH3, **kw)
    assert_same(got, want, tol=atol)


def test_align_movie_matches_jax_fleet(tmp_path):
    """The movie fleet of both packages, 3 frames over 3 devices, float64:
    fitted shifts and written CRVALs within 1e-4" (the float64 tolerance of
    tests/test_torch_movie.py's movie test)."""
    p_ref, paths = movie_paths(tmp_path)
    paths = paths[1:]
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    os.makedirs(out_j)
    os.makedirs(out_t)
    kw = dict(lag_crval1=tmov.LAGS, lag_crval2=tmov.LAGS,
              window_files_input=0, reference_window=0,
              compute_dtype="float64")
    res_j = jjit.align_movie_to_reference(paths, p_ref, str(out_j),
                                          mesh=jax_mesh3(),
                                          use_device_mesh=False, **kw)
    res_t = align_movie_to_reference(paths, p_ref, str(out_t), device="cpu",
                                     mesh=MESH3, **kw)
    assert sorted(res_t) == sorted(res_j) == [0, 1, 2]
    for k in res_t:
        np.testing.assert_allclose(res_t[k].shift_arcsec,
                                   res_j[k].shift_arcsec, atol=1e-4)
    names = [os.path.basename(p) for p in paths]
    np.testing.assert_allclose(tmov.read_crvals([out_t / n for n in names]),
                               tmov.read_crvals([out_j / n for n in names]),
                               atol=1e-4)


def test_pxlshift_matches_jax_fleet(tmp_path):
    """The rotation fleet of both packages over 3 devices.  The JAX fleet
    builds float32 canvases and scores in float32, the port in float64:
    atol 1e-4 (the float32 tolerance of tests/test_torch_tile_fft.py's
    parity test), argmax equal."""
    p_large, p_small = tmov.make_pxl_pair(tmp_path)
    lag_dx, lag_dy = np.arange(-4, 5), np.arange(-3, 4)
    drot = [-2.0, 0.0, 2.0]
    want = JAlignmentPixels(p_large, 0, p_small, 0).find_best_parameters(
        lag_dx, lag_dy, drot, mesh=jax_mesh3())
    got = AlignmentPixels(p_large, 0, p_small, 0, device="cpu") \
        .find_best_parameters(lag_dx, lag_dy, drot, mesh=MESH3)
    assert_same(got, want, tol=1e-4)
