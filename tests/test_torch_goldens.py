"""The JAX package's hypercubes of the bench legs (``tests/goldens/
jax_bench_legs.npz``, written by ``tools/gen_jax_goldens_torch.py``) and
the port's comparison with them (``bench_torch.compare_to_golden``).

The committed file's sizes and lags are bench.py's and bench_torch.py's,
and the port renders the core leg's operands to its fingerprints.  At
small sizes the generator's calls run here through the JAX package and
the same legs through the port on the CPU, and the comparison passes;
moved values, a moved argmax, a NaN and a moved operand each fail it,
naming the leg."""
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import bench  # noqa: E402
import bench_torch  # noqa: E402
import gen_jax_goldens_torch as gen  # noqa: E402
from euispice_coreg_tpu_torch.engine import carrington as pcarr  # noqa: E402

CPU = torch.device("cpu")
SMALL_LEGS = ("core", "api", "mixed", "carr_coarse")
OWN_PROBE_FIT = pcarr._probe_fit_products


@pytest.fixture(scope="module")
def committed():
    return bench_torch.load_golden()


def small_sizes(monkeypatch):
    for k, v in gen.SMALL.items():
        monkeypatch.setattr(bench_torch, k, tuple(v) if isinstance(v, list)
                            else v)


def jax_warp(img, lon, lat, params, kind, order):
    """The JAX package's block-path warp (its lag_search._warp_by_params,
    the parameters in the grid's dtype as its block path passes them), in
    the port's signature."""
    import jax.numpy as jnp

    from euispice_coreg_tpu.engine import lag_search as jls

    img_j, lon_j, lat_j = (jnp.asarray(t.numpy()) for t in (img, lon, lat))
    p = {k: jnp.asarray(v, dtype=lon_j.dtype) for k, v in params.items()}
    out = jls._warp_by_params(img_j, lon_j, lat_j, p, kind, order)
    return torch.tensor(np.asarray(out), dtype=img.dtype)


def jax_probe_fit(combo, lonlims, latlims, dc1, dc2, delta_t, rate_wave,
                  dlon_step, dlat_step, design, *, device):
    """The port's Carrington probe fit with the JAX package's coefficients
    (its _probe_fit_products in the bench's compute dtype, float32)."""
    from euispice_coreg_tpu.engine import carrington as jcarr

    ok, _, fit_err, scale = OWN_PROBE_FIT(
        combo, lonlims, latlims, dc1, dc2, delta_t, rate_wave, dlon_step,
        dlat_step, design, device=device)
    d = design
    coeffs = jcarr._probe_fit_products(
        combo, lonlims, latlims, tuple(bench_torch.CARR_SHAPE), dc1, dc2,
        delta_t, rate_wave, "float32", d["pxf"], d["pyf"], dlon_step,
        dlat_step, d["pinv"], d["design"], d["coeff_rescale"],
        d["probe_shape"])[1]
    return ok, np.array(coeffs, dtype=np.float64), fit_err, scale


def run_port_leg(leg, td):
    """One bench_torch leg on the CPU, run once; its kept entry.  Where
    the two packages' float32 arithmetic moves pixels across a NaN edge,
    which at 256^2 weighs ~1e-4 in r, the leg runs with the JAX package's
    result of that one stage, held to the port's own by a test of its own:
    the mixed leg's block path warps through the JAX package's warp
    (``jax_warp``, ``test_mixed_warps_differ_only_on_the_border_mask``),
    and carr_coarse's K2 samples through the JAX package's float32 probe
    fit (``jax_probe_fit``,
    ``test_carrington_probe_fit_is_float64_here_float32_there``)."""
    from euispice_coreg_tpu_torch.engine import lag_search

    small, ref, lon, lat, base = bench_torch.synthesize_pair(CPU)
    ops = (small, ref, lon, lat)
    if leg == "core":
        bench_torch.run_core(*ops, base, CPU)
    elif leg == "mixed":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lag_search, "_warp_by_params", jax_warp)
            bench_torch.run_mixed_grid(*ops, base, CPU)
    elif leg == "api":
        bench_torch.run_full_api(td, small.numpy(), ref.numpy(), base, CPU)
    elif leg == "carr_coarse":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pcarr, "_probe_fit_products", jax_probe_fit)
            bench_torch.run_carrington_coarse(CPU)
    return {"corr": bench_torch.last_result, "inputs": bench_torch.last_inputs,
            "route": bench_torch.last_route}


@pytest.fixture(scope="module")
def small_pair(tmp_path_factory):
    """The JAX package's small golden (written and read back through the
    file) and the port's kept legs at the same sizes."""
    path = str(tmp_path_factory.mktemp("golden") / "small.npz")
    for leg in SMALL_LEGS:
        gen.write_leg(path, leg, gen.compute_leg(leg, gen.SMALL), "small")
    mp = pytest.MonkeyPatch()
    try:
        small_sizes(mp)
        mp.setattr(bench_torch, "timed_best", bench_torch.run_once)
        td = str(tmp_path_factory.mktemp("port"))
        port = {leg: run_port_leg(leg, td) for leg in SMALL_LEGS}
        sizes = bench_torch.sizes()
    finally:
        mp.undo()
    return bench_torch.load_golden(path), port, sizes, path


def compare(golden, port, leg, sizes, monkeypatch, **kw):
    for k, v in sizes.items():
        monkeypatch.setattr(bench_torch, k, tuple(v) if isinstance(v, list)
                            else v)
    k = port[leg]
    return bench_torch.compare_to_golden(leg, k["corr"], k["inputs"], golden,
                                         route=k["route"], **kw)


def test_committed_constants_are_the_benches(committed, monkeypatch):
    """Every leg of the committed file at bench.py's and bench_torch.py's
    sizes, with the lag arrays bench_torch.py's legs pass (each leg run up
    to its timed call at tiny image sizes), and the generator's constants
    record bench.py's steps."""
    assert set(committed) - {"meta"} == set(gen.LEGS)
    assert committed["meta"]["x64"] is True
    assert committed["meta"]["sizes"] == "full"
    for leg in gen.LEGS:
        c = committed[leg]["constants"]
        assert (c["N_SMALL"], c["N_REF"], c["GRID"]) == \
            (bench.N_SMALL, bench.N_REF, bench.GRID), leg
        assert {k: c[k] for k in bench_torch.sizes()} == bench_torch.sizes()
    assert committed["core"]["constants"]["step_arcsec"] == 0.5
    assert committed["carr_coarse"]["constants"]["injected_arcsec"] == \
        [24.0, 0.0]

    class Stop(Exception):
        pass

    def stop(run, n=2):
        raise Stop

    monkeypatch.setattr(bench_torch, "timed_best", stop)
    monkeypatch.setattr(bench_torch, "N_SMALL", 32)
    monkeypatch.setattr(bench_torch, "N_REF", 32)
    monkeypatch.setattr(bench_torch, "CARR_SHAPE", (16, 16))
    monkeypatch.setattr(bench_torch, "IMAGER_SHAPE", (64, 64))
    small, ref, lon, lat, base = bench_torch.synthesize_pair(CPU)
    ops = (small, ref, lon, lat)
    runs = {
        "core": lambda td: bench_torch.run_core(*ops, base, CPU),
        "api": lambda td: bench_torch.run_full_api(
            td, small.numpy(), ref.numpy(), base, CPU),
        "mixed": lambda td: bench_torch.run_mixed_grid(*ops, base, CPU),
        "synras": lambda td: bench_torch.run_synras_spice(td, CPU),
        "iterative": lambda td: bench_torch.run_iterative_spice(td, CPU),
        "carr": lambda td: bench_torch.run_carrington(CPU),
        "carr_coarse": lambda td: bench_torch.run_carrington_coarse(CPU),
        "carr_api": lambda td: bench_torch.run_carrington_api(td, CPU),
    }
    for leg, run in runs.items():
        bench_torch.last_inputs = None
        with pytest.raises(Stop):
            import tempfile

            with tempfile.TemporaryDirectory() as td:
                run(td)
        got = bench_torch.last_inputs["lags"]
        for a, b in zip(got, committed[leg]["lags"]):
            np.testing.assert_array_equal(a, b, err_msg=leg)
        assert set(bench_torch.last_inputs["operands"]) == \
            set(committed[leg]["operands"]), leg


def test_core_pair_matches_committed_fingerprints(committed):
    """bench_torch.synthesize_pair on the CPU at 2048^2 matches the file's
    fingerprints of bench.py's renders within 1e-12 relative."""
    small, ref, lon, lat, _ = bench_torch.synthesize_pair(CPU)
    for name, t in zip(("small", "ref", "lon", "lat"), (small, ref, lon, lat)):
        shape, st = bench_torch.fingerprint(t)
        gshape, gst = committed["core"]["operands"][name]
        assert tuple(shape) == tuple(gshape) and st[0] == gst[0] == 0
        np.testing.assert_allclose(st[1:], gst[1:], rtol=1e-12, atol=0,
                                   err_msg=name)


def test_fingerprints_agree_between_writer_and_reader():
    """The generator's fingerprint and bench_torch's are one function."""
    a = np.random.default_rng(3).normal(size=(17, 9)).astype(np.float32)
    a[2, 3] = np.nan
    ws, wst = gen.fingerprint(a)
    rs, rst = bench_torch.fingerprint(torch.as_tensor(a))
    np.testing.assert_array_equal(ws, rs)
    np.testing.assert_array_equal(wst, rst)
    assert wst[0] == 1


@pytest.mark.parametrize("leg", SMALL_LEGS)
def test_port_matches_jax_at_small_sizes(small_pair, leg, monkeypatch):
    """The generator's call of each leg through the JAX package against
    bench_torch's leg through the port, both at 256^2 (a 64^2 Carrington
    grid, 41 lags a side): the comparison passes.  The api leg went
    through Alignment, whose fast-path probes are the header's float64
    ones in both packages (lag_search.seed_probe_values); with the grid's
    float32 probes the port sat 1.2e-3 off the JAX package here.  The
    carr_coarse leg is K2's plain version against the JAX package's quad
    kernel (interpret mode).  The mixed and carr_coarse legs take one
    stage's result from the JAX package (``run_port_leg``)."""
    golden, port, sizes, _ = small_pair
    f = compare(golden, port, leg, sizes, monkeypatch)
    assert f["problems"] == [], bench_torch.golden_line(f)
    assert f["tol"] == (bench_torch.TOL_FLOAT32 if leg == "carr_coarse"
                        else bench_torch.TOL_SAME_ALGORITHM)
    assert f["max_abs"] < 1e-6


def test_mixed_warps_differ_only_on_the_border_mask():
    """Why the mixed leg's own block path is not held at 256^2: its
    CROTA = 0 combo warps the small image through its own WCS, which puts
    the outer ring of pixels on the image's edge, where each package's
    float32 arithmetic (the JAX package's block path passes its
    parameters in the grid's dtype too) rounds some in and some out.  The
    two warps' NaN masks differ on the outer ring and nowhere else, and
    their finite values agree within 1e-6 relative; at 256^2 a ring pixel
    weighs ~1/N^2 of r, at 2048^2 on the card the leg is within 1e-5
    (chip_smoke.py phase Q)."""
    from euispice_coreg_tpu_torch.engine import lag_search

    bench, small, ref, lon, lat, base = gen._pair(gen.SMALL)
    combo = lag_search._apply_lag_to_params_np(base, np.zeros(5))
    params = {k: v for k, v in combo.items() if k != "crota"}
    img, lon32, lat32 = (torch.as_tensor(np.asarray(a, np.float32))
                         for a in (small, lon, lat))
    ours = lag_search._warp_by_params(img, lon32, lat32, params, "tan",
                                      2).numpy()
    theirs = jax_warp(img, lon32, lat32, params, "tan", 2).numpy()
    fo, ft = np.isfinite(ours), np.isfinite(theirs)
    ring = np.ones_like(fo)
    ring[1:-1, 1:-1] = False
    assert (fo != ft).any() and not ((fo != ft) & ~ring).any()
    both = fo & ft
    assert np.abs(ours[both] - theirs[both]).max() < \
        1e-6 * np.abs(theirs[both]).max()


def test_carr_coarse_jax_routes_part_where_the_canvas_ends(small_pair):
    """The carr_coarse golden is the JAX package's quad kernel, whose
    canvas is the Carrington grid; its exact engine (the generator's
    witness, every 10th lag) samples the whole detector image.  At lag 0
    the two agree; where the lag shifts the small image's footprint past
    the grid's edge they part by far more than the across-algorithms
    tolerance, and the port's K2 sits as far from the exact engine as the
    JAX package's own kernel does."""
    golden, port, sizes, _ = small_pair
    g = golden["carr_coarse"]
    w = g["witness"]
    sub = (slice(None, None, w["step"]),) * 2
    jax_k2, ours = g["corr"][sub], port["carr_coarse"]["corr"][sub]
    c = tuple(n // 2 for n in w["corr"].shape[:2])
    assert abs(w["corr"][c] - jax_k2[c]) < bench_torch.TOL_ACROSS_ALGORITHMS
    gap = np.abs(w["corr"] - jax_k2)
    assert gap.max() > 5 * bench_torch.TOL_ACROSS_ALGORITHMS
    assert np.abs(np.abs(w["corr"] - ours) - gap).max() < \
        bench_torch.TOL_FLOAT32


def test_generator_is_reproducible(tmp_path):
    """Two runs of the generator, each running the leg in a process of
    its own as it always does, write identical arrays."""
    outs = [str(tmp_path / f"run{i}.npz") for i in (0, 1)]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    runs = [subprocess.Popen([sys.executable, gen.__file__, "--small",
                              "--leg", "core", "--out", out], env=env,
                             stdout=subprocess.DEVNULL) for out in outs]
    assert [r.wait(timeout=600) for r in runs] == [0, 0]
    with np.load(outs[0]) as a, np.load(outs[1]) as b:
        assert a.files == b.files and "core.corr" in a.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def corrupt(golden, leg, fn):
    g = copy.deepcopy(golden)
    fn(g[leg])
    return g


@pytest.mark.parametrize("case", ["value", "argmax", "nan", "operand",
                                  "lags", "sizes"])
def test_a_corrupted_golden_fails_naming_the_leg(small_pair, monkeypatch,
                                                 case):
    """One value moved by 10x the tolerance, the argmax moved, a NaN, an
    operand's sum off by 1e-9 relative, a lag moved or other sizes: the
    comparison fails with a message that names the leg."""
    golden, port, sizes, _ = small_pair
    leg = "core"
    tol = bench_torch.TOL_SAME_ALGORITHM
    gc = golden[leg]["corr"]
    best = np.unravel_index(np.nanargmax(gc), gc.shape)

    def value(g):
        g["corr"] = gc.copy()
        g["corr"][0, 0, 0, 0, 0] += 10 * tol

    def argmax(g):
        g["corr"] = gc.copy()
        g["corr"][best] -= 0.5

    def nan(g):
        g["corr"] = gc.copy()
        g["corr"][3, 4, 0, 0, 0] = np.nan

    def operand(g):
        shape, st = g["operands"]["ref"]
        g["operands"]["ref"] = (shape, st * np.array([1, 1 + 1e-9, 1]))

    def lags(g):
        g["lags"][0] = g["lags"][0] + 1e-9

    def other_sizes(g):
        g["constants"]["GRID"] = 121

    fns = {"value": value, "argmax": argmax, "nan": nan, "operand": operand,
           "lags": lags, "sizes": other_sizes}
    f = compare(corrupt(golden, leg, fns[case]), port, leg, sizes,
                monkeypatch)
    assert f["problems"], case
    assert all(p.startswith(f"{leg}: ") for p in f["problems"])
    want = {"value": "max |dr|", "argmax": "argmax", "nan": "NaN pattern",
            "operand": "operand ref", "lags": "lags",
            "sizes": "golden sizes"}[case]
    assert any(want in p for p in f["problems"]), f["problems"]


def test_tie_rule_only_below_the_golden_margin(small_pair, monkeypatch):
    """Where the golden's own top-2 margin is below the tolerance, an
    argmax at another lag within the tolerance of the golden's maximum
    passes (and says so); one further down fails.  The port's K1 plane
    option takes the argmax on one CROTA plane."""
    golden, port, sizes, _ = small_pair
    leg = "mixed"
    tol = bench_torch.TOL_SAME_ALGORITHM
    g = golden[leg]
    f = compare(golden, port, leg, sizes, monkeypatch)
    assert f["margin"] < tol and f["tie_rule"]

    gc = g["corr"]
    top = np.unravel_index(np.nanargmax(gc), gc.shape)
    flat = np.sort(gc[np.isfinite(gc)].ravel())
    second = tuple(int(i[0]) for i in np.nonzero(gc == flat[-2]))
    low = tuple(int(i[0]) for i in np.nonzero(gc == flat[0]))
    for target, ok in ((second, True), (low, False)):
        p = {leg: dict(port[leg], corr=gc.copy())}
        p[leg]["corr"][target] = gc[top] + tol / 4
        p[leg]["corr"][top] = gc[top] - tol / 4 if ok else gc[top]
        fo = compare(golden, p, leg, sizes, monkeypatch)
        arg_bad = [m for m in fo["problems"] if "argmax" in m]
        assert (not arg_bad) == ok, (target, fo["problems"])
    plane = (slice(None), slice(None), 0, 0, 1)
    fp = compare(golden, port, leg, sizes, monkeypatch, plane=plane)
    assert not [m for m in fp["problems"] if "argmax" in m]
    assert len(fp["argmax"][0]) == 2


def test_routes_name_their_tolerance():
    """One algorithm on both sides: 1e-5, or 2e-4 for a Carrington select
    algorithm (the port's float64 probe fit against the JAX package's
    float32 one); the block path against K1: 2e-4; two other algorithms
    (K2 or tile-FFT against the select evaluator or the exact engine, an
    FFT route against an exact one, a hybrid): 1e-2.  A leg whose
    operands the card built holds the argmax only, exactly."""
    same = bench_torch.TOL_SAME_ALGORITHM
    fit = bench_torch.TOL_FLOAT32
    block = bench_torch.TOL_BLOCK_VS_EXACT
    across = bench_torch.TOL_ACROSS_ALGORITHMS
    tile = "carrington select: tile-FFT surfaces (14641 lags)"
    k2 = "carrington select: K2 quad kernel (14641 lags)"
    sel = "engine path: carrington linearized select"
    fft = "engine path: FFT fast (crval grid)"
    k1 = "engine path: K1 fused warp+score kernel"
    gather = ("lag_mode=tile_fft: carrington select preconditions failed, "
              "falling back to per-lag gather")
    for port, jax, want in (
            (fft, fft, same), (tile, f"lag_mode=tile_fft: {tile} | {sel}",
                               fit), (k2, "carrington select: pallas quad "
                                      "kernel (9 lags)", fit),
            (k2, sel, across), (tile, sel, across), (k2, gather, across),
            (tile, gather, across), (fft, k1, across),
            (k1, "engine path: FFT block fast (mixed grid)", block),
            ("carrington select: hybrid tile-FFT (9 lags, shape (64, 64))"
             " + exact kernels (4 lags)", "carrington select: hybrid "
             "tile-FFT (9 lags, shape (64, 64))", across)):
        assert bench_torch.golden_tolerance(port, jax)[0] == want, (port, jax)


def test_card_built_operands_hold_the_argmax_exactly(small_pair,
                                                     monkeypatch):
    """A leg of bench_torch.DEVICE_BUILT run on a card holds no value and
    the argmax exactly, even where the golden's margin is below the
    same-algorithm tolerance; other legs are held as on the host."""
    golden, port, sizes, _ = small_pair
    assert "api" in bench_torch.DEVICE_BUILT
    assert "core" not in bench_torch.DEVICE_BUILT
    f = compare(golden, port, "api", sizes, monkeypatch, built_on_card=True)
    assert f["tol"] is None and not f["tie_rule"] and not f["problems"]
    assert "argmax only" in f["tol_rule"]
    moved = {"api": dict(port["api"], corr=port["api"]["corr"] + 1e-3)}
    assert not compare(golden, moved, "api", sizes, monkeypatch,
                       built_on_card=True)["problems"]
    gc = golden["api"]["corr"]
    flat = np.sort(gc[np.isfinite(gc)].ravel())
    second = tuple(int(i[0]) for i in np.nonzero(gc == flat[-2]))
    tied = {"api": dict(port["api"], corr=gc.copy())}
    tied["api"]["corr"][second] = flat[-1] + 1e-9
    fa = compare(golden, tied, "api", sizes, monkeypatch, built_on_card=True)
    assert any("argmax" in p for p in fa["problems"])
    f = compare(golden, port, "core", sizes, monkeypatch, built_on_card=True)
    assert f["tol"] == bench_torch.TOL_SAME_ALGORITHM


def test_seeded_probes_are_held_by_weak_reference():
    """lag_search.seed_probe_values: the seeded values for those two
    tensors only, the grid's own values otherwise; gone with the tensor;
    no-op for numpy arrays."""
    import gc

    from euispice_coreg_tpu_torch.engine import lag_search

    lon = torch.arange(64.0).reshape(8, 8)
    lat = -lon
    pl, pb = np.arange(5.0) + 0.5, -np.arange(5.0) - 0.5
    lag_search.seed_probe_values(lon, lat, pl, pb)
    got = lag_search.probe_values(lon, lat)
    np.testing.assert_array_equal(got[0], pl)
    np.testing.assert_array_equal(got[1], pb)
    other = lag_search.probe_values(lon.clone(), lat)
    np.testing.assert_array_equal(other[0], [36.0, 0.0, 7.0, 56.0, 63.0])
    n = len(lag_search._SEEDED_PROBES)
    del lon, got
    gc.collect()
    assert len(lag_search._SEEDED_PROBES) == n - 1
    lag_search.seed_probe_values(np.zeros((8, 8)), np.zeros((8, 8)), pl, pb)
    assert len(lag_search._SEEDED_PROBES) == n - 1


def test_standalone_bench_records_a_failed_comparison(small_pair, monkeypatch,
                                                      capsys, tmp_path):
    """bench_torch.compare_kept, as main calls it: a leg whose golden was
    moved comes back with its problems; a file at other sizes or no file
    compares nothing."""
    golden, port, sizes, path = small_pair
    for k, v in sizes.items():
        monkeypatch.setattr(bench_torch, k, tuple(v) if isinstance(v, list)
                            else v)
    kept = {leg: port[leg] for leg in ("core", "api")}
    assert bench_torch.compare_kept(kept, path) == {}
    moved = dict(kept, core=dict(kept["core"],
                                 corr=kept["core"]["corr"] + 1e-3))
    errs = bench_torch.compare_kept(moved, path)
    assert list(errs) == ["core"] and "max |dr|" in errs["core"]
    assert bench_torch.compare_kept(moved, str(tmp_path / "none.npz")) == {}
    monkeypatch.setattr(bench_torch, "GRID", 121)
    assert bench_torch.compare_kept(moved, path) == {}
    assert "other sizes" in capsys.readouterr().err


def test_carrington_probe_fit_is_float64_here_float32_there():
    """The carr leg's probe fit (2048^2 grid, 121^2 lags at 0.5"): the
    port's float64 fit equals the JAX package's float64 fit within 1e-6
    grid px at the grid's corners, while the JAX package's own fit, in the
    bench's compute dtype float32, sits 1e-4 to 5e-3 px away.  That is the
    deliberate difference the tile-FFT legs' tolerance
    (``bench_torch.TOL_FLOAT32``) stands for."""
    from euispice_coreg_tpu.engine import carrington as jcarr
    from euispice_coreg_tpu_torch.engine import carrington as carr

    hdr = bench_torch._carr_header(2048, 2.0, 150.0, 100.0)
    combo = carr._combo(carr.header_spherical_scalars(hdr, 1.004), 0.0, 0.0,
                        0.0)
    lag = (np.arange(121) - 60) * 0.5
    g1, g2 = np.meshgrid(lag, lag, indexing="ij")
    shape = (2048, 2048)
    d = carr.probe_design(shape)
    lon, lat = bench_torch.CARR_LONLIMS, bench_torch.CARR_LATLIMS
    steps = ((lon[1] - lon[0]) / 2047, (lat[1] - lat[0]) / 2047)
    args = (combo, lon, lat, g1.ravel(), g2.ravel(), 0.0, "171", *steps, d)
    ours = carr._probe_fit_products(*args, device="cpu")[1]

    def jax_fit(dtype):
        return jcarr._probe_fit_products(
            combo, lon, lat, shape, g1.ravel(), g2.ravel(), 0.0, "171", dtype,
            d["pxf"], d["pyf"], *steps, d["pinv"], d["design"],
            d["coeff_rescale"], d["probe_shape"])[1]

    c = np.array([[0, 0], [2047, 0], [0, 2047], [2047, 2047], [1024, 700]],
                 dtype=float)
    basis = np.stack([c[:, 0], c[:, 1], np.ones(5), c[:, 0] ** 2,
                      c[:, 1] ** 2, c[:, 0] * c[:, 1]], axis=-1)

    def at(coeffs):
        return np.einsum("pq,lqk->lpk", basis, coeffs)

    assert np.abs(at(ours) - at(jax_fit("float64"))).max() < 1e-6
    assert 1e-4 < np.abs(at(ours) - at(jax_fit("float32"))).max() < 5e-3
