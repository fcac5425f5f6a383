"""The port's examples (``examples/*_torch.py``) against the JAX package.

The port's generators (``examples/_synthetic_torch.py``) give the arrays and
header cards of ``tests/fixtures.py``; each port example's ``main`` runs on
the CPU, and the JAX package's public API, called with the JAX example's
own arguments on the files the port example wrote, gives the same
hypercube argmax, values and fitted shifts.  Each test states its
tolerances."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import fixtures as fx
from euispice_coreg_tpu.hdrshift import Alignment as JAlignment
from euispice_coreg_tpu.hdrshift import AlignmentResults as JAlignmentResults
from euispice_coreg_tpu.hdrshift import AlignmentSpice as JAlignmentSpice
from euispice_coreg_tpu.io import fits as jfits
from euispice_coreg_tpu.jitter_correction import \
    jitter_correction_imagers as jjitter_correction_imagers
from euispice_coreg_tpu.synras import \
    SPICEComposedMapBuilder as JSPICEComposedMapBuilder
from euispice_coreg_tpu_torch.hdrshift import Alignment
from euispice_coreg_tpu_torch.io import fits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
sys.path.insert(0, EXAMPLES)

import _synthetic_torch as synth  # noqa: E402
import align_hri_fsi_torch  # noqa: E402
import align_spice_synras_torch  # noqa: E402
import demo_synthetic_torch  # noqa: E402
import jitter_movie_torch  # noqa: E402

SCRIPTS = {"demo_synthetic": demo_synthetic_torch,
           "align_hri_fsi": align_hri_fsi_torch,
           "align_spice_synras": align_spice_synras_torch,
           "jitter_movie": jitter_movie_torch}

# The default float32 FFT path on both sides: hypercubes within 1e-4
# (tests/test_torch_alignment.py), argmax equal.  The 5x5 Gaussian fit of
# AlignmentResults is the same function in both packages (the JAX package's
# fit on the port's hypercube gives the port's shift within FIT_ATOL), and
# the two packages' fitted shifts and corrected CRVAL1/2 agree within
# SHIFT_ATOL (ROADMAP section 3) wherever the fit is stable.  It is not
# everywhere: on these scenes' flat peaks (r ~0.9999 over the 5x5 window)
# a 4e-6..4e-5 difference of the two float32 hypercubes moves it further.
# SHIFT_EXCEPTIONS names each such run with its reading on the CPU and
# holds it to a bound just above that reading.
CORR_ATOL = 1e-4
FIT_ATOL = 1e-9      # arcsec: one fit, one hypercube, two packages
SHIFT_ATOL = 0.01    # arcsec: the two packages' fits, where stable
SHIFT_EXCEPTIONS = {
    # the fit's two states on the (24", 6") pair (test_gaussian_fit_is_
    # bistable_on_align_hri_fsi_pair): 0.376" (0.041", -0.376") on the
    # synthetic branch and 0.004" on the real-file one under this suite's
    # 8-device CPU mesh, the other way round on one JAX device
    ("align_hri_fsi", "synthetic"): 0.4,
    ("align_hri_fsi", "real RICE_1 files"): 0.4,
    ("jitter_movie", 2): 0.09,    # 0.082" in y
    ("jitter_movie", 3): 0.012,   # 0.0108" in x
    ("jitter_movie", 5): 0.012,   # 0.0107" in y
}


def cards(hdr):
    return dict(hdr.items())


def assert_same_results(res_t, res_j, truth, bound, shift_atol=SHIFT_ATOL):
    """Argmax equal and hypercube within CORR_ATOL; the JAX package's
    ``AlignmentResults`` on the port's hypercube fits the port's shift
    within FIT_ATOL; the two packages' shifts within ``shift_atol`` of each
    other and within ``bound`` (arcsec, per axis) of ``truth``."""
    assert res_t.corr.shape == res_j.corr.shape
    assert res_t.max_index == res_j.max_index
    np.testing.assert_allclose(res_t.corr, res_j.corr, atol=CORR_ATOL)
    pa = res_t.parameters_alignment
    refit = JAlignmentResults(res_t.corr, pa["lag_crval1"], pa["lag_crval2"],
                              pa["lag_cdelt1"], pa["lag_cdelt2"],
                              pa["lag_crota"], unit_lag=res_t.unit_lag)
    np.testing.assert_allclose(res_t.shift_arcsec, refit.shift_arcsec,
                               rtol=0, atol=FIT_ATOL)
    np.testing.assert_allclose(res_t.shift_arcsec[:2], res_j.shift_arcsec[:2],
                               rtol=0, atol=shift_atol)
    for res in (res_t, res_j):
        assert np.all(np.abs(np.subtract(res.shift_arcsec[:2], truth))
                      < bound), res.shift_arcsec


def assert_corrected(path_in, path_t, path_j, window, res_t, res_j,
                     shift_atol=SHIFT_ATOL):
    """``path_t``'s and ``path_j``'s CRVAL1/2 are ``path_in``'s plus each
    package's fitted shift (1e-9 arcsec), so within ``shift_atol`` of each
    other."""
    for path, res in ((path_t, res_t), (path_j, res_j)):
        np.testing.assert_allclose(
            crvals(path, window),
            crvals(path_in, window) + np.asarray(res.shift_arcsec[:2]),
            rtol=0, atol=1e-9)
    np.testing.assert_allclose(crvals(path_t, window), crvals(path_j, window),
                               rtol=0, atol=shift_atol)


def crvals(path, window):
    hdr = fits.open(path)[window].header
    return np.array([hdr["CRVAL1"], hdr["CRVAL2"]])


# ---------------------------------------------------------------------------
# the generators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    dict(),
    dict(naxis=(196, 196), cdelt_arcsec=(12.0, 12.0)),
    dict(naxis=(96, 80), cdelt_arcsec=(5.0, 4.0), crval_arcsec=(112.0, 84.0),
         crota_deg=0.75, extra={"DSUN_OBS": 7.48e10, "CRLN_OBS": 120.0}),
])
def test_header_and_scene_match_fixtures(args):
    """make_header: header cards equal; render_helioprojective: within
    1e-12 (both float64 on the same world grid)."""
    hdr_t, hdr_j = synth.make_header(**args), fx.make_header(**args)
    assert cards(hdr_t) == cards(hdr_j)
    for kw in (dict(), dict(seed=3, width_deg=0.01)):
        np.testing.assert_allclose(synth.render_helioprojective(hdr_t, **kw),
                                   fx.render_helioprojective(hdr_j, **kw),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("args", [
    dict(),
    dict(true_shift_arcsec=(24.0, 6.0)),
    dict(true_shift_arcsec=(-3.0, 5.0), true_dcrota_deg=0.2,
         large_naxis=(120, 100), large_cdelt=(10.0, 11.0),
         small_naxis=(64, 48), small_cdelt=(4.0, 4.5), small_crota=-0.5,
         seed=2),
])
def test_helioprojective_pair_matches_fixtures(tmp_path, args):
    """make_helioprojective_pair: arrays within 1e-12, header cards equal;
    write_pair_fits: the two packages' files byte for byte."""
    got = synth.make_helioprojective_pair(**args)
    want = fx.make_helioprojective_pair(**args)
    for a, b in zip(got[::2], want[::2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for a, b in zip(got[1::2], want[1::2]):
        assert cards(a) == cards(b)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    for p_t, p_j in zip(synth.write_pair_fits(tmp_path / "t", *got),
                        fx.write_pair_fits(tmp_path / "j", *want)):
        assert pathlib.Path(p_t).read_bytes() == pathlib.Path(p_j).read_bytes()


@pytest.mark.parametrize("args", [
    dict(),
    dict(crval_arcsec=(112.0, 84.0)),
    dict(nx=32, ny=40, nlam=3, crota_deg=1.5, dt_per_step=60.0),
])
def test_spice_cube_matches_fixtures(args):
    """make_spice_l2_header: cards equal; render_spice_l2_cube: within
    1e-12."""
    hdr_t, hdr_j = synth.make_spice_l2_header(**args), \
        fx.make_spice_l2_header(**args)
    assert cards(hdr_t) == cards(hdr_j)
    got, want = synth.render_spice_l2_cube(hdr_t), \
        fx.render_spice_l2_cube(hdr_j)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# the examples against the JAX package's public API
# ---------------------------------------------------------------------------

def test_demo_synthetic_matches_jax(tmp_path):
    """demo_synthetic: the helioprojective leg (13x13 CRVAL) as
    assert_same_results holds it, within the demo's own 1" of (8", -4"),
    and the corrected CRVAL1/2 of both packages' aligned files.  The
    Carrington leg (128^2 grid; the port scores K2's plain version, the
    JAX package its XLA select evaluator, values may differ by ~1e-2 from
    double interpolation): argmax equal and on the truth, shifts within
    1"."""
    out = demo_synthetic_torch.main(["--device", "cpu", str(tmp_path)])
    assert out["ok"]
    paths = out["paths"]
    kw = dict(large_fov_known_pointing=paths["large"],
              small_fov_to_correct=paths["small"],
              lag_crval1=np.arange(2.0, 15.0, 1.0),
              lag_crval2=np.arange(-10.0, 3.0, 1.0),
              lag_cdelt1=None, lag_cdelt2=None, lag_crota=None,
              small_fov_window=0, large_fov_window=0)
    res_j = JAlignment(**kw, display_progress_bar=False)\
        .align_using_helioprojective(method="correlation")
    res_t = out["helioprojective"]
    assert_same_results(res_t, res_j, (8.0, -4.0), 1.0)
    p_j = str(tmp_path / "aligned_jax.fits")
    res_j.write_corrected_fits(window_list_to_apply_shift=[0],
                               path_to_l3_output=p_j)
    assert_corrected(paths["small"], paths["aligned"], p_j, 0, res_t, res_j)

    res_c = JAlignment(**kw).align_using_carrington(
        lonlims=(117.0, 123.0), latlims=(-1.0, 7.0), shape=(128, 128))
    got = out["carrington"]
    assert got.corr.shape == res_c.corr.shape == (13, 13, 1, 1, 1, 1)
    assert got.max_index == res_c.max_index
    assert (kw["lag_crval1"][got.max_index[0]],
            kw["lag_crval2"][got.max_index[1]]) == (8.0, -4.0)
    for res in (got, res_c):
        np.testing.assert_allclose(res.shift_arcsec[:2], (8.0, -4.0),
                                   atol=1.0)


def write_rice_pair(tmp_path):
    """The synthetic (24", 6") pair as real EUI files are distributed: an
    empty primary HDU and a RICE_1-compressed float32 image."""
    dl, hl, ds, hs = synth.make_helioprojective_pair(
        true_shift_arcsec=(24.0, 6.0))
    paths = []
    for name, data, hdr in (("fsi", dl, hl), ("hri", ds, hs)):
        p = str(tmp_path / f"{name}_rice.fits")
        fits.write(p, [fits.PrimaryHDU(), fits.CompImageHDU(
            data=data.astype(np.float32), header=hdr,
            compression_type="RICE_1", quantize_level=16.0)])
        paths.append(p)
    return paths


@pytest.mark.parametrize("branch", ["synthetic", "real RICE_1 files"])
def test_align_hri_fsi_matches_jax(tmp_path, branch):
    """align_hri_fsi: the synthetic branch (window 0) and the real-file
    branch on RICE_1-compressed files (window -1), as assert_same_results
    holds them (to their SHIFT_EXCEPTIONS bound), argmax
    on (24", 6") and shifts within 1" of it; the corrected CRVAL1/2 of both
    packages' aligned files, and the port's aligned file compressed as its
    input."""
    out_dir = tmp_path / "out"
    argv = ["--device", "cpu", str(out_dir)]
    if branch != "synthetic":
        argv[2:2] = write_rice_pair(tmp_path)
    out = align_hri_fsi_torch.main(argv)
    window = out["window"]
    assert window == (0 if branch == "synthetic" else -1)
    paths = out["paths"]
    res_j = JAlignment(
        large_fov_known_pointing=paths["fsi"],
        small_fov_to_correct=paths["hri"],
        lag_crval1=np.arange(15, 35, 1.0), lag_crval2=np.arange(-4, 17, 1.0),
        lag_cdelt1=None, lag_cdelt2=None, lag_crota=None,
        large_fov_window=window, small_fov_window=window,
    ).align_using_helioprojective(method="correlation")
    res_t = out["results"]
    atol = SHIFT_EXCEPTIONS.get(("align_hri_fsi", branch), SHIFT_ATOL)
    assert_same_results(res_t, res_j, (24.0, 6.0), 1.0, atol)
    assert (15 + res_t.max_index[0], -4 + res_t.max_index[1]) == (24, 6)
    p_j = str(tmp_path / "aligned_jax.fits")
    res_j.write_corrected_fits(window_list_to_apply_shift=[window],
                               path_to_l3_output=p_j)
    assert_corrected(paths["hri"], paths["aligned"], p_j, window, res_t,
                     res_j, atol)
    if branch != "synthetic":
        hdu = fits.open(paths["aligned"])[window]
        assert isinstance(hdu, fits.CompImageHDU)
        assert hdu.header["ZCMPTYPE"] == "RICE_1"


BISTABLE_STATES = ((24.015, 6.119), (23.970, 6.493))  # arcsec


def test_gaussian_fit_is_bistable_on_align_hri_fsi_pair(tmp_path):
    """The reason for align_hri_fsi's SHIFT_EXCEPTIONS entries: on
    align_hri_fsi's (24", 6") pair the JAX package's fit has two states.
    The JAX package's float64 hypercube on the port example's files, the
    port's float64 hypercube (within 1e-14 of it) and twelve copies of the
    JAX one with seeded 1e-15 normal noise: the JAX fit gives each of them
    one of BISTABLE_STATES within 0.005", and each state at least once."""
    out = align_hri_fsi_torch.main(["--device", "cpu", str(tmp_path)])
    paths = out["paths"]
    lags = dict(lag_crval1=np.arange(15, 35, 1.0),
                lag_crval2=np.arange(-4, 17, 1.0))
    kw = dict(large_fov_known_pointing=paths["fsi"],
              small_fov_to_correct=paths["hri"], large_fov_window=0,
              small_fov_window=0, compute_dtype="float64", **lags)
    corr_j = JAlignment(**kw).align_using_helioprojective().corr
    corr_t = Alignment(**kw, device="cpu").align_using_helioprojective().corr
    np.testing.assert_allclose(corr_t, corr_j, rtol=0, atol=1e-14)
    rng = np.random.default_rng(0)
    cubes = [corr_j, corr_t] + [corr_j + 1e-15 * rng.standard_normal(
        corr_j.shape) for _ in range(12)]
    seen = set()
    for corr in cubes:
        shift = JAlignmentResults(corr, lags["lag_crval1"],
                                  lags["lag_crval2"], [0.0], [0.0], [0.0],
                                  unit_lag="arcsec").shift_arcsec[:2]
        state = [i for i, s in enumerate(BISTABLE_STATES)
                 if np.all(np.abs(np.subtract(shift, s)) < 0.005)]
        assert len(state) == 1, shift
        seen.add(state[0])
    assert seen == {0, 1}


def test_align_spice_synras_matches_jax(tmp_path):
    """align_spice_synras: the JAX package's SPICEComposedMapBuilder on the
    port example's imager frames and cube (threshold 600 s, frames 120 s
    apart) takes the same frame for every raster column, and its raster is
    within 1e-5 relative of the port's (tests/test_torch_synras.py);
    AlignmentSpice on it as assert_same_results holds it, shifts within
    (2", 1") of the truth (8", -4"): half a raster step along the
    raster."""
    out = align_spice_synras_torch.main(["--device", "cpu", str(tmp_path)])
    paths = out["paths"]
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    builder = JSPICEComposedMapBuilder(
        path_to_spectro=paths["spice"], list_imager_paths=paths["imagers"],
        threshold_time=600.0, window_imager=0, window_spectro=0)
    synras_j = builder.process(folder_path_output=str(jax_dir), level=2,
                               print_filename=False, return_synras_name=True)
    np.testing.assert_array_equal(out["dates_selected"],
                                  builder.dates_selected)
    assert len(set(out["dates_selected"])) == 3   # the raster spans 240 s
    got, want = fits.open(paths["synras"])[0], jfits.open(synras_j)[0]
    np.testing.assert_allclose(got.data, want.data, rtol=1e-5)
    res_j = JAlignmentSpice(
        large_fov_known_pointing=synras_j,
        small_fov_to_correct=paths["spice"],
        lag_crval1=np.arange(0.0, 17.0, 1.0),
        lag_crval2=np.arange(-12.0, 5.0, 1.0),
        large_fov_window=0, small_fov_window=0,
    ).align_using_helioprojective()
    assert_same_results(out["results"], res_j, (8.0, -4.0), (2.0, 1.0))


def test_jitter_movie_matches_jax(tmp_path):
    """jitter_movie: the JAX package's jitter_correction_imagers on the
    port example's six frames.  Each corrected frame as assert_same_results
    holds it (frames 2, 3 and 5 to their SHIFT_EXCEPTIONS bounds), within
    0.5" of its injected jitter (tests/test_torch_movie.py);
    the corrected CRVAL1/2 of both packages' files, the anchor copied
    unchanged."""
    out = jitter_movie_torch.main(["--device", "cpu", str(tmp_path)])
    frames = out["paths"]["frames"]
    jax_dir = tmp_path / "corrected_jax"
    jax_dir.mkdir()
    lags = np.arange(-6.0, 6.5, 0.5)
    res_j = jjitter_correction_imagers(
        list_files_input=frames, path_files_output=str(jax_dir),
        lag_crval1=lags, lag_crval2=lags,
        lag_cdelt1=None, lag_cdelt2=None, lag_crota=None,
        window_files_input=0, alignement_method="helioprojective")
    res_t = out["results"]
    assert sorted(res_t) == sorted(res_j) == [1, 2, 3, 4, 5]
    assert out["jitter"][0] == (0.0, 0.0)
    for k in res_t:
        atol = SHIFT_EXCEPTIONS.get(("jitter_movie", k), SHIFT_ATOL)
        assert_same_results(res_t[k], res_j[k], out["jitter"][k], 0.5, atol)
        name = os.path.basename(frames[k])
        assert_corrected(frames[k],
                         os.path.join(out["paths"]["corrected"], name),
                         jax_dir / name, 0, res_t[k], res_j[k], atol)
    name = os.path.basename(frames[0])
    for out_dir in (out["paths"]["corrected"], jax_dir):
        np.testing.assert_array_equal(
            crvals(os.path.join(out_dir, name), 0), crvals(frames[0], 0))


# ---------------------------------------------------------------------------
# the scripts as a user runs them
# ---------------------------------------------------------------------------

def test_demo_synthetic_script_exits_0_and_prints_ok(tmp_path):
    """``python3 examples/demo_synthetic_torch.py --device cpu DIR`` exits 0
    and prints OK."""
    out = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "demo_synthetic_torch.py"),
         "--device", "cpu", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "OK"
    assert os.path.isfile(tmp_path / "aligned.fits")


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_without_card_raises(tmp_path, name):
    """Without ``--device cpu`` each script asks for the card: on a machine
    without one it raises before it writes anything, instead of running on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card path")
    out_dir = tmp_path / "out"
    with pytest.raises(RuntimeError, match="cuda"):
        SCRIPTS[name].main([str(out_dir)])
    assert not out_dir.exists()
