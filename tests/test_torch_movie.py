"""The port's pixel-shift search, c_correlate, movie alignment and jitter
correction against the JAX package's, on the same FITS files on the CPU."""
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures as fx
from euispice_coreg_tpu.core import score as jscore
from euispice_coreg_tpu.engine import fast_corr as jfast
from euispice_coreg_tpu.engine import lag_search as jlag
from euispice_coreg_tpu.hdrshift.alignment import Alignment as JAlignment
from euispice_coreg_tpu.jitter_correction import jitter_correction as jjit
from euispice_coreg_tpu.pxlshift import AlignmentPixels as JAlignmentPixels
from euispice_coreg_tpu.utils import timeutils
from euispice_coreg_tpu_torch import Alignment as TAlignment
from euispice_coreg_tpu_torch.core import score
from euispice_coreg_tpu_torch.engine import fast_corr
from euispice_coreg_tpu_torch.io import fits
from euispice_coreg_tpu_torch.jitter_correction import (
    align_movie_to_reference, jitter_correction_imagers)
from euispice_coreg_tpu_torch.jitter_correction import \
    jitter_correction as tjit
from euispice_coreg_tpu_torch.pxlshift import AlignmentPixels


def jax_in_float64(monkeypatch):
    """The JAX pixel-shift search resamples and scores in float32; the
    port's in float64.  These tests run the JAX side in float64 too."""
    monkeypatch.setattr(jfast, "pearson_integer_shifts", functools.partial(
        jfast.pearson_integer_shifts, compute_dtype=jnp.float64))
    monkeypatch.setattr(jlag, "resample_to_grid", functools.partial(
        jlag.resample_to_grid, compute_dtype=jnp.float64))


def test_pearson_integer_shifts_matches_jax():
    """r over a (dx, dy) grid with NaN holes: atol 1e-9 against the JAX
    function and against a direct sliding-window Pearson."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:80, 0:72]
    moving = np.sin(xx / 5.0) * np.cos(yy / 7.0) + 0.3 * rng.normal(size=xx.shape)
    fixed = np.full(moving.shape, np.nan)
    fixed[20:60, 15:55] = moving[22:62, 12:52] + 0.05 * rng.normal(size=(40, 40))
    fixed[30:34, 20:30] = np.nan
    dxs, dys = np.arange(-5, 6), np.arange(-4, 5)
    got = fast_corr.pearson_integer_shifts(fixed, moving, dxs, dys,
                                           device="cpu")
    want = jfast.pearson_integer_shifts(fixed, moving, dxs, dys,
                                        compute_dtype=jnp.float64)
    assert got.shape == want.shape == (11, 9)
    np.testing.assert_allclose(got, want, atol=1e-9)
    assert np.unravel_index(np.nanargmax(got), got.shape) == (2, 6)  # (-3, 2)
    for i, j in ((2, 6), (0, 0), (10, 4)):
        b = np.roll(moving, (-dys[j], -dxs[i]), axis=(0, 1))
        m = np.isfinite(fixed) & np.isfinite(b)
        ca, cb = fixed[m] - fixed[m].mean(), b[m] - b[m].mean()
        direct = np.sum(ca * cb) / np.sqrt(np.sum(ca ** 2) * np.sum(cb ** 2))
        assert got[i, j] == pytest.approx(direct, abs=1e-9)


def test_c_correlate_matches_jax():
    """c_correlate (1-D) and c_correlate3d (batched, alias c_correlate3D,
    re-exported by hdrshift/pxlshift/utils) against the JAX functions: atol
    1e-9; tensors in, tensors out."""
    from euispice_coreg_tpu_torch.hdrshift import c_correlate as h
    from euispice_coreg_tpu_torch.pxlshift import c_correlate as p
    from euispice_coreg_tpu_torch.utils import c_correlate as u

    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(2, 3, 4, 25))
    lags = [-4, -1, 0, 2, 7]
    got = score.c_correlate(torch.as_tensor(a[0, 0]), torch.as_tensor(b[0, 0]),
                            lags)
    assert isinstance(got, torch.Tensor) and got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), jscore.c_correlate(
        a[0, 0], b[0, 0], lags), atol=1e-9)
    got3 = score.c_correlate3d(torch.as_tensor(a), torch.as_tensor(b), lags)
    assert got3.shape == (3, 4, 5)
    np.testing.assert_allclose(got3.numpy(), jscore.c_correlate3d(a, b, lags),
                               atol=1e-9)
    for mod in (h, p, u):
        assert mod.c_correlate is score.c_correlate
        assert mod.c_correlate3d is mod.c_correlate3D is score.c_correlate3d
    with pytest.raises(ValueError, match="1-D"):
        score.c_correlate(a, b, lags)


def make_pxl_pair(tmp_path, dx_px=3, dy_px=-2, small_cdelt=10.0):
    """A 160^2 large frame and a 64^2 crop offset by (dx, dy) px (tests/
    test_pxlshift_jitter_selector.py); with ``small_cdelt`` 20" the crop is
    rendered at half the large frame's resolution, and the headers carry
    what the solar-rotation drift reads."""
    hdr_large = fx.make_header((160, 160), (10.0, 10.0), (0.0, 0.0), 0.0)
    data_large = fx.render_helioprojective(hdr_large)
    h = w = 64
    if small_cdelt == 10.0:
        l0, l1 = int((160 - h - 1) / 2), int((160 - w - 1) / 2)
        small = data_large[l0 + dy_px: l0 + dy_px + h,
                           l1 + dx_px: l1 + dx_px + w]
    else:
        crval = (dx_px * 10.0, dy_px * 10.0)
        small = fx.render_helioprojective(
            fx.make_header((w, h), (small_cdelt,) * 2, crval, 0.0))
    hdr_small = fx.make_header((w, h), (small_cdelt,) * 2, (0.0, 0.0), 0.0)
    for hdr, date in ((hdr_large, "2022-03-17T09:00:00"),
                      (hdr_small, "2022-03-17T09:40:00")):
        hdr.update({"WAVELNTH": 174, "SOLAR_B0": 3.0, "RSUN_REF": 6.957e8,
                    "DSUN_OBS": 0.5 * 1.496e11, "DATE-AVG": date,
                    "CROTA": 0.5})
    p_large = str(tmp_path / "pxl_large.fits")
    p_small = str(tmp_path / "pxl_small.fits")
    fits.write(p_large, [fits.PrimaryHDU(data=data_large, header=hdr_large)])
    fits.write(p_small, [fits.PrimaryHDU(data=small, header=hdr_small)])
    return p_large, p_small


@pytest.mark.parametrize("case", ["shift", "rotation", "resolution"])
def test_alignment_pixels_matches_jax(tmp_path, monkeypatch, case):
    """``find_best_parameters`` hypercube against JAX ``AlignmentPixels``
    (both float64): atol 1e-9, argmax equal.  ``rotation``: three drot;
    ``resolution``: a half-resolution small image and the solar-rotation
    pre-shift of the large frame."""
    jax_in_float64(monkeypatch)
    small_cdelt = 20.0 if case == "resolution" else 10.0
    p_large, p_small = make_pxl_pair(tmp_path, small_cdelt=small_cdelt)
    lag_dx, lag_dy = np.arange(-6, 7), np.arange(-5, 6)
    drot = [-2.0, 0.0, 2.0] if case == "rotation" else [0.0]
    kw = dict(lag_drot=drot,
              shift_solar_rotation_dx_large=case == "resolution")
    want = JAlignmentPixels(p_large, 0, p_small, 0).find_best_parameters(
        lag_dx, lag_dy, **kw)
    A = AlignmentPixels(p_large, 0, p_small, 0, device="cpu")
    got = A.find_best_parameters(lag_dx, lag_dy, **kw)
    assert got.shape == want.shape == (13, 11, len(drot))
    np.testing.assert_allclose(got, want, atol=1e-9)
    mi = np.unravel_index(np.nanargmax(got), got.shape)
    assert mi == np.unravel_index(np.nanargmax(want), want.shape)
    if case != "resolution":
        assert (lag_dx[mi[0]], lag_dy[mi[1]], drot[mi[2]]) == (3, -2, 0.0)
        assert got[mi] == pytest.approx(1.0, abs=1e-9)


def test_alignment_pixels_out_of_bounds_raises(tmp_path):
    p_large, p_small = make_pxl_pair(tmp_path)
    A = AlignmentPixels(p_large, 0, p_small, 0, device="cpu")
    with pytest.raises(ValueError, match="outside FSI"):
        A.find_best_parameters(np.array([1000]), np.array([0]), [0.0])


OFFSETS = [(0.0, 0.0), (3.1, -1.7), (-2.4, 3.3), (1.2, 2.6)]


def write_movie(tmp_path):
    """Four 96^2 frames of one scene at 8"/px (18" blobs: a 1" lag step
    gives the 5x5 Gaussian fit a well-conditioned peak), headers mispointed
    by ``OFFSETS`` (frame 0 exact), DATE-AVG a minute apart; and a reference
    with correct pointing."""
    t0 = timeutils.parse_fits_time("2022-03-17T09:00:00")
    hdr_true = fx.make_header((96, 96), (8.0, 8.0), (40.0, -30.0), 0.3)
    data = fx.render_helioprojective(hdr_true, width_deg=0.005).astype(
        np.float32)
    p_ref = str(tmp_path / "reference.fits")
    fits.write(p_ref, [fits.PrimaryHDU(data=data, header=hdr_true)])
    paths = []
    for k, (ox, oy) in enumerate(OFFSETS):
        hdr = hdr_true.copy()
        hdr["CRVAL1"] = hdr_true["CRVAL1"] - ox
        hdr["CRVAL2"] = hdr_true["CRVAL2"] - oy
        hdr["DATE-AVG"] = timeutils.format_fits_time(t0 + 60 * k)
        p = str(tmp_path / f"frame_{k}.fits")
        fits.write(p, [fits.PrimaryHDU(data=data, header=hdr)])
        paths.append(p)
    return p_ref, paths, hdr_true


def read_crvals(paths):
    return np.array([[fits.open(p)[0].header[k] for k in ("CRVAL1", "CRVAL2")]
                     for p in paths])


LAGS = np.arange(-5.0, 5.5, 1.0)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-4), ("float32", 2e-2)])
def test_align_movie_to_reference_matches_jax(tmp_path, dtype, tol):
    """The three mispointed frames against the reference, 11x11 lags at 1":
    the fitted shifts and the corrected CRVALs written by both packages
    within ``tol`` arcsec (the tolerances of tests/test_torch_alignment.py),
    each frame recovered within 0.5"."""
    p_ref, paths, _ = write_movie(tmp_path)
    paths = paths[1:]
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    os.makedirs(out_j)
    os.makedirs(out_t)
    kw = dict(lag_crval1=LAGS, lag_crval2=LAGS, window_files_input=0,
              reference_window=0, compute_dtype=dtype)
    res_j = jjit.align_movie_to_reference(paths, p_ref, str(out_j),
                                          use_device_mesh=False, **kw)
    res_t = align_movie_to_reference(paths, p_ref, str(out_t), device="cpu",
                                     **kw)
    assert sorted(res_t) == sorted(res_j) == [0, 1, 2]
    for k, (ox, oy) in enumerate(OFFSETS[1:]):
        np.testing.assert_allclose(res_t[k].shift_arcsec, res_j[k].shift_arcsec,
                                   atol=tol)
        np.testing.assert_allclose(res_t[k].shift_arcsec[:2], (ox, oy),
                                   atol=0.5)
    names = [os.path.basename(p) for p in paths]
    np.testing.assert_allclose(read_crvals([out_t / n for n in names]),
                               read_crvals([out_j / n for n in names]),
                               atol=tol)


def run_jitter(monkeypatch, paths, out_j, out_t, dtype, **kw):
    monkeypatch.setattr(jjit, "Alignment", functools.partial(
        JAlignment, use_device_mesh=False, compute_dtype=dtype))
    monkeypatch.setattr(tjit, "Alignment", functools.partial(
        TAlignment, compute_dtype=dtype))
    kw = dict(lag_crval1=LAGS, lag_crval2=LAGS, lag_cdelt1=None,
              lag_cdelt2=None, lag_crota=None, sublist_length=2, overlap=1,
              window_files_input=0, alignement_method="helioprojective",
              **kw)
    res_j = jjit.jitter_correction_imagers(paths, str(out_j), **kw)
    res_t = jitter_correction_imagers(paths, str(out_t), device="cpu", **kw)
    return res_j, res_t


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-4), ("float32", 2e-2)])
def test_jitter_correction_matches_jax(tmp_path, monkeypatch, dtype, tol):
    """Helioprojective jitter correction, 4 frames, sublists of 2 with
    overlap 1 (frame 2 is the second sublist's corrected reference): the
    corrected CRVALs within ``tol`` arcsec of the JAX package's, the anchor
    copied verbatim, every frame recovered within 0.5" of the anchor's
    pointing."""
    _, paths, hdr_true = write_movie(tmp_path)
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    os.makedirs(out_j)
    os.makedirs(out_t)
    res_j, res_t = run_jitter(monkeypatch, paths, out_j, out_t, dtype)
    assert sorted(res_t) == sorted(res_j) == [1, 2, 3]
    names = [os.path.basename(p) for p in paths]
    got = read_crvals([out_t / n for n in names])
    np.testing.assert_allclose(got, read_crvals([out_j / n for n in names]),
                               atol=tol)
    np.testing.assert_array_equal(got[0], read_crvals(paths)[0])
    np.testing.assert_allclose(
        got, np.tile([hdr_true["CRVAL1"], hdr_true["CRVAL2"]], (4, 1)),
        atol=0.5)


def test_jitter_correction_resume_matches_jax(tmp_path, monkeypatch):
    """``resume=True`` after one frame's output was removed: both packages
    re-align only that frame, to the same CRVALs (float64, 1e-4")."""
    _, paths, _ = write_movie(tmp_path)
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    os.makedirs(out_j)
    os.makedirs(out_t)
    run_jitter(monkeypatch, paths, out_j, out_t, "float64")
    first = read_crvals([out_t / os.path.basename(p) for p in paths])
    for out in (out_j, out_t):
        os.remove(out / "frame_3.fits")
    res_j, res_t = run_jitter(monkeypatch, paths, out_j, out_t, "float64",
                              resume=True)
    assert sorted(res_t) == sorted(res_j) == [3]
    names = [os.path.basename(p) for p in paths]
    got = read_crvals([out_t / n for n in names])
    np.testing.assert_allclose(got, read_crvals([out_j / n for n in names]),
                               atol=1e-4)
    np.testing.assert_array_equal(got, first)


def test_figures_and_mesh_raise_before_any_output(tmp_path):
    """Absent inputs raise ``FileNotFoundError`` before any file is written:
    with ``path_figures``, and with a mesh of two devices (the fleet), with
    or without ``path_figures``, in either movie entry point."""
    out = tmp_path / "out"
    os.makedirs(out)
    missing = [str(tmp_path / "absent_0.fits"), str(tmp_path / "absent_1.fits")]
    with pytest.raises(FileNotFoundError):
        jitter_correction_imagers(missing, str(out),
                                  path_figures=str(tmp_path), device="cpu")
    two = ["cpu", "cpu"]
    with pytest.raises(FileNotFoundError):
        jitter_correction_imagers(missing, str(out), mesh=two, device="cpu",
                                  alignement_method="helioprojective")
    with pytest.raises(FileNotFoundError):
        jitter_correction_imagers(missing, str(out), mesh=two,
                                  path_figures=str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        align_movie_to_reference(missing, missing[0], str(out), mesh=two,
                                 device="cpu")
    with pytest.raises(FileNotFoundError):
        tjit._align_hrieuv_with_hrieuv(
            missing[0], 0, missing[1], {}, "09_00_00",
            path_output_figures=str(tmp_path), device="cpu")
    assert os.listdir(out) == []
