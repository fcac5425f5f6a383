"""The port's public ``Alignment`` against the JAX package's on the same FITS
files: the 6-D hypercube, the fitted shift and the corrected header."""
import numpy as np
import pytest
import torch

import fixtures as fx
from euispice_coreg_tpu.hdrshift.alignment import Alignment as JAlignment
from euispice_coreg_tpu.io import fits as jfits
from euispice_coreg_tpu_torch import Alignment
from euispice_coreg_tpu_torch.engine import lag_search
from euispice_coreg_tpu_torch.io import fits
from euispice_coreg_tpu_torch.utils.torchcfg import from_jax_state

LAG1 = np.array([4.0, 6.0, 8.0, 10.0])
LAG2 = np.array([-6.0, -4.0, -2.0, 0.0])
HEADER_KEYS = ("CRVAL1", "CRVAL2", "CDELT1", "CDELT2", "PC1_1", "PC1_2",
               "PC2_1", "PC2_2", "CROTA")


def write_pair(tmp_path, pair):
    """``fixture``: the 96^2 / 196^2 pair of tests/fixtures.py;
    ``same``: a 128^2 pair on one grid (the JAX package's select-submap
    case)."""
    if pair == "fixture":
        dl, hl, ds, hs = fx.make_helioprojective_pair(
            true_shift_arcsec=(8.0, -4.0))
    else:
        hs = fx.make_header((128, 128), (4.0, 4.0), (112.0, 84.0), 0.75)
        hl = hs.copy()
        dl = fx.render_helioprojective(hl)
        ht = fx.make_header((128, 128), (4.0, 4.0), (120.0, 80.0), 0.75)
        ds = fx.render_helioprojective(ht)
    return fx.write_pair_fits(tmp_path, dl, hl, ds, hs)


def run_both(tmp_path, p_large, p_small, mode, dtype, entry="helio",
             **lags):
    lags = lags or dict(lag_crval1=LAG1, lag_crval2=LAG2)
    kw = dict(large_fov_known_pointing=p_large, small_fov_to_correct=p_small,
              small_fov_window=0, large_fov_window=0, lag_search_mode=mode,
              **lags)
    if dtype is not None:
        kw["compute_dtype"] = dtype
    ja = JAlignment(**kw, use_device_mesh=False)
    ta = Alignment(**kw, device="cpu")
    if entry == "helio":
        res_j, res_t = (a.align_using_helioprojective() for a in (ja, ta))
    else:
        res_j, res_t = (a.align_using_initial_carrington() for a in (ja, ta))
    out_j = str(tmp_path / "corrected_jax.fits")
    out_t = str(tmp_path / "corrected_torch.fits")
    res_j.write_corrected_fits([0], out_j)
    res_t.write_corrected_fits([0], out_t)
    return (res_j, res_t, jfits.open(out_j)[0].header,
            fits.open(out_t)[0].header)


@pytest.mark.parametrize("mode,dtype,atol,shift_atol", [
    ("auto", "float64", 1e-6, 1e-4),  # FFT path, both float64
    ("pallas", None, 2e-4, 5e-3),     # K1: JAX's kernel works in float32
    ("auto", None, 1e-4, 2e-2),       # defaults: float32 operands
])
@pytest.mark.parametrize("pair", ["fixture", "same"])
def test_alignment_matches_jax(tmp_path, pair, mode, dtype, atol,
                               shift_atol):
    """Hypercube within ``atol``, argmax equal; fitted shift and corrected
    header within ``shift_atol`` arcsec (the 5x5 Gaussian fit amplifies
    value differences: float64 hypercubes equal to 1e-15 give fits 1e-5"
    apart)."""
    p_large, p_small = write_pair(tmp_path, pair)
    res_j, res_t, hdr_j, hdr_t = run_both(tmp_path, p_large, p_small, mode,
                                          dtype)
    assert res_t.corr.shape == res_j.corr.shape == (4, 4, 1, 1, 1, 1)
    np.testing.assert_allclose(res_t.corr, res_j.corr, atol=atol)
    assert res_t.max_index == res_j.max_index
    assert LAG1[res_t.max_index[0]] == 8.0
    np.testing.assert_allclose(res_t.shift_arcsec, res_j.shift_arcsec,
                               atol=shift_atol)
    for k in HEADER_KEYS:
        assert hdr_t[k] == pytest.approx(hdr_j[k], abs=shift_atol), k


def test_exact_mixed_grid_matches_jax(tmp_path):
    """Mixed crval x crota grid on the exact engine (per-lag gather on the
    CPU), float64: atol 1e-6."""
    p_large, p_small = write_pair(tmp_path, "fixture")
    res_j, res_t, hdr_j, hdr_t = run_both(
        tmp_path, p_large, p_small, "exact", "float64",
        lag_crval1=[6.0, 8.0, 10.0], lag_crval2=[-4.0, -2.0],
        lag_crota=[-0.5, 0.0])
    np.testing.assert_allclose(res_t.corr, res_j.corr, atol=1e-6)
    assert res_t.max_index == res_j.max_index
    for k in HEADER_KEYS:
        assert hdr_t[k] == pytest.approx(hdr_j[k], abs=1e-4), k


def test_initial_carrington_matches_jax(tmp_path):
    """CAR-frame pair through ``align_using_initial_carrington``, float64:
    atol 1e-6."""
    from euispice_coreg_tpu.utils import coords

    car = ("CRLN-CAR", "CRLT-CAR")
    hdr_large = fx.make_header((160, 160), (30.0, 30.0), (120.0 * 3600, 0.0),
                               0.0, ctype=car)
    lon, lat = coords.header_world_grid(hdr_large, wrap=False)
    data_large = fx.scene_carrington(lon, lat)
    hdr_true = fx.make_header((64, 64), (15.0, 15.0),
                              (120.3 * 3600, 0.1 * 3600), 0.0, ctype=car)
    lon_s, lat_s = coords.header_world_grid(hdr_true, wrap=False)
    data_small = fx.scene_carrington(lon_s, lat_s)
    hdr_small = fx.make_header((64, 64), (15.0, 15.0),
                               (120.3 * 3600 - 40.0, 0.1 * 3600 + 20.0), 0.0,
                               ctype=car)
    p_large, p_small = fx.write_pair_fits(tmp_path, data_large, hdr_large,
                                          data_small, hdr_small)
    res_j, res_t, hdr_j, hdr_t = run_both(
        tmp_path, p_large, p_small, "auto", "float64", entry="car",
        lag_crval1=[20.0, 30.0, 40.0, 50.0],
        lag_crval2=[-30.0, -20.0, -10.0, 0.0])
    np.testing.assert_allclose(res_t.corr, res_j.corr, atol=1e-6)
    assert res_t.max_index == res_j.max_index
    assert res_t.shift_arcsec[0] == pytest.approx(40.0, abs=5.0)


def test_block_fleet_path_is_not_ported(tmp_path):
    """Mixed grids above 2000 candidates would take the JAX block fleet
    path; the port raises instead of silently running another engine."""
    p_large, p_small = write_pair(tmp_path, "fixture")
    A = Alignment(p_large, p_small, lag_crval1=np.arange(21.0),
                  lag_crval2=np.arange(21.0), lag_crota=np.linspace(-1, 1, 5),
                  small_fov_window=0, large_fov_window=0, device="cpu")
    with pytest.raises(NotImplementedError, match="block fleet"):
        A.align_using_helioprojective(return_type="corr")


def test_from_jax_state_round_trip():
    """JAX operands -> port operands -> numpy: exact."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    small, ref, lon, lat = (rng.normal(size=(5, 7)) for _ in range(4))
    small[1, 2] = np.nan
    base = {"crval1": jnp.float64(0.01), "crval2": np.float64(-0.02),
            "crpix1": 3.0, "crpix2": jnp.asarray(4.0),
            "cdelt1": 1e-4, "cdelt2": 2e-4, "pc11": 1.0, "pc12": 0.0,
            "pc21": 0.0, "pc22": 1.0, "crota": 0.5}
    b, s, r, lo, la = from_jax_state(
        base, jnp.asarray(small), ref, jnp.asarray(lon), lat, device="cpu",
        dtype="float64")
    assert all(type(v) is float for v in b.values())
    assert b == {k: float(np.asarray(v)) for k, v in base.items()}
    for t, a in ((s, small), (r, ref), (lo, lon), (la, lat)):
        assert t.dtype == torch.float64 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), a)
    _, s32, *_ = from_jax_state(base, small, ref, lon, lat, device="cpu",
                                dtype=np.float32)
    np.testing.assert_array_equal(s32.numpy(), small.astype(np.float32))


def test_probe_values_read_tensors_and_arrays():
    rng = np.random.default_rng(1)
    lon, lat = rng.normal(size=(2, 9, 11))
    a = lag_search.probe_values(lon, lat)
    b = lag_search.probe_values(torch.as_tensor(lon), torch.as_tensor(lat))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
