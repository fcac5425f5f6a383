"""Host parts of the port held to the JAX package's behaviour tests that no
other port test repeats: atomic ``fits.write``
(``tests/test_atomic_write.py``), the progress bar and the stage-timing
scopes (``tests/test_progress.py``), the data selector over canned index
pages (``tests/test_pxlshift_jitter_selector.py``), the solar-surface
reprojection (``tests/test_solar_surface.py``) and the small pieces of
``tests/test_misc_coverage.py``.  Where both packages compute a value from
the same inputs, the port's is held to the JAX package's; tolerances are
stated in each test.
"""
import os

import numpy as np
import pytest

import fixtures as fx
import test_pxlshift_jitter_selector as jsel
import test_solar_surface as jsolar
from euispice_coreg_tpu.core import transforms as jtransforms
from euispice_coreg_tpu.engine import carrington as jcarr
from euispice_coreg_tpu.selector import Selector as JSelector
from euispice_coreg_tpu_torch.core import transforms
from euispice_coreg_tpu_torch.core.header import Header
from euispice_coreg_tpu_torch.engine import carrington as carr
from euispice_coreg_tpu_torch.io import fits
from euispice_coreg_tpu_torch.selector import (Selector, SelectorEui,
                                               SelectorSpice)
from euispice_coreg_tpu_torch.utils import coords, obs, timeutils


def tmp_litter(path):
    return [f for f in os.listdir(path) if f.startswith(".tmp-")]


# ---------------------------------------------------------------------------
# atomic fits.write
# ---------------------------------------------------------------------------

def test_write_leaves_no_temp_files(tmp_path):
    p = str(tmp_path / "a.fits")
    fits.write(p, [fits.PrimaryHDU(data=np.zeros((8, 8), dtype=np.float32))])
    assert os.path.isfile(p) and tmp_litter(tmp_path) == []
    # an overwrite goes through the same rename
    fits.write(p, [fits.PrimaryHDU(data=np.ones((8, 8), dtype=np.float32))])
    assert np.all(fits.open(p)[0].data == 1.0)
    assert tmp_litter(tmp_path) == []


def test_failed_write_preserves_existing_file(tmp_path, monkeypatch):
    """A crash mid-write leaves the previous complete file in place and
    removes its temporary file."""
    p = str(tmp_path / "b.fits")
    fits.write(p, [fits.PrimaryHDU(data=np.full((8, 8), 7.0,
                                                dtype=np.float32))])

    class Boom(RuntimeError):
        pass

    real_open = fits._io.open

    def failing_open(path, mode="r", *a, **k):
        if "w" in mode and ".tmp-" in str(path):
            class _Torn:
                def __enter__(self):
                    with real_open(path, "wb") as f:
                        f.write(b"partial")
                    raise Boom()

                def __exit__(self, *exc):
                    return False

            return _Torn()
        return real_open(path, mode, *a, **k)

    monkeypatch.setattr(fits._io, "open", failing_open)
    with pytest.raises(Boom):
        fits.write(p, [fits.PrimaryHDU(data=np.zeros((8, 8),
                                                     dtype=np.float32))])
    monkeypatch.undo()
    assert np.all(fits.open(p)[0].data == 7.0)
    assert tmp_litter(tmp_path) == []


# ---------------------------------------------------------------------------
# progress bar and stage timing
# ---------------------------------------------------------------------------

def test_progress_bar_only_in_scope_and_callback(capsys):
    with obs.console_progress_bar(True):
        p = obs.Progress(total=4, label="demo")
        for _ in range(4):
            p.step()
    err = capsys.readouterr().err
    assert "|" in err and "demo" in err and "4/4" in err
    p = obs.Progress(total=2, label="quiet")
    p.step()
    p.step()
    assert "|" not in capsys.readouterr().err
    calls = []
    p = obs.Progress(total=3, label="cb", cb=lambda d, t, l: calls.append(d))
    for _ in range(3):
        p.step()
    assert calls == [1, 2, 3]


def test_alignment_displays_progress_bar(tmp_path, capsys):
    """``display_progress_bar=True`` draws the per-lag gather's bar; the
    search still finds the shift (a 5x5 grid around it: the gather's bar
    needs no more lags)."""
    from euispice_coreg_tpu_torch import Alignment

    dl, hl, ds, hs = fx.make_helioprojective_pair(
        true_shift_arcsec=(8.0, -4.0))
    p_large, p_small = fx.write_pair_fits(tmp_path, dl, hl, ds, hs)
    A = Alignment(p_large, p_small, lag_crval1=np.arange(4, 13, 2.0),
                  lag_crval2=np.arange(-8, 1, 2.0), small_fov_window=0,
                  large_fov_window=0, display_progress_bar=True,
                  lag_search_mode="exact", device="cpu")
    corr = A.align_using_helioprojective(return_type="corr")
    err = capsys.readouterr().err
    assert "|#" in err and "lag search" in err
    mi = np.unravel_index(np.nanargmax(corr), corr.shape)
    assert A.lag_crval1[mi[0]] == 8.0


def test_collect_stages_accumulates_and_restores():
    """stage()/timed() add wall-clocks to the active scope, keyed by label
    and summed over repeats; outside a scope they record nothing and
    stages_active() is False."""
    assert not obs.stages_active()
    with obs.collect_stages() as st:
        assert obs.stages_active()
        with obs.stage("a"):
            pass
        with obs.stage("a"):
            pass
        with obs.timed("b"):
            pass
    assert not obs.stages_active()
    assert set(st) == {"a", "b"}
    assert st["a"] >= 0.0 and st["b"] >= 0.0
    with obs.stage("c"):
        pass
    assert "c" not in st


def test_collect_stages_nested_scopes_shadow():
    """Inner scopes capture alone; the outer scope resumes after."""
    with obs.collect_stages() as outer:
        with obs.stage("x"):
            pass
        with obs.collect_stages() as inner:
            assert obs.stages_active()
            with obs.stage("y"):
                pass
        with obs.stage("z"):
            pass
    assert set(inner) == {"y"}
    assert set(outer) == {"x", "z"}


def test_collect_stages_restores_on_exception():
    with pytest.raises(RuntimeError):
        with obs.collect_stages():
            raise RuntimeError("boom")
    assert not obs.stages_active()


# ---------------------------------------------------------------------------
# selector over canned index pages
# ---------------------------------------------------------------------------

class StubSelector(Selector):
    """The port's Selector over canned per-day index pages (no network)."""

    def __init__(self, pages):
        super().__init__(release_url_basis="https://example.org/release/L2")
        self.pages = pages

    def _fetch_index(self, url):
        return self.pages.get(url, "<html></html>")


@pytest.mark.parametrize("t1,t2,name,count", [
    ("2022-03-17T09:00:00", "2022-03-18T12:00:00", None, 4),
    ("2022-03-17T09:00:00", "2022-03-18T12:00:00", "fsi174", 3),
    ("2022-03-17T09:00:00", "2022-03-17T10:00:00", "fsi174", 1)])
def test_selector_interval_matches_jax(t1, t2, name, count):
    """URLs and times over the JAX tests' pages: equal to the JAX
    package's, inside the interval."""
    urls, times = StubSelector(jsel.PAGES).get_url_from_time_interval(
        t1, t2, file_name_str=name)
    want_urls, want_times = jsel.StubSelector(jsel.PAGES) \
        .get_url_from_time_interval(t1, t2, file_name_str=name)
    assert len(urls) == count
    assert list(urls) == list(want_urls)
    np.testing.assert_array_equal(times, want_times)
    assert all(u.startswith("https://example.org/release/L2/2022/03/1")
               for u in urls)
    assert np.all(times >= timeutils.parse_fits_time(t1))


def test_selector_urls_and_time_parsing():
    assert SelectorEui(release=5.0, level=2).release_url_basis == (
        "https://www.sidc.be/EUI/data/releases/202204_release_5.0/L2")
    assert "release-4.0/level2" in SelectorSpice(
        release=4.0, level=2).release_url_basis
    name = "solo_L2_eui-fsi174-image_20220317T095045281_V01.fits"
    t = Selector._find_time_from_file(name)
    assert t == timeutils.parse_fits_time("2022-03-17T09:50:45")
    assert t == JSelector._find_time_from_file(name)


# ---------------------------------------------------------------------------
# solar-surface reprojection
# ---------------------------------------------------------------------------

def reproject_both(data, h1, h2, **kw):
    """The JAX package's and the port's reprojection of ``data``, both in
    float64."""
    want = jcarr.reproject_solar_surface(data, h1, h2, d_solar_r=1.0,
                                         compute_dtype="float64", **kw)
    got = carr.reproject_solar_surface(data, Header(dict(h1.items())),
                                       Header(dict(h2.items())),
                                       d_solar_r=1.0, device="cpu",
                                       compute_dtype="float64", **kw)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, equal_nan=True)
    return got


def test_reproject_identity_same_header():
    """dt = 0 and one WCS: order-1 sampling at integer coordinates gives
    the view back in the interior (rtol 1e-5), within 1e-5 of the JAX
    package."""
    hdr = jsolar.hdr_at(120.0, "2022-03-17T09:50:45")
    view = fx.render_carrington_view(hdr, 1.0)
    out = reproject_both(view, hdr, hdr, order=1)
    c = np.s_[1:-1, 1:-1]
    assert np.isfinite(out[c]).all()
    np.testing.assert_allclose(out[c], view[c], rtol=1e-5)


def test_reproject_tracks_observer_motion_rigid():
    """A scene fixed in the Carrington frame seen 4 days apart from a moved
    observer: ``rigid`` maps view 1 onto view 2 (atol 0.03 in the central
    crop, as the JAX test holds it), within 1e-5 of the JAX package."""
    h1 = jsolar.hdr_at(120.0, "2022-03-17T09:50:45")
    h2 = jsolar.hdr_at(126.0, "2022-03-21T09:50:45", crval=(30.0, -20.0),
                       crota=2.0)
    v1 = fx.render_carrington_view(h1, 1.0)
    v2 = fx.render_carrington_view(h2, 1.0)
    out = reproject_both(v1, h1, h2, order=2, rot_model="rigid")
    c = np.s_[30:98, 30:98]
    assert np.isfinite(out[c]).all()
    np.testing.assert_allclose(out[c], v2[c], atol=0.03)


def test_reproject_howard_differential_drift():
    """Features drifting at the Howard rate are recovered by
    ``rot_model="howard"`` (atol 0.05) and missed by ``"rigid"`` (> 0.3),
    each within 1e-5 of the JAX package."""
    h1 = jsolar.hdr_at(120.0, "2022-03-17T09:50:45")
    h2 = jsolar.hdr_at(124.0, "2022-03-23T09:50:45", crval=(-25.0, 40.0))
    v1 = fx.render_carrington_view(h1, 1.0)
    sc2 = carr.header_spherical_scalars(Header(dict(h2.items())), 1.0)
    px, py = coords.pixel_grid(int(h2["NAXIS1"]), int(h2["NAXIS2"]))
    lon2, lat2 = carr.spherical_unproject(px, py, sc2)
    drift = carr.surface_rotation_drift_deg(lat2, 6.0, "howard")
    v2 = np.where(np.isfinite(lon2),
                  fx.scene_carrington(lon2 - drift, lat2), np.nan)
    c = np.s_[30:98, 30:98]
    out = reproject_both(v1, h1, h2, order=2, rot_model="howard")
    np.testing.assert_allclose(out[c], v2[c], atol=0.05)
    rigid = reproject_both(v1, h1, h2, order=2, rot_model="rigid")
    assert np.nanmax(np.abs(rigid[c] - v2[c])) > 0.3


def test_bad_reprojection_method_raises(tmp_path):
    from euispice_coreg_tpu_torch import Alignment

    dl, hl, ds, hs = fx.make_carrington_pair()
    p_large, p_small = fx.write_pair_fits(tmp_path, dl, hl, ds, hs)
    A = Alignment(p_large, p_small, lag_crval1=[0.0], lag_crval2=[0.0],
                  small_fov_window=0, large_fov_window=0, device="cpu")
    with pytest.raises(ValueError, match="either 'fa' or 'sunpy'"):
        A.align_using_carrington(lonlims=(115.0, 125.0), latlims=(-2.0, 8.0),
                                 shape=(64, 64),
                                 method_carrington_reprojection="nope")


# ---------------------------------------------------------------------------
# small public pieces (tests/test_misc_coverage.py)
# ---------------------------------------------------------------------------

def test_gen_shmm_roundtrip_and_validation():
    """Create from an ndarray, attach by name, share writes; a call with
    neither ``create`` nor a name, or a name without a shape, raises."""
    from euispice_coreg_tpu_torch.utils.util_compat import MpUtils

    src = np.arange(24, dtype=np.float32).reshape(4, 6)
    shmm, view = MpUtils.gen_shmm(create=True, ndarray=src)
    try:
        view[:] = src
        shmm2, view2 = MpUtils.gen_shmm(name=shmm.name, shape=src.shape,
                                        dtype=src.dtype)
        np.testing.assert_array_equal(view2, src)
        view2[0, 0] = -1.0
        assert view[0, 0] == -1.0
        del view2
        shmm2.close()
    finally:
        del view
        shmm.close()
        shmm.unlink()
    with pytest.raises(ValueError):
        MpUtils.gen_shmm()
    with pytest.raises(ValueError):
        MpUtils.gen_shmm(name="x")


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_rotationmatrix_matches_jax(axis):
    """Orthonormal, det 1, inverse at the opposite angle, and equal to the
    JAX package's to 1e-15; axis 0 keeps z; axis 3 raises."""
    R = transforms.rotationmatrix(0.3, axis)
    np.testing.assert_allclose(R, jtransforms.rotationmatrix(0.3, axis),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-12)
    np.testing.assert_allclose(R @ transforms.rotationmatrix(-0.3, axis),
                               np.eye(3), atol=1e-12)
    np.testing.assert_allclose(
        transforms.rotationmatrix(np.pi / 2, 0) @ np.array([0.0, 0.0, 1.0]),
        [0.0, 0.0, 1.0], atol=1e-12)
    with pytest.raises(ValueError):
        transforms.rotationmatrix(0.1, 3)


def test_gridpattern_matches_jax():
    g = transforms.gridpattern(nx=64, ny=48, s=16, t=3)
    np.testing.assert_array_equal(g, jtransforms.gridpattern(nx=64, ny=48,
                                                             s=16, t=3))
    assert g.shape == (64, 48)
    assert set(np.unique(g)) <= {0.0, 1.0}
    assert g[0, :].all() and g[1, :].all() and g[2, :].all()
    assert g[16, :].all() and not g[3, 3:16].any()
    assert g[:, 0].all() and g[:, 16].all()


def test_contour_plot_and_fov_rectangle(tmp_path):
    from euispice_coreg_tpu_torch.plot.plot import (contour_plot,
                                                    plot_fov_rectangle)

    hdr = fx.make_header((64, 64), (8.0, 8.0), (0.0, 0.0), 0.0)
    hdr2 = fx.make_header((64, 64), (8.0, 8.0), (4.0, -4.0), 0.0)
    data, data2 = fx.render_helioprojective(hdr), fx.render_helioprojective(
        hdr2)
    contour_plot(Header(dict(hdr.items())), data, Header(dict(hdr2.items())),
                 data2, path_save=str(tmp_path / "contour.png"),
                 device="cpu")
    assert (tmp_path / "contour.png").stat().st_size > 0
    plot_fov_rectangle(data, slc=(slice(10, 40), slice(20, 50)),
                       path_save=str(tmp_path / "rect.png"))
    assert (tmp_path / "rect.png").stat().st_size > 0
