"""``Alignment``'s input options and the header helpers, the port against
the JAX package on the same inputs: ``reprojection_order`` 0-2, the
small-FOV thresholds, ``remove_fov_limits``, ``fov_limits`` (mode against
the same mode: ``"auto"`` and ``"exact"`` differ by up to 8.3e-4 on that
crop in both packages), the rejected order, the unmatched window that
writes no file (the JAX cases of tests/test_engine.py), and
``ensure_pcij``, ``correct_pointing_header`` and CD matrices (the JAX
cases of tests/test_wcs.py) against ``euispice_coreg_tpu_torch.core.
header``."""
import warnings

import numpy as np
import pytest

import fixtures as fx
from euispice_coreg_tpu.core import header as jheader
from euispice_coreg_tpu.hdrshift.alignment import Alignment as JAlignment
from euispice_coreg_tpu_torch import Alignment
from euispice_coreg_tpu_torch.core import header as theader

LAG1 = np.arange(-2, 19, 2.0)
LAG2 = np.arange(-14, 7, 2.0)
ATOL = 1e-5   # float32 defaults: the FFT path against the FFT path


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The 96^2 / 196^2 fixture pair, small header mispointed by
    (-8", +4")."""
    dl, hl, ds, hs = fx.make_helioprojective_pair(true_shift_arcsec=(8.0,
                                                                     -4.0))
    return fx.write_pair_fits(tmp_path_factory.mktemp("pair"), dl, hl, ds,
                              hs)


def both(pair, **kw):
    args = dict(large_fov_known_pointing=pair[0],
                small_fov_to_correct=pair[1], lag_crval1=LAG1,
                lag_crval2=LAG2, lag_cdelt1=None, lag_cdelt2=None,
                lag_crota=None, small_fov_window=0, large_fov_window=0)
    args.update(kw)
    return (JAlignment(**args, use_device_mesh=False),
            Alignment(**args, device="cpu"))


def helio_both(pair, ctor=None, **call):
    ja, ta = both(pair, **(ctor or {}))
    cj = ja.align_using_helioprojective(return_type="corr", **call)
    ct = ta.align_using_helioprojective(return_type="corr", **call)
    return cj, ct


def assert_same(cj, ct, atol=ATOL):
    assert ct.shape == cj.shape == (11, 11, 1, 1, 1, 1)
    np.testing.assert_array_equal(np.isnan(ct), np.isnan(cj))
    np.testing.assert_allclose(ct, cj, atol=atol)
    assert np.nanargmax(ct) == np.nanargmax(cj)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_reprojection_order_matches_jax(pair, order):
    """Orders 0 and 2 take the FFT path, 1 the per-lag engine, in both
    packages; argmax on (+8", -4") at orders 1 and 2 (nearest-neighbour
    sampling puts it on (+8", -6") in both)."""
    cj, ct = helio_both(pair, dict(reprojection_order=order))
    assert_same(cj, ct)
    mi = np.unravel_index(np.nanargmax(ct), ct.shape)
    assert (LAG1[mi[0]], LAG2[mi[1]]) == ((8.0, -6.0) if order == 0
                                          else (8.0, -4.0))


def test_small_fov_thresholds_match_jax(pair):
    """``small_fov_value_min``/``_max`` set the small image's outliers to
    NaN in both; a minimum above every value raises in both."""
    data = fx.make_helioprojective_pair()[2]
    lo, hi = np.percentile(data, [5, 95])
    cj, ct = helio_both(pair, dict(small_fov_value_min=lo,
                                   small_fov_value_max=hi))
    assert_same(cj, ct)
    for A in both(pair, small_fov_value_min=1e9):
        with pytest.raises(ValueError, match="all small FOV to nan"):
            A.align_using_helioprojective(return_type="corr")


def test_remove_fov_limits_matches_jax(pair):
    """The centre box removed from the small image: the same hypercube,
    argmax still on +8"."""
    cj, ct = helio_both(pair, remove_fov_limits=[[100.0, 140.0],
                                                 [60.0, 100.0]])
    assert_same(cj, ct)
    assert LAG1[np.unravel_index(np.nanargmax(ct), ct.shape)[0]] == 8.0


@pytest.mark.parametrize("mode", ["auto", "exact"])
def test_fov_limits_matches_jax_mode_for_mode(pair, mode):
    """The 50x50 crop, each mode against the same mode of the JAX
    package."""
    cj, ct = helio_both(pair, dict(lag_search_mode=mode),
                        fov_limits=[[-20.0, 260.0], [-100.0, 250.0]])
    assert_same(cj, ct)
    mi = np.unravel_index(np.nanargmax(ct), ct.shape)
    assert (LAG1[mi[0]], LAG2[mi[1]]) == (8.0, -4.0)


def test_invalid_reprojection_order_rejected_by_both():
    for cls, kw in ((JAlignment, {}), (Alignment, {"device": "cpu"})):
        with pytest.raises(ValueError, match="reprojection_order"):
            cls(large_fov_known_pointing="x.fits",
                small_fov_to_correct="y.fits", lag_crval1=[0.0],
                lag_crval2=[0.0], lag_cdelt1=None, lag_cdelt2=None,
                lag_crota=None, reprojection_order=5, **kw)


def test_unmatched_window_publishes_nothing_in_both(pair, tmp_path):
    """A window list matching no HDU raises before any file is written."""
    for A, name in zip(both(pair), ("jax", "torch")):
        res = A.align_using_helioprojective()
        out = tmp_path / f"corrected_{name}.fits"
        with pytest.raises(ValueError, match="has not corrected"):
            res.write_corrected_fits(
                window_list_to_apply_shift=["NO_SUCH_WINDOW"],
                path_to_l3_output=str(out))
        assert not out.exists()


# ---------------------------------------------------------------------------
# header helpers (tests/test_wcs.py:127-260)
# ---------------------------------------------------------------------------

def wcs_header(mod, crota=0.75, with_pc=True, cunit="arcsec"):
    hdr = mod.Header({
        "NAXIS1": 2048, "NAXIS2": 2048,
        "CRVAL1": 100.0, "CRVAL2": 200.0,
        "CRPIX1": 1024.5, "CRPIX2": 1024.5,
        "CDELT1": 0.492, "CDELT2": 0.492,
        "CUNIT1": cunit, "CUNIT2": cunit,
        "CTYPE1": "HPLN-TAN", "CTYPE2": "HPLT-TAN",
        "CROTA": crota,
    })
    if with_pc:
        pc = mod.pc_from_crota(crota, 0.492, 0.492)
        hdr["PC1_1"], hdr["PC1_2"], hdr["PC2_1"], hdr["PC2_2"] = pc
    return hdr


def run_case(mod, case):
    """One test_wcs.py case on ``mod``'s header module: the header's
    cards, or the exception's type and message, and the warnings."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        try:
            hdr = case(mod)
        except Exception as exc:  # noqa: BLE001
            return ("raised", type(exc).__name__, str(exc)), \
                [str(r.message) for r in rec]
    return dict(hdr), [str(r.message) for r in rec]


def _cd(mod, cd):
    base = {"NAXIS1": 8, "NAXIS2": 8, "CRVAL1": 0.0, "CRVAL2": 0.0,
            "CRPIX1": 4.0, "CRPIX2": 4.0, "CUNIT1": "arcsec",
            "CUNIT2": "arcsec"}
    hdr = mod.Header({**base, **cd})
    mod.ensure_pcij(hdr)
    return hdr


def _rotated_cd(mod):
    pc = mod.pc_from_crota(12.5, 3.0, 2.0)
    hdr = mod.Header({
        "NAXIS1": 32, "NAXIS2": 32, "CRVAL1": 100.0, "CRVAL2": 50.0,
        "CRPIX1": 16.5, "CRPIX2": 16.5, "CUNIT1": "arcsec",
        "CUNIT2": "arcsec", "CTYPE1": "HPLN-TAN", "CTYPE2": "HPLT-TAN",
        "CD1_1": 3.0 * pc[0], "CD1_2": 3.0 * pc[1], "CD2_1": 2.0 * pc[2],
        "CD2_2": 2.0 * pc[3]})
    mod.ensure_pcij(hdr)
    return hdr


def _no_rotation(mod, force):
    hdr = wcs_header(mod, with_pc=False)
    del hdr["CROTA"]
    mod.ensure_pcij(hdr, force_crota_0=force)
    return hdr


def _correct(mod, crota, **lags):
    hdr = wcs_header(mod, crota=crota, cunit=lags.pop("cunit", "arcsec"))
    if "cdelt" in lags:
        hdr["CDELT1"] = hdr["CDELT2"] = lags.pop("cdelt")
    kw = dict(lag_crval1=None, lag_crval2=None, lag_cdelt1=None,
              lag_cdelt2=None, lag_crota=None)
    kw.update(lags)
    mod.correct_pointing_header(hdr, **kw)
    return hdr


HEADER_CASES = {
    "ensure_pcij creates the matrix":
        lambda m: (lambda h: (m.ensure_pcij(h), h)[1])(
            wcs_header(m, with_pc=False)),
    "ensure_pcij without rotation raises":
        lambda m: _no_rotation(m, False),
    "ensure_pcij force_crota_0": lambda m: _no_rotation(m, True),
    "correct_pointing_header crval shift":
        lambda m: _correct(m, 0.75, lag_crval1=24.0, lag_crval2=6.0),
    "correct_pointing_header crota rebuilds pc":
        lambda m: _correct(m, 0.0, lag_crval1=0.0, lag_crval2=0.0,
                           lag_crota=1.0),
    "correct_pointing_header cdelt units":
        lambda m: _correct(m, 0.0, cunit="deg", cdelt=0.01,
                           lag_cdelt1=36.0),
    "CD matrix, rotated": _rotated_cd,
    "CD matrix, axis flip": lambda m: _cd(m, {"CD1_1": -1.5,
                                              "CD2_2": 1.5}),
    "CD matrix, skew": lambda m: _cd(m, {"CD1_1": 1.0, "CD1_2": 0.3,
                                         "CD2_1": 0.0, "CD2_2": 1.0}),
    "CD matrix, partial": lambda m: _cd(m, {"CD1_1": 1.5, "CDELT1": 1.5,
                                            "CDELT2": 1.5}),
}


@pytest.mark.parametrize("case", sorted(HEADER_CASES))
def test_header_helpers_match_jax(case):
    """The same cards with values within 1e-12, or the same exception
    and message; the same warnings."""
    want, want_warn = run_case(jheader, HEADER_CASES[case])
    got, got_warn = run_case(theader, HEADER_CASES[case])
    assert got_warn == want_warn
    if isinstance(want, tuple):
        assert got == want
        return
    assert not isinstance(got, tuple), got
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-12, abs=1e-15), k
        else:
            assert got[k] == v, k


def test_wcs_params_from_header_matches_jax():
    """Units to degrees and the projection kind, card for card."""
    want = jheader.wcs_params_from_header(wcs_header(jheader))
    got = theader.wcs_params_from_header(wcs_header(theader))
    assert got.kind == want.kind == "tan"
    for k, v in want.as_dict().items():
        assert got.as_dict()[k] == pytest.approx(v, rel=1e-15), k
