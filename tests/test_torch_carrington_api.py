"""The port's ``Alignment.align_using_carrington`` against the JAX
package's on the same FITS files (tests/fixtures.py make_carrington_pair)."""
import numpy as np
import pytest

import fixtures as fx
from euispice_coreg_tpu.hdrshift.alignment import Alignment as JAlignment
from euispice_coreg_tpu_torch import Alignment

LONLIMS, LATLIMS, SHAPE = (115.0, 125.0), (-2.0, 8.0), (128, 128)


@pytest.mark.parametrize("reproj,solar_r", [("fa", None),
                                            ("fa", [1.0, 1.004]),
                                            ("sunpy", None)])
def test_align_using_carrington_matches_jax(tmp_path, reproj, solar_r):
    """Public API on make_carrington_pair, default float32: the 6-D
    hypercube's shape, argmax equal (the true lag wins) and the fitted
    shift within 0.01 arcsec of the JAX package's."""
    dl, hl, ds, hs = fx.make_carrington_pair(true_shift_arcsec=(20.0, -10.0))
    p_large, p_small = fx.write_pair_fits(tmp_path, dl, hl, ds, hs)
    kw = dict(large_fov_known_pointing=p_large, small_fov_to_correct=p_small,
              lag_crval1=np.arange(5.0, 36.0, 5.0),
              lag_crval2=np.arange(-25.0, 6.0, 5.0), lag_solar_r=solar_r,
              small_fov_window=0, large_fov_window=0)
    call = dict(method_carrington_reprojection=reproj)
    if reproj == "fa":
        call.update(lonlims=LONLIMS, latlims=LATLIMS, shape=SHAPE)
    res_j = JAlignment(**kw, use_device_mesh=False).align_using_carrington(
        **call)
    res_t = Alignment(**kw, device="cpu").align_using_carrington(**call)
    n_r = 1 if solar_r is None else len(solar_r)
    assert res_t.corr.shape == res_j.corr.shape == (7, 7, 1, 1, 1, n_r)
    assert res_t.max_index == res_j.max_index
    for k in range(n_r):
        mi = np.unravel_index(np.nanargmax(res_t.corr[..., k]),
                              res_t.corr[..., k].shape)
        assert (kw["lag_crval1"][mi[0]], kw["lag_crval2"][mi[1]]) == \
            (20.0, -10.0)
    np.testing.assert_allclose(res_t.shift_arcsec, res_j.shift_arcsec,
                               atol=0.01)


def test_align_using_carrington_grid_rules(tmp_path):
    """The reference_date/DATE-AVG and lonlims/size_deg_carrington rules."""
    dl, hl, ds, hs = fx.make_carrington_pair()
    hl2 = hl.copy()
    del hl2["DATE-AVG"]
    p_large, p_small = fx.write_pair_fits(tmp_path, dl, hl2, ds, hs)
    A = Alignment(p_large, p_small, lag_crval1=[0.0], lag_crval2=[0.0],
                  small_fov_window=0, large_fov_window=0, device="cpu")
    with pytest.raises(ValueError, match="DATE-AVG"):
        A.align_using_carrington(lonlims=LONLIMS, latlims=LATLIMS,
                                 shape=SHAPE)
    with pytest.raises(ValueError, match="no in between"):
        A.align_using_carrington(lonlims=LONLIMS, reference_date="2022-03-17")
    with pytest.raises(ValueError, match="'fa' or 'sunpy'"):
        A.align_using_carrington(method_carrington_reprojection="astropy")
    corr = A.align_using_carrington(size_deg_carrington=(10.0, 10.0),
                                    reference_date=hs["DATE-OBS"],
                                    return_type="corr")
    assert A.lonlims == [115.0, 125.0] and A.latlims == [-2.0, 8.0]
    assert A.shape == [80, 80] and corr.shape == (1, 1, 1, 1, 1, 1)
    assert A.reference_date == hs["DATE-OBS"]
