"""A frame owns its pair, its files and its program call: two test frames
run as files alone (an L2-like file with its image in HDU 1, and a SPICE L2
raster through ``AlignmentSpice``), a fault in each makes it not correct,
and the default hooks give every other cell the pair, the files and the
``Alignment`` call the harness made before the hooks existed."""
import hashlib
import os

import numpy as np
import pytest
import torch

from _tiny import DATA, run_tiny, tiny_bench
from coreg_bench import discover, harness
from coreg_bench.reference import judge

FRAMES = ("tiny_helio_ext", "tiny_spice")
ACCEPTED = ("helio_roll5d_k1", "carr_coarse_k2", "helio_wide_roll_block")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def frame_results():
    return {name: run_tiny(name, bench=tiny_bench(FRAMES)) for name in FRAMES}


@pytest.mark.parametrize("name", FRAMES)
def test_a_frame_added_as_files_alone_is_correct(frame_results, name):
    res = frame_results[name]
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"files_per_s", "file_p85_s", "setup_s"}


def test_the_harness_names_no_frame_of_the_tests():
    here = os.path.dirname(harness.__file__)
    for module in ("harness.py", "discover.py", "inputs.py", "run.py"):
        text = open(os.path.join(here, module)).read()
        assert not any(name in text for name in FRAMES), module


def test_a_frame_is_found_under_the_data_root_first():
    assert discover.frame("tiny_spice", DATA).__name__.endswith("tiny_spice")
    assert discover.frame("helioprojective", DATA) is \
        discover.frame("helioprojective")
    with pytest.raises(ModuleNotFoundError):
        discover.frame("tiny_spice")


def _written(name, tmp_path, seed=77):
    cell = harness.Cell(name, DATA)
    pair = cell.make_pair(cell.config, cell.workload, seed, 0, CPU)
    return cell, pair, cell.write_pair(pair, str(tmp_path), 0)


def test_tiny_helio_ext_keeps_its_image_in_hdu_1(tmp_path):
    from euispice_coreg_tpu_torch.io import fits

    cell, pair, paths = _written("tiny_helio_ext", tmp_path)
    for path, key in zip(paths, ("large", "small")):
        hdul = fits.open(path)
        assert "CRVAL1" not in hdul[0].header and hdul[0].data is None
        assert np.array_equal(np.asarray(hdul[1].data), pair[key])
        assert hdul[1].header["CRVAL1"] == pair["hdr_" + key]["CRVAL1"]


def test_tiny_spice_writes_a_non_square_l2_cube_without_crota(tmp_path):
    from euispice_coreg_tpu_torch.io import fits

    cell, pair, paths = _written("tiny_spice", tmp_path)
    assert "L2" in os.path.basename(paths[1])
    hdul = fits.open(paths[1])
    hdr, cube = hdul[0].header, np.asarray(hdul[0].data)
    assert cube.ndim == 4 and cube.shape == pair["small"].shape
    assert cube.shape[2] != cube.shape[3]
    assert hdr["CDELT1"] != hdr["CDELT2"]
    assert not {"CROTA", "CROTA2"} & set(hdr.keys())
    assert "PC1_2" in hdr and "PC4_1" in hdr
    assert np.array_equal(np.asarray(hdul[1].data), pair["other"])
    # CDELT1 lags on axis 1's own pitch
    c1 = cell.config["small"]["cdelt_arcsec"][0]
    assert np.array_equal(cell.lags_arcsec[2], np.array([-0.02, 0.0, 0.02])
                          * c1)


def _header_moved(monkeypatch):
    from euispice_coreg_tpu_torch.hdrshift import results

    orig = results.AlignmentResults.return_corrected_header

    def moved(self, window, path_to_l2_input=None):
        hdr = orig(self, window, path_to_l2_input)
        hdr["CRVAL1"] = hdr["CRVAL1"] + 1.0    # arcsec
        return hdr

    monkeypatch.setattr(results.AlignmentResults, "return_corrected_header",
                        moved)


def _wrong_window(monkeypatch):
    """The program reads the image to correct from the other HDU: the empty
    primary of an L2-like file, the second spectral window of the raster."""
    from euispice_coreg_tpu_torch.hdrshift import alignment

    orig = alignment.Alignment.__init__

    def other(self, *a, **kw):
        orig(self, *a, **kw)
        self.small_fov_window = 1 - self.small_fov_window

    monkeypatch.setattr(alignment.Alignment, "__init__", other)


@pytest.mark.parametrize("name", FRAMES)
@pytest.mark.parametrize("fault", ["header moved 1 arcsec", "wrong window"])
def test_a_fault_in_a_frame_is_not_correct(monkeypatch, name, fault):
    {"header moved 1 arcsec": _header_moved,
     "wrong window": _wrong_window}[fault](monkeypatch)
    if (name, fault) == ("tiny_helio_ext", "wrong window"):
        # an L2 file's primary HDU holds no image and no WCS: the set-up's
        # call raises, and the run ends without a result line
        with pytest.raises(ValueError, match="CROTA, CROTA2 or PCi_j"):
            run_tiny(name, bench=tiny_bench(FRAMES))
        return
    res = run_tiny(name, bench=tiny_bench(FRAMES))
    assert res["attempted"] >= 1
    assert res["correct"] is False, res["checks"]


# ---------------------------------------------------------------------------
# the default hooks are the path every other cell took before
# ---------------------------------------------------------------------------

def _cell(name):
    """The cell; an accepted cell's images at a tiny size (the hooks do not
    depend on it)."""
    root = DATA if name.startswith("tiny") else None
    cell = harness.Cell(name, root)
    if root is None:
        cell.config["small"]["n"], cell.config["large"]["n"] = 48, 64
    return cell


def _parent_lags(workload, config):
    """The lag axes as the harness computed them with one pitch."""
    lg = workload["lags"]
    crval = [(np.arange(lg[k]["n"]) - lg[k]["n"] // 2) * lg[k]["step_arcsec"]
             for k in ("crval1", "crval2")]
    cdelt = config["small"]["cdelt_arcsec"]
    frac = [np.asarray(lg.get(k, [0.0]), dtype=np.float64) * cdelt
            for k in ("cdelt1_frac", "cdelt2_frac")]
    crota = np.asarray(lg.get("crota_deg", [0.0]), dtype=np.float64)
    return crval + frac, crota


class _Recorder:
    calls = []

    def __init__(self, **kw):
        _Recorder.calls.append(kw)


def _parent_call(cell, paths, device):
    """The keywords the harness gave ``Alignment`` before the hooks."""
    l1, l2, l3, l4 = cell.lags_arcsec
    mixed = (len(l3) > 1 or len(l4) > 1 or len(cell.crota) > 1)
    kw = dict(lag_crval1=l1, lag_crval2=l2, lag_search_mode="auto",
              small_fov_window=0, large_fov_window=0, device=device,
              reprojection_order=cell.config["reprojection_order"],
              compute_dtype=cell.config["compute_dtype"])
    if mixed:
        kw.update(lag_cdelt1=l3, lag_cdelt2=l4, lag_crota=cell.crota)
    return dict(large_fov_known_pointing=paths[0],
                small_fov_to_correct=paths[1], **kw)


def _digest(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


# sha256 of pair 1's two files (seed 4242424242) and its injected error,
# as the harness wrote them before the frame hooks (commit 6bce23d), the
# accepted cells' images at the tiny size of ``_cell``
PARENT_PAIR_1 = {
    "helio_roll5d_k1": (
        "339b04f1c1a097682a5f8357b6b8e569fcfa645968be43e32ee5b6bf9199076e",
        "4f7024c5abcc317fad2917a291cb7bc752a6a62b49d37550d24f65fdaa3b65e6",
        (1.2581049264485475, 7.216099811907409)),
    "carr_coarse_k2": (
        "2cbe6d95761fa5ef4e7cc14d25c5c7f156a14e7e6d404bc7676593dcb1a9c356",
        "a99e5bd6e315a7810a37b34de29d3c64c9609b42ac34f6aea502a3f749ed2a6e",
        (42.36551464589087, -27.044122322828713)),
    "helio_wide_roll_block": (
        "339b04f1c1a097682a5f8357b6b8e569fcfa645968be43e32ee5b6bf9199076e",
        "fd54712fb51aadfdb8b64624997adcbbc01232a67d1aab33955e9c68bf8b665b",
        (3.145262316121368, 18.040249529768523)),
    "tiny_helio": (
        "987761203a45ae46c770b57028380dfaea570cecd02de2852d96a975d740c1bd",
        "15b9dce8c4b80e10d408ea2e764e99647d42a28fd5eaf89ece38bd4a9b24f8ec",
        (1.4153680422546167, 8.118112288395835)),
    "tiny_carr": (
        "8a330ce44514bf0a3951eb3ff33ad93862f86c2d2a2ed9a0bfff77c17b63bbc5",
        "a3534fba04cb538e1d973b38e686fdb25bb5665cbd009058d4d123dab38cc600",
        (26.478446653681786, -16.90257645176795)),
}


@pytest.mark.parametrize("name", ACCEPTED + ("tiny_helio", "tiny_carr"))
def test_the_default_hooks_give_the_parents_pair_files_and_call(
        monkeypatch, tmp_path, name):
    import euispice_coreg_tpu_torch

    cell = _cell(name)
    assert cell.program is harness.alignment
    pair = cell.make_pair(cell.config, cell.workload, 4242424242, 1, CPU)
    a = cell.write_pair(pair, str(tmp_path), 1)
    assert [os.path.basename(p) for p in a] == \
        ["pair1_large.fits", "pair1_small.fits"]
    *files, error = PARENT_PAIR_1[name]
    assert [_digest(p) for p in a] == files
    assert pair["error"] == error

    monkeypatch.setattr(euispice_coreg_tpu_torch, "Alignment", _Recorder)
    _Recorder.calls.clear()
    obj, window = cell.program(a, cell.keywords(CPU))
    assert isinstance(obj, _Recorder) and window == 0
    got, = _Recorder.calls
    want = _parent_call(cell, a, CPU)
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].tobytes() == value.tobytes(), key
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("name", ACCEPTED + ("tiny_helio", "tiny_carr"))
def test_a_scalar_pitch_keeps_the_lags_bit_for_bit(name):
    cell = _cell(name)
    lags, crota = harness.lags_of(cell.workload, cell.config)
    want, want_crota = _parent_lags(cell.workload, cell.config)
    assert crota.tobytes() == want_crota.tobytes()
    for got, ref in zip(lags, want):
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


def test_a_pitch_pair_scales_each_axis_by_its_own():
    wl = {"lags": {"crval1": {"n": 3, "step_arcsec": 1.0},
                   "crval2": {"n": 3, "step_arcsec": 1.0},
                   "cdelt1_frac": [-0.01, 0.0, 0.01],
                   "cdelt2_frac": [-0.02, 0.02]}}
    lags, _ = harness.lags_of(wl, {"small": {"cdelt_arcsec": [4.0, 1.098]}})
    assert np.array_equal(lags[2], np.array([-0.01, 0.0, 0.01]) * 4.0)
    assert np.array_equal(lags[3], np.array([-0.02, 0.02]) * 1.098)


@pytest.mark.parametrize("hdr,want", [
    ({"CROTA": 0.7, "CROTA2": 9.0, "PC1_1": 1.0, "PC1_2": 0.0}, 0.7),
    ({"CROTA2": -0.3, "PC1_1": 1.0, "PC1_2": 0.0}, -0.3),
    ({"PC1_1": np.cos(np.radians(0.4)),
      "PC1_2": -(1.098 / 4.0) * np.sin(np.radians(0.4))}, 0.4),
    ({"PC1_1": np.cos(np.radians(1.5)),
      "PC1_2": (1.098 / 4.0) * np.sin(np.radians(1.5))}, -1.5),
    ({"PC1_1": 1.0, "PC1_2": 0.0}, 0.0)])
def test_the_judged_roll_comes_from_crota_crota2_or_pc(hdr, want):
    full = dict(hdr, CRVAL1=1.0, CRVAL2=2.0, CDELT1=4.0, CDELT2=1.098)
    got = judge.header_values(full)
    assert list(got) == list(judge.HEADER_KEYS)
    assert got["CROTA"] == pytest.approx(want, abs=1e-9)
