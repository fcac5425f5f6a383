"""The SPICE sequence frame at a tiny size: a raster of 40 columns against
4 imager frames, as the synthetic raster and ``AlignmentSpice``
(``tiny_spice_synras``) and as the iterative context raster
(``tiny_spice_iter``).  Each is correct on the sound program and not
correct under the faults of ``test_coreg_bench_faults.py`` and a compose
that gives columns the neighbouring frame; the program's composed rasters
equal the reference's compose; the control fails; the new metrics read
the program's new spans and counters and nothing on a program without
them."""
import io
import os
import tempfile

import numpy as np
import pytest
import torch

from _tiny import DATA, run_tiny, tiny_bench
from coreg_bench import control, discover, harness, roofline
from coreg_bench.reference import geometry as g
from coreg_bench.reference import judge
from coreg_bench.reference import spice as sp
from test_coreg_bench_faults import FAULTS

CELLS = ("tiny_spice_synras", "tiny_spice_iter")
ROUTE = {"tiny_spice_synras": "gather", "tiny_spice_iter": "iterative"}
CPU = torch.device("cpu")


def _run(name, **kw):
    out = io.StringIO()
    res = harness.run_cell(name, 4242424242, 1.0, False, t0=0.0,
                           device="cpu", bench=tiny_bench(CELLS),
                           data_root=DATA, out=out, err=io.StringIO(), **kw)
    return res, out.getvalue()


@pytest.mark.parametrize("name", CELLS)
def test_a_sequence_cell_is_correct_on_its_route(name):
    res, out = _run(name)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["attempted"] >= 1
    assert f"routes {{'{ROUTE[name]}': {res['attempted']}}}" in out
    assert set(res["metrics"]) == {"files_per_s", "file_p85_s", "setup_s"}


def _neighbouring_frame(monkeypatch):
    """Each column's frame chosen as if its time were read five raster
    steps late, half the tiny sequence's cadence: the first half of every
    frame's columns take the frame before."""
    from euispice_coreg_tpu_torch.synras import map_builder

    orig = map_builder.ComposedMapBuilder._select_frames

    def late(self, utc_cols):
        sel = orig(self, utc_cols)
        return np.concatenate([sel[:5], sel[:-5]])

    monkeypatch.setattr(map_builder.ComposedMapBuilder, "_select_frames",
                        late)


SEQUENCE_FAULTS = dict(FAULTS, **{"neighbouring frame": _neighbouring_frame})


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(SEQUENCE_FAULTS))
def test_a_fault_in_the_sequence_is_not_correct(monkeypatch, name, fault):
    SEQUENCE_FAULTS[fault](monkeypatch)
    res = run_tiny(name, bench=tiny_bench(CELLS))
    assert res["attempted"] >= 1
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    c = harness.Cell(name, DATA)
    nums = control.control_readings(c, 31337, CPU)
    assert any(nums[k] > c.workload["limits"][k] for k in judge.NUMBERS), nums


def _written(name, tmp, seed=77):
    cell = harness.Cell(name, DATA)
    pair = cell.make_pair(cell.config, cell.workload, seed, 0, CPU)
    return cell, pair, cell.write_pair(pair, tmp, 0)


def test_the_files_of_a_pair():
    """One raster of two windows, no CROTA card and "L2" in its name, and a
    file per frame with its DATE-AVG; only the synthetic raster's cell names
    an L3 file."""
    from euispice_coreg_tpu_torch.io import fits

    with tempfile.TemporaryDirectory() as tmp:
        cell, pair, files = _written("tiny_spice_synras", tmp)
        assert "L2" in os.path.basename(files.raster)
        hdul = fits.open(files.raster)
        assert len(hdul) == len(cell.config["windows"]) == 2
        assert np.array_equal(np.asarray(hdul[0].data), pair["small"])
        assert not {"CROTA", "CROTA2"} & set(hdul[0].header.keys())
        assert hdul[0].header["PC4_1"] == 60.0
        dates = [fits.open(p)[0].header["DATE-AVG"] for p in files.frames]
        assert len(dates) == cell.config["large"]["frames"]
        assert dates[1] == "2022-03-17T09:15:00.000"
        assert files.composed.endswith("pair0.fits")
        assert files.threshold_s == 600.0
        _, _, files = _written("tiny_spice_iter", tmp)
        assert files.composed is None
    # 10 columns a frame: column c exposed 60 (c + 0.5) s after DATE-BEG
    assert np.array_equal(sp.nearest_frames(pair["hdr_small"], 40,
                                            pair["hdr_frames"]),
                          np.arange(40) // 10)


def test_the_composed_rasters_are_the_references(monkeypatch):
    """The synthetic raster the program writes, and each lag's raster of
    the iterative search, against the reference's compose (the program
    samples the frames in float32)."""
    from euispice_coreg_tpu_torch.hdrshift import alignment_spice
    from euispice_coreg_tpu_torch.io import fits

    with tempfile.TemporaryDirectory() as tmp:
        cell, pair, files = _written("tiny_spice_synras", tmp)
        cell.program(files, cell.keywords(CPU))
        got = np.asarray(fits.open(files.composed)[0].data, np.float64)
    img = sp.masked_sum(pair["small"], pair["hdr_small"])
    seq = sp.Sequence(pair["frames"], pair["hdr_frames"], pair["hdr_small"],
                      img.shape, torch.float64, CPU)
    want = seq.compose(g.tan_params(sp.spatial(pair["hdr_small"]))).numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert np.nanmax(np.abs(got - want)) < 1e-4

    stacks = []
    orig = alignment_spice._iter_chunk_scores

    def keep(params_l, params_s, data_stack, *a):
        stacks.append(data_stack.clone())
        return orig(params_l, params_s, data_stack, *a)

    monkeypatch.setattr(alignment_spice, "_iter_chunk_scores", keep)
    with tempfile.TemporaryDirectory() as tmp:
        cell, pair, files = _written("tiny_spice_iter", tmp)
        res, _ = cell.call(files, CPU)
    got = torch.cat(stacks).numpy()
    shape = tuple(len(v) for v in cell.lags_arcsec) + (len(cell.crota),)
    assert got.shape[0] == int(np.prod(shape)) == res.corr.size
    ref = cell.reference(pair, CPU)
    for flat in (0, got.shape[0] // 2, got.shape[0] - 1):
        k = np.unravel_index(flat, shape)
        want = ref._lag_pair(k)[0].numpy()
        assert np.array_equal(np.isfinite(got[flat]), np.isfinite(want))
        assert np.nanmax(np.abs(got[flat] - want)) < 1e-4


def test_the_sequence_modules_load_nothing_of_the_program():
    import subprocess
    import sys

    from _tiny import ROOT

    code = ("import coreg_bench.reference.spice, "
            "coreg_bench.frames.spice_sequence, sys\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT)).stdout
    assert not set(out.split()) & {"jax", "jaxlib", "euispice_coreg_tpu",
                                   "euispice_coreg_tpu_torch"}


# ---------------------------------------------------------------------------
# the readers of the new spans and counters
# ---------------------------------------------------------------------------

class Scope(dict):
    def __init__(self, seconds=(), counters=(), card=()):
        super().__init__(seconds)
        self.spans = []
        self.counters = dict(counters)
        self.card = dict(card)


def _rec(stages, files=4, **kw):
    return dict({"stages": stages, "files": files,
                 "launches": {"K1": 0, "K2": 0}, "kernels": {},
                 "counts": lambda kernel: None}, **kw)


HOST = {"synras_frames_load_ms": "synras_frames_load_s",
        "spice_prep_ms": "spice_load_prep_s",
        "synras_headers_ms": "synras_headers_s",
        "iter_lag_headers_ms": "iter_lag_headers_s"}
CARD = {"synras_compose_ms": "synras_compose_s",
        "iter_score_ms": "iter_score_s"}


@pytest.mark.parametrize("name", sorted(HOST))
def test_host_span_readers(name):
    read = discover.reader(name)
    assert read(_rec(Scope({HOST[name]: 0.2}))) == pytest.approx(50.0)
    assert read(_rec(Scope({"api_align_s": 1.0}))) is None
    assert read(_rec(Scope({HOST[name]: 0.2}), files=0)) is None


@pytest.mark.parametrize("name", sorted(CARD))
def test_card_extent_readers(name):
    """The card extent, never the host seconds: a host span of that name
    (the parent's ``iter_score_s``) reads nothing."""
    read = discover.reader(name)
    rec = _rec(Scope({CARD[name]: 0.9}, card={CARD[name]: 0.02}))
    assert read(rec) == pytest.approx(5.0)
    assert read(_rec(Scope({CARD[name]: 0.9}))) is None
    assert read(_rec({CARD[name]: 0.9})) is None


def test_frame_read_counter_reader():
    read = discover.reader("synras_frames_read_mb")
    rec = _rec(Scope(counters={"synras_frame_read_bytes":
                               4 * 20 * 2048 * 2048 * 4}))
    assert read(rec) == pytest.approx(335.54432)
    assert read(_rec(Scope(counters={"fits_read_bytes": 5}))) is None
    assert read(_rec({"api_fits_load_s": 0.6})) is None


def test_k1_roofline_on_the_raster():
    counts = {"h": 1024, "w": 192, "n_ref": 560 * 192, "n_lags": 3969,
              "n_summed": 0.9 * 560 * 192 * 3969}
    kernels = {"void warp_score_kernel<float, 2, 0, 3>(...)":
               {"count": 2, "seconds": 0.0115}}
    read = discover.reader("k1_roofline.spice")
    rec = _rec(Scope(), kernels=kernels, launches={"K1": 2, "K2": 0},
               counts=lambda kernel: counts)
    assert read(rec) == pytest.approx(
        roofline.share_percent("K1 tan", counts, 5.75))
    assert read(_rec(Scope(), kernels=kernels,
                     counts=lambda kernel: counts)) is None


def test_the_new_metrics_list_the_new_cells_only():
    """The iterative cell is not declared yet (its traced run outlasts a
    run's time), so its two metrics are not either."""
    bench = discover.benchmark()
    new = set(HOST) | set(CARD) | {"synras_frames_read_mb",
                                   "k1_roofline.spice"}
    cells = {"spice_synras_k1"}
    assert "spice_iter_raster" not in {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        if m["name"] in new:
            assert set(m["workloads"]) <= cells and m["moves"] == \
                "files_per_s"
        else:
            assert not set(m.get("workloads", [])) & cells
