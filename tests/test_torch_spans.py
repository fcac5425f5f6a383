"""The port's spans (``utils.obs.stage``) through a public-API file on the
CPU: the parent and file id of each span from ``Alignment`` through
``align_using_*`` to ``return_corrected_header``, nothing recorded while
no scope collects and no profiler records, the spans as ranges of a
``torch.profiler`` trace that ``coreg_bench.trace`` reads, and the bytes
and data units ``io/fits.open`` counts; the spans and counters of the SPICE
path (the synthetic raster, the iterative context raster and the L2 load)
under their file ids.  The card extent of a card span is tested on the
card, in ``tests/test_torch_cuda.py``."""
import os

import numpy as np
import pytest
import torch

import fixtures as fx
from euispice_coreg_tpu.io import fits as jfits
from euispice_coreg_tpu_torch import Alignment
from euispice_coreg_tpu_torch.hdrshift import (
    AlignementSpiceIterativeContextRaster, AlignmentSpice)
from euispice_coreg_tpu_torch.synras import SPICEComposedMapBuilder
from euispice_coreg_tpu_torch.utils import obs, timeutils

LAGS = dict(lag_crval1=np.arange(4, 13, 2.0), lag_crval2=np.arange(-8, 1, 2.0),
            small_fov_window=0, large_fov_window=0, device="cpu")
# the children of api_align_s in a helioprojective file on the CPU
ALIGN_CHILDREN = {"api_fits_load_s", "api_prepare_s", "api_submap_s",
                  "lag_route_s", "api_search_s", "api_fit_s"}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    dl, hl, ds, hs = fx.make_helioprojective_pair(
        true_shift_arcsec=(8.0, -4.0))
    return fx.write_pair_fits(tmp_path_factory.mktemp("spans"), dl, hl, ds,
                              hs)


def one_file(pair):
    """Alignment -> align_using_helioprojective -> return_corrected_header."""
    a = Alignment(pair[0], pair[1], **LAGS)
    res = a.align_using_helioprojective()
    res.return_corrected_header(0)
    return a


def test_spans_of_a_file_share_its_id_and_nest(pair):
    with obs.collect_stages() as st:
        a = one_file(pair)
        b = one_file(pair)
    assert a._file_id != b._file_id
    assert obs.current_file() is None
    for fid in (a._file_id, b._file_id):
        spans = [s for s in st.spans if s.file == fid]
        idx = {id(s): i for i, s in enumerate(st.spans)}
        top = [s for s in spans if s.parent is None]
        assert [s.name for s in top] == ["api_align_s",
                                         "api_corrected_header_s"]
        align = idx[id(top[0])]
        children = {s.name for s in spans if s.parent == align}
        assert children == ALIGN_CHILDREN
        for s in spans:
            assert s.end_ns >= s.start_ns
            if s.parent is not None:
                p = st.spans[s.parent]
                assert p.file == fid
                assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        # the host-to-device copies run inside the submap and the search
        assert {st.spans[s.parent].name for s in spans
                if s.name == "htod_copy_s"} == {"api_submap_s",
                                                "api_search_s"}
    # the dict stays {span name: host seconds}, summed over both files
    assert set(st) == {s.name for s in st.spans}
    assert st["api_align_s"] == pytest.approx(sum(
        (s.end_ns - s.start_ns) * 1e-9 for s in st.spans
        if s.name == "api_align_s"))
    assert st.card == {}  # no card: no card extents


def test_results_run_under_their_search_file_id(pair):
    """A result keeps its search's file id: its header's span carries it
    whichever Alignment ran last."""
    a = Alignment(pair[0], pair[1], **LAGS)
    res = a.align_using_helioprojective()
    Alignment(pair[0], pair[1], **LAGS)
    with obs.collect_stages() as st:
        res.return_corrected_header(0)
    (s,) = st.spans
    assert (s.name, s.file, s.parent) == ("api_corrected_header_s",
                                          a._file_id, None)


def test_nothing_recorded_without_a_scope_or_profiler(pair, monkeypatch):
    """Off, a span keeps no record, opens no profiler range and counts
    nothing; a scope opened afterwards starts empty."""
    def fail(*args, **kwargs):
        raise AssertionError("recorded while off")

    monkeypatch.setattr(obs, "Span", fail)
    monkeypatch.setattr(obs._profiler, "record_function", fail)
    assert not obs.stages_active()
    one_file(pair)
    obs.count("fits_read_bytes", 10)
    monkeypatch.undo()
    with obs.collect_stages() as st:
        pass
    assert st == {} and st.spans == [] and st.counters == {}


def test_spans_name_the_idle_time_of_a_profiler_trace(pair):
    """Under a CPU-only torch.profiler every span is a range of the trace,
    under its own name, inside the benchmark's file range; the benchmark's
    trace reduction then gives the idle time (here the whole stretch: no
    card) to the program's spans and the operators inside them, not to the
    outer range."""
    from coreg_bench import trace

    one_file(pair)  # warm
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.FILE_SPAN):
            one_file(pair)
    events = prof.events()
    names = {e.name for e in events}
    assert ALIGN_CHILDREN | {"api_align_s", "api_corrected_header_s",
                             "htod_copy_s"} <= names
    for e in events:
        if e.name in ALIGN_CHILDREN:
            assert e.cpu_parent.name == "api_align_s"
        if e.name in ("api_align_s", "api_corrected_header_s"):
            assert e.cpu_parent.name == trace.FILE_SPAN
    host, dev = trace.split_events(events)
    red = trace.reduce(host, dev, top=len(names))
    gaps = dict(red["breakdown"]["idle_gaps"])
    total = sum(gaps.values())
    assert total == pytest.approx(red["window_s"])
    catch_all = sum(gaps.get(n, 0.0) for n in (
        trace.FILE_SPAN, trace.OUTSIDE, "api_align_s"))
    assert catch_all <= 0.15 * total, gaps
    # the rest goes to the program's spans and the operators inside them:
    # the host-only steps by their own names
    assert {"api_fits_load_s", "api_prepare_s", "api_fit_s",
            "api_corrected_header_s"} <= set(gaps)


def test_fits_read_bytes_counts_what_is_read(pair):
    """Both files' header blocks and data units, and the small one's header
    blocks again for the corrected header, which reads no data unit."""
    from euispice_coreg_tpu_torch.io import fits

    def header_and_data(path):
        h = fits.open(path)[0].header
        data = h["NAXIS1"] * h["NAXIS2"] * abs(h["BITPIX"]) // 8
        return os.path.getsize(path) - data - (-data) % fits.BLOCK, data

    with obs.collect_stages() as st:
        one_file(pair)
    (lh, ld), (sh, sd) = (header_and_data(p) for p in pair)
    assert st.counters == {"fits_read_bytes": lh + ld + 2 * sh + sd,
                           "fits_data_units": 3, "fits_data_units_read": 2}


def test_timed_is_stage_at_info(caplog):
    with caplog.at_level("DEBUG", logger=obs.logger.name):
        with obs.timed("x_s"):
            pass
        with obs.stage("y_s"):
            pass
    levels = {r.getMessage().split(":")[0]: r.levelname
              for r in caplog.records}
    assert levels == {"x_s": "INFO", "y_s": "DEBUG"}


# ---------------------------------------------------------------------------
# the SPICE path: the synthetic raster, the iterative context raster
# ---------------------------------------------------------------------------

FRAME_SHAPE = (96, 96)
FRAME_BYTES = 96 * 96 * 4  # one float32 data unit
ITER_LAGS = dict(lag_crval1=[-4.0, 0.0, 4.0], lag_crval2=[-4.0, 0.0, 4.0],
                 lag_crota=[0.0, 0.2], small_fov_window=0,
                 large_fov_window=0, device="cpu")


@pytest.fixture(scope="module")
def spice_files(tmp_path_factory):
    """A 48-column SPICE L2 raster scanned in 240 s and two imager frames
    taken 60 s and 180 s after it began."""
    tmp = tmp_path_factory.mktemp("spice_spans")
    _, raster = fx.make_spice_pair(tmp)
    t0 = timeutils.parse_fits_time(
        jfits.open(raster)[0].header["DATE-BEG"])
    frames = []
    for k in range(2):
        hdr = fx.make_header(FRAME_SHAPE, (24.0, 24.0), (0.0, 0.0), 0.0)
        hdr["DATE-AVG"] = timeutils.format_fits_time(t0 + 60.0 + 120.0 * k)
        frames.append(str(tmp / f"frame_{k}.fits"))
        jfits.write(frames[-1], [jfits.PrimaryHDU(
            data=fx.render_helioprojective(hdr).astype(np.float32),
            header=hdr)])
    return raster, frames


def _count(spans, name):
    return sum(s.name == name for s in spans)


@pytest.mark.parametrize("batch_lags", [True, False])
def test_iterative_search_spans_share_its_file_id(spice_files, caplog,
                                                  batch_lags):
    """Every span of the search, the builder's included, runs under the
    search's file id inside ``api_align_s``: batched, three chunks of lag
    headers, composes and scores, each frame read once and composed once a
    chunk; one lag at a time, the builder's spans straight under the
    search.  One route line names the search."""
    raster, frames = spice_files
    a = AlignementSpiceIterativeContextRaster(frames, raster, 600.0,
                                              **ITER_LAGS)
    with caplog.at_level("INFO", logger=obs.logger.name), \
            obs.collect_stages() as st:
        res = a.align_using_helioprojective(batch_lags=batch_lags,
                                            lag_chunk=8)
        res.return_corrected_header(0)
    spans = st.spans
    assert {s.file for s in spans} == {a._file_id}
    assert [s.name for s in spans if s.parent is None] == [
        "api_align_s", "api_corrected_header_s"]
    align = next(i for i, s in enumerate(spans) if s.name == "api_align_s")
    children = {s.name for s in spans if s.parent == align}
    assert {"spice_load_prep_s", "api_fit_s"} <= children
    builder = {"synras_frames_load_s", "synras_compose_s",
               "synras_headers_s"}
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("engine path:")]
    if batch_lags:
        chunks = {"iter_lag_headers_s", "iter_compose_s", "iter_score_s"}
        assert chunks <= children
        assert [_count(spans, n) for n in sorted(chunks)] == [3, 3, 3]
        assert {spans[s.parent].name for s in spans
                if s.name in builder} == {"iter_compose_s"}
        assert [_count(spans, n) for n in sorted(builder)] == [6, 2, 3]
        assert lines == ["engine path: iterative context raster (18 lags "
                         "in 3 chunks of 8)"]
    else:
        assert builder <= children
        assert [_count(spans, n) for n in sorted(builder)] == [36, 2, 18]
        assert lines == ["engine path: iterative context raster, one lag "
                         "at a time (18 lags)"]
    assert st.counters["synras_frame_read_bytes"] == 2 * FRAME_BYTES
    assert st.card == {}


def test_synthetic_raster_and_spice_load_spans_carry_file_ids(spice_files,
                                                              tmp_path):
    """A builder outside any search opens its spans under an id of its
    own: each frame read and composed once, the header once; then
    ``AlignmentSpice`` reads the composed raster and the L2 cube under its
    file id, before its search."""
    raster, frames = spice_files
    with obs.collect_stages() as st:
        b = SPICEComposedMapBuilder(raster, frames, threshold_time=600.0,
                                    window_imager=0, window_spectro=0,
                                    device="cpu")
        path = b.process(str(tmp_path), basename_output="composed.fits",
                         print_filename=False, return_synras_name=True)
        a = AlignmentSpice(path, raster, **dict(
            ITER_LAGS, lag_crota=None))
        a.align_using_helioprojective()
    assert b._file_id != a._file_id and obs.current_file() is None
    top = [s for s in st.spans if s.parent is None]
    assert [(s.name, s.file) for s in top if s.file == b._file_id] == [
        ("synras_frames_load_s", b._file_id),
        ("synras_compose_s", b._file_id),
        ("synras_frames_load_s", b._file_id),
        ("synras_compose_s", b._file_id),
        ("synras_headers_s", b._file_id)]
    assert [s.name for s in top if s.file == a._file_id] == [
        "api_fits_load_s", "spice_load_prep_s", "api_align_s"]
    assert st.counters["synras_frame_read_bytes"] == 2 * FRAME_BYTES
