"""Each metric reader on a small recorded record, and the trace reduction
on a hand-built event list."""
import math
from types import SimpleNamespace

import pytest

from _tiny import DATA  # noqa: F401
from coreg_bench import discover, roofline, trace


def _rec(**kw):
    rec = {"stages": {}, "files": 4, "launches": {"K1": 0, "K2": 0},
           "kernels": {}, "busy_s": 0.0, "window_s": 0.0,
           "counts": lambda kernel: None,
           "run": {"setup_s": 12.5, "window_s": 50.0, "attempted": 101,
                   "completed": 100, "file_seconds": [0.5] * 90 + [1.0] * 11}}
    rec.update(kw)
    return rec


def test_end_to_end_readers():
    rec = _rec()
    assert discover.reader("files_per_s")(rec) == 2.0
    assert discover.reader("setup_s")(rec) == 12.5
    # 101 files, 16 of them slow: the 85th percentile is the 86th value
    rec["run"]["file_seconds"] = [0.5] * 85 + [1.0] * 16
    assert discover.reader("file_p85_s")(rec) == 1.0
    assert discover.reader("file_p85_s.fft_routes")(rec) == 1.0
    rec["run"]["file_seconds"] = [0.5] * 86 + [1.0] * 15
    assert discover.reader("file_p85_s")(rec) == pytest.approx(0.5)


@pytest.mark.parametrize("name,label", [
    ("fits_load_ms", "api_fits_load_s"),
    ("block_surfaces_ms", "fast_surfaces_s"),
    ("tilefft_gate_ms", "carr_tilefft_gate_s")])
def test_stage_readers(name, label):
    read = discover.reader(name)
    assert read(_rec(stages={label: 0.24})) == pytest.approx(60.0)
    assert read(_rec(stages={"other": 1.0})) is None


def test_idle_share():
    read = discover.reader("device_idle_share")
    assert read(_rec(busy_s=3.0, window_s=4.0)) == pytest.approx(25.0)
    assert read(_rec()) is None


COUNTS = {"h": 2048, "w": 2048, "n_ref": 2048 * 2048, "n_lags": 11907,
          "n_summed": 0.8 * 2048 * 2048 * 11907}


def test_k1_roofline_reader():
    read = discover.reader("k1_roofline")
    kernels = {"void warp_score_kernel<float, 2, 0, 3>(...)":
               {"count": 4, "seconds": 1.56},
               "reduce_partials": {"count": 4, "seconds": 0.016}}
    rec = _rec(kernels=kernels, launches={"K1": 4, "K2": 0},
               counts=lambda kernel: COUNTS)
    bound, by = roofline.kernel_bound(
        "K1 tan", COUNTS["n_ref"], 11907, COUNTS["n_summed"],
        roofline.launch_bytes("K1 tan", 2048, 2048, 11907))
    assert by == "operations"
    assert read(rec) == pytest.approx(100 * bound / 394.0)
    assert 10.0 < read(rec) < 20.0
    assert discover.reader("k2_roofline")(rec) is None
    assert read(_rec(kernels=kernels, counts=lambda k: COUNTS)) is None


def test_k2_roofline_reader_leaves_a_shared_reduction_out():
    read = discover.reader("k2_roofline")
    counts = dict(COUNTS, n_lags=14641, n_summed=0.7 * 2048 ** 2 * 14641)
    both = {"quad_score_kernel": {"count": 2, "seconds": 0.46},
            "warp_score_kernel": {"count": 1, "seconds": 0.39},
            "reduce_partials": {"count": 3, "seconds": 0.3}}
    rec = _rec(kernels=both, launches={"K1": 1, "K2": 2},
               counts=lambda kernel: counts)
    want = roofline.share_percent("K2", counts, 230.0)
    assert read(rec) == pytest.approx(want)


def _evt(name, start, end, cuda=False, annotation=False):
    kind = SimpleNamespace(name="CUDA" if cuda else "CPU")
    return SimpleNamespace(name=name, device_type=kind,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_trace_reduction():
    events = [
        _evt(trace.FILE_SPAN, 0, 1000), _evt(trace.FILE_SPAN, 1000, 2000),
        _evt("align_using_helioprojective", 10, 990),
        _evt("aten::fft_rfft2", 100, 120),
        _evt("kernel_a", 100, 400, cuda=True),
        _evt("kernel_a", 300, 500, cuda=True),
        _evt("kernel_b", 1500, 1600, cuda=True),
        _evt("kernel_b", 2100, 2300, cuda=True),   # after the stretch
        # the card's mirrors of host annotations are no device work
        _evt("align_using_helioprojective", 100, 900, cuda=True),
        _evt("gpu annotation", 0, 2000, cuda=True, annotation=True)]
    host, dev = trace.split_events(events)
    red = trace.reduce(host, dev)
    assert red["window_s"] == pytest.approx(2000e-6)
    assert red["busy_s"] == pytest.approx(500e-6)
    assert red["kernels"]["kernel_a"]["count"] == 2
    assert red["kernels"]["kernel_b"]["seconds"] == pytest.approx(100e-6)
    gaps = dict(red["breakdown"]["idle_gaps"])
    # [0, 10) in the first file's span, [10, 100) and [500, 990) inside the
    # call, [990, 1000) in the first file's span again, [1000, 1500) and
    # [1600, 2000) in the second file's
    assert gaps["align_using_helioprojective"] == pytest.approx(580e-6)
    assert gaps[trace.FILE_SPAN] == pytest.approx(920e-6)
    assert sum(gaps.values()) == pytest.approx(1500e-6)
    assert red["breakdown"]["device_ops"][0][0] == "kernel_a"
    assert trace.reduce([], dev) is None


def test_roofline_share_cannot_exceed_100_at_the_bound():
    bound, _ = roofline.kernel_bound(
        "K2", COUNTS["n_ref"], 14641, COUNTS["n_summed"],
        roofline.launch_bytes("K2", 2048, 2048, 14641))
    assert roofline.share_percent("K2", dict(COUNTS, n_lags=14641),
                                  bound) == pytest.approx(100.0)
    assert math.isfinite(bound) and bound > 0
