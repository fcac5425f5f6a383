"""The readers of the program's spans and counters on a synthetic record:
what ``utils.obs.collect_stages()`` yields, a dict of host seconds by span
name that also carries ``spans``, ``counters`` and ``card``."""
from types import SimpleNamespace

import pytest

from _tiny import DATA  # noqa: F401
from coreg_bench import discover


class Scope(dict):
    """The shape of the program's scope: host seconds by name, and beside
    them the spans, the counters and the card extents."""

    def __init__(self, seconds=(), spans=(), counters=(), card=()):
        super().__init__(seconds)
        self.spans = list(spans)
        self.counters = dict(counters)
        self.card = dict(card)


def span(name, start_ms, end_ms, parent=None, file=1):
    return SimpleNamespace(name=name, start_ns=int(start_ms * 1e6),
                           end_ns=int(end_ms * 1e6), parent=parent, file=file)


def _rec(stages, files=4):
    return {"stages": stages, "files": files}


@pytest.mark.parametrize("name,span_name", [
    ("submap_ms", "api_submap_s"),
    ("carr_reproject_ms", "carr_api_reproject_s"),
    ("block_warp_ms", "block_warp_s")])
def test_card_extent_readers(name, span_name):
    """The card extent, not the host seconds, per traced file."""
    read = discover.reader(name)
    rec = _rec(Scope({span_name: 0.004}, card={span_name: 0.02}))
    assert read(rec) == pytest.approx(5.0)
    assert read(_rec(Scope({span_name: 0.004}))) is None
    assert read(_rec(Scope(card={"other_s": 1.0}))) is None


@pytest.mark.parametrize("name,span_name", [
    ("fit_ms", "api_fit_s"),
    ("corrected_header_ms", "api_corrected_header_s")])
def test_host_span_readers(name, span_name):
    read = discover.reader(name)
    assert read(_rec(Scope({span_name: 0.16}))) == pytest.approx(40.0)
    assert read(_rec(Scope({"api_align_s": 1.0}))) is None


@pytest.mark.parametrize("name,counter", [
    ("fits_read_mb", "fits_read_bytes"), ("htod_mb", "htod_bytes")])
def test_counter_readers(name, counter):
    read = discover.reader(name)
    rec = _rec(Scope(counters={counter: 4 * 71_300_000}))
    assert read(rec) == pytest.approx(71.3)
    assert read(_rec(Scope(counters={"other": 5}))) is None


def test_align_untraced_is_the_self_time_of_the_call():
    """Two files: each api_align_s less the union of its children (two of
    them overlap); a grandchild and a span outside the call count for
    nothing."""
    spans = [span("api_align_s", 0, 100),                 # 0
             span("api_fits_load_s", 0, 40, parent=0),
             span("api_search_s", 50, 80, parent=0),       # 2
             span("k1_s", 55, 79, parent=2),
             span("htod_copy_s", 70, 85, parent=0),
             span("api_corrected_header_s", 100, 130),
             span("api_align_s", 200, 260, file=2),        # 6
             span("api_fit_s", 250, 260, parent=6, file=2)]
    read = discover.reader("align_untraced_ms")
    # file 1: 100 - (40 + [50, 85)) = 25; file 2: 60 - 10 = 50
    assert read(_rec(Scope(spans=spans), files=2)) == pytest.approx(37.5)
    assert read(_rec(Scope(spans=spans[5:6]), files=2)) is None


@pytest.mark.parametrize("name", [
    "submap_ms", "carr_reproject_ms", "block_warp_ms", "fit_ms",
    "corrected_header_ms", "align_untraced_ms", "fits_read_mb", "htod_mb"])
def test_nothing_to_read(name):
    """A program whose scope is a plain dict of host seconds (the parent of
    the spans), an empty scope, or no traced file: None, never a raise."""
    read = discover.reader(name)
    old = {"api_fits_load_s": 0.6, "fast_surfaces_s": 0.4}
    assert read(_rec(old)) is None
    assert read(_rec(Scope())) is None
    full = Scope({"api_fit_s": 1.0, "api_corrected_header_s": 1.0},
                 spans=[span("api_align_s", 0, 10)],
                 counters={"fits_read_bytes": 1, "htod_bytes": 1},
                 card={"api_submap_s": 1.0, "carr_api_reproject_s": 1.0,
                       "block_warp_s": 1.0})
    assert read(_rec(full)) is not None
    assert read(_rec(full, files=0)) is None
