"""``correct`` comes out false for the control and for a broken timed path.

The control is the benchmark's reference put in the program's place, one
precision below the configuration's float32 (bfloat16); the faults break
the program underneath a run that skips the look for a card: an answer
altered where it is produced (the corrected header, one score of the
hypercube) and half of the pixels left out of each score, its mean taken
over the rest.  The cells run on one card, with no state carried from file
to file, so a step that leaves its state unchanged and a missing exchange
between cards have no counterpart here."""
import numpy as np
import pytest
import torch

from _tiny import DATA, run_tiny
from coreg_bench import control, discover, harness
from coreg_bench.reference import judge


@pytest.mark.parametrize("cell", ["tiny_helio", "tiny_carr"])
def test_the_control_fails(cell):
    limits = discover.workload(cell, DATA)["limits"]
    c = harness.Cell(cell, DATA)
    nums = control.control_readings(c, 31337, torch.device("cpu"))
    assert any(nums[k] > limits[k] for k in judge.NUMBERS), nums


@pytest.mark.parametrize("cell", ["tiny_helio", "tiny_carr"])
def test_the_program_passes_where_the_control_fails(cell):
    c = harness.Cell(cell, DATA)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        nums, routes = control.program_readings(c, 31337, torch.device("cpu"),
                                                tmp)
    limits = c.workload["limits"]
    assert all(nums[k] <= limits[k] for k in judge.NUMBERS), nums


def _alter_header(monkeypatch):
    from euispice_coreg_tpu_torch.hdrshift import results

    orig = results.AlignmentResults.return_corrected_header

    def altered(self, window, path_to_l2_input=None):
        hdr = orig(self, window, path_to_l2_input)
        hdr["CRVAL1"] = hdr["CRVAL1"] + 1.0    # arcsec
        return hdr

    monkeypatch.setattr(results.AlignmentResults, "return_corrected_header",
                        altered)


def _alter_one_score(monkeypatch):
    from euispice_coreg_tpu_torch.hdrshift import results

    orig = results.AlignmentResults.__init__

    def altered(self, corr, *a, **kw):
        # the score of the lag beside the peak, which the judgement always
        # reads (a lag elsewhere is read where the seed samples it)
        corr = np.array(corr, dtype=np.float64)
        peak = list(np.unravel_index(np.nanargmax(corr), corr.shape))
        peak[0] += 1 if peak[0] + 1 < corr.shape[0] else -1
        corr[tuple(peak)] += 0.05
        orig(self, corr, *a, **kw)

    monkeypatch.setattr(results.AlignmentResults, "__init__", altered)


def _half_the_pixels(monkeypatch):
    """Every score over the first half of the image's rows only."""
    from euispice_coreg_tpu_torch.core import resample, score
    from euispice_coreg_tpu_torch.engine import quad_score

    pearson = score.masked_pearson

    def half(a, b):
        h = a.shape[-2] // 2
        return pearson(a[..., :h, :], b[..., :h, :])

    monkeypatch.setitem(score.SCORE_FUNCTIONS, "correlation", half)
    plain = quad_score.quad_score_sums_reference

    def half_sums(canvas, ref, table, *, pad, order, method):
        ref = ref.clone()
        ref[ref.shape[0] // 2:] = float("nan")
        return plain(canvas, ref, table, pad=pad, order=order, method=method)

    monkeypatch.setattr(quad_score, "quad_score_sums_reference", half_sums)
    assert resample  # the gather path samples, the score reduces


FAULTS = {"header altered": _alter_header,
          "score beside the peak altered": _alter_one_score,
          "half the pixels left out": _half_the_pixels}


@pytest.mark.parametrize("cell", ["tiny_helio", "tiny_carr"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    res = run_tiny(cell)
    assert res["attempted"] >= 1
    assert res["correct"] is False, res["checks"]
