"""The command itself: without a card it refuses; on a card one short run
of each cell gives a correct result line (marked ``cuda``: run on the
card with ``python -m pytest --noconftest -m cuda coreg_bench/tests``)."""
import json
import os
import subprocess
import sys

import pytest
import torch

from _tiny import ROOT


def _run(cell, seconds, env=None):
    return subprocess.run(
        [sys.executable, "coreg_bench/run.py", "--workload", cell, "--seed",
         "4000000001", "--seconds", str(seconds), "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, **(env or {})))


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    out = _run("helio_roll5d_k1", 1, env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["helio_roll5d_k1", "carr_coarse_k2",
                                  "helio_wide_roll_block"])
def test_a_short_run_on_the_card_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(cell, 5)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
