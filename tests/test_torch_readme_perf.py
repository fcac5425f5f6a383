"""The port's README figures (``tools/gen_readme_perf_torch.py``).

The block between the ``perf_torch:`` markers in README.md is generated
from the recorded ``bench_torch.py`` runs on a card
(``tools/bench_runs_torch.jsonl``).  These tests hold the committed block
to the recorded runs, and the generator to its rules on synthetic runs in
a temporary root: failed legs lose their figures, a run whose core leg
failed is dropped, a line without a card is refused, cards are never
mixed in one range, and the TPU runs are never read.  The generator
imports only the standard library."""
import copy
import importlib.util
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "gen_readme_perf_torch.py")
RUNS = os.path.join(REPO, "tools", "bench_runs_torch.jsonl")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


gen = _load(TOOL, "gen_readme_perf_torch")

README = ("# title\n\nintro\n\n" + gen.BEGIN + "\n" + gen.END
          + "\n\nrest\n")
H100 = {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0, "count": 1}


def recorded_line():
    """The first recorded run: the synthetic runs are edits of it."""
    with open(RUNS) as f:
        return json.loads(next(line for line in f if line.strip()))


def run_line(core=0.05, device=H100, leg_errors=None, **seconds):
    """A bench line (the recorded one's keys) with the core leg at
    ``core`` s and other legs' seconds by metric key."""
    run = copy.deepcopy(recorded_line())
    run.update(wall_clock_s=core, value=round(121 * 121 / core, 2),
               device=device, leg_errors=leg_errors, **seconds)
    return json.dumps(run)


def make_root(tmp_path, lines):
    (tmp_path / "tools").mkdir()
    (tmp_path / "tools" / "bench_runs_torch.jsonl").write_text(
        "".join(line + "\n" for line in lines))
    (tmp_path / "README.md").write_text(README)
    return tmp_path


def block(root):
    """The generated block of ``root``'s README (after a rewrite)."""
    assert gen.main(["--root", str(root)]) == 0
    text = (root / "README.md").read_text()
    return text[text.index(gen.BEGIN):text.index(gen.END)]


_RUN_TOOL = """
import json, os, runpy, sys
root, tool = {root!r}, {tool!r}
opened = set()
def hook(event, args):
    if event == "open" and isinstance(args[0], str):
        opened.add(os.path.abspath(args[0]))
sys.addaudithook(hook)
sys.argv = [tool, "--check", "--root", root]
try:
    runpy.run_path(tool, run_name="__main__")
    code = 0
except SystemExit as exc:
    code = exc.code
print(json.dumps({{
    "code": code,
    "read": sorted(os.path.relpath(p, root) for p in opened
                   if p.startswith(root + os.sep) and p != tool),
    "modules": sorted(k for k in sys.modules if k.split(".")[0] in (
        "jax", "jaxlib", "euispice_coreg_tpu", "euispice_coreg_tpu_torch",
        "torch", "numpy"))}}))
"""


def run_tool(root):
    """``--check`` on ``root`` in a fresh interpreter: its exit code, the
    files under ``root`` it opened and the heavy modules it loaded."""
    code = _RUN_TOOL.format(root=str(root), tool=TOOL)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_readme_block_fresh_and_stdlib_only():
    """``--check`` passes on the repository, reading nothing but the runs
    file and README.md, with no JAX, torch, numpy or package loaded."""
    got = run_tool(REPO)
    assert got == {"code": 0, "modules": [],
                   "read": ["README.md",
                            os.path.join("tools", "bench_runs_torch.jsonl")]}


def test_recorded_runs_name_their_card():
    """Every recorded line names a card, and the block states each card
    with its power limit as nvidia-smi prints them."""
    runs = gen.load_runs(REPO)
    assert len(runs) >= 3
    with open(os.path.join(REPO, "README.md")) as f:
        text = f.read()
    for card, _run in runs:
        name, power = card
        assert f"**{name}, {power:.2f} W**" in text


def test_tpu_runs_are_not_read(tmp_path):
    """A ``BENCH_r01.json`` and a ``tools/bench_runs.jsonl`` in the root
    (the TPU runs) are never opened nor shown."""
    root = make_root(tmp_path, [run_line(0.05)])
    tpu = dict(json.loads(run_line(0.0123)),
               device={"name": "TPU v5e", "power_limit_w": 1.0})
    (root / "BENCH_r01.json").write_text(json.dumps({"parsed": tpu}))
    (root / "tools" / "bench_runs.jsonl").write_text(json.dumps(tpu) + "\n")
    got = run_tool(root)
    assert got["code"] == 1  # the README has an empty block: stale
    assert got["read"] == ["README.md",
                           os.path.join("tools", "bench_runs_torch.jsonl")]
    text = block(root)
    assert "0.0123" not in text and "TPU" not in text
    assert "0.0500" in text


def test_failed_leg_loses_its_figures(tmp_path):
    root = make_root(tmp_path, [
        run_line(0.05, leg_errors={"mixed": "mixed argmax: 3.0"},
                 mixed_grid_21x21x3_2048_s=9.8765),
        run_line(0.06, mixed_grid_21x21x3_2048_s=0.1234),
    ])
    text = block(root)
    assert "9.8765" not in text
    row = next(ln for ln in text.splitlines() if ln.startswith("| mixed |"))
    assert "| 0.1234 (1 run left out: recovery failed) |" in row
    assert "| 0.0500-0.0600 |" in text  # the core leg keeps both runs


def test_failed_core_drops_the_run(tmp_path):
    root = make_root(tmp_path, [
        run_line(0.0777, leg_errors={"core": "argmax off: 3.5"},
                 end_to_end_api_s=5.4321),
        run_line(0.05),
    ])
    text = block(root)
    assert "0.0777" not in text and "5.4321" not in text
    assert "1 recorded run of" in text
    assert "(1 more dropped: the core leg failed its recovery check)" in text


@pytest.mark.parametrize("device", [
    dict(H100, power_limit_w=None),
    dict(H100, power_limit_w=0),
    {"name": "cpu", "power_limit_w": None, "count": 0},
    {"name": "", "power_limit_w": 700.0, "count": 1},
    None,
])
def test_line_without_a_card_is_refused(tmp_path, capsys, device):
    """The tool exits nonzero, naming the line, and writes nothing."""
    root = make_root(tmp_path, [run_line(0.05), run_line(0.06, device=device)])
    assert gen.main(["--root", str(root)]) != 0
    err = capsys.readouterr().err
    assert "tools/bench_runs_torch.jsonl:2" in err.replace(os.sep, "/")
    assert "names no card" in err
    assert (root / "README.md").read_text() == README


def test_line_missing_a_key_is_refused(tmp_path, capsys):
    run = json.loads(run_line(0.05))
    del run["launches"]
    root = make_root(tmp_path, [json.dumps(run)])
    assert gen.main(["--root", str(root), "--check"]) != 0
    assert "bench_runs_torch.jsonl:1: no launches" in \
        capsys.readouterr().err.replace(os.sep, "/")


def test_two_cards_two_groups(tmp_path):
    """Runs on two cards (one name at two power limits) give two headed
    groups, each range over its own card's runs only."""
    capped = dict(H100, power_limit_w=500.0)
    root = make_root(tmp_path, [run_line(0.05), run_line(0.09, capped),
                                run_line(0.06)])
    text = block(root)
    first = text.index("**NVIDIA H100 80GB HBM3, 700.00 W**: 2 recorded runs")
    second = text.index("**NVIDIA H100 80GB HBM3, 500.00 W**: 1 recorded run ")
    assert first < second
    assert "| 0.0500-0.0600 |" in text[first:second]
    assert "| 0.0900 |" in text[second:]
    assert "0.0500-0.0900" not in text and "0.0600-0.0900" not in text


def test_spread_over_2x_calls_out_the_latest_run(tmp_path):
    root = make_root(tmp_path, [run_line(0.05), run_line(0.2),
                                run_line(0.07)])
    assert "| 0.0500-0.2000 (latest run 0.0700) |" in block(root)


def test_check_reports_a_stale_block_without_writing(tmp_path):
    root = make_root(tmp_path, [run_line(0.05)])
    assert gen.main(["--root", str(root), "--check"]) == 1
    assert (root / "README.md").read_text() == README
    block(root)
    assert gen.main(["--root", str(root), "--check"]) == 0


def test_markers_apart_from_the_tpu_tool():
    """Neither tool's marker pattern finds the other's block."""
    tpu = _load(os.path.join(REPO, "tools", "gen_readme_perf.py"),
                "gen_readme_perf")
    with pytest.raises(SystemExit):
        tpu.splice(README, "headline", "x")
    tpu_text = "<!-- perf:headline begin -->\n<!-- perf:headline end -->\n"
    with pytest.raises(SystemExit):
        gen.splice(tpu_text, "x")
    assert "perf:" not in gen.BEGIN + gen.END
