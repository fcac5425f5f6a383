#!/usr/bin/env python
"""Regenerate the port's README figures from recorded ``bench_torch.py`` runs.

Source: ``tools/bench_runs_torch.jsonl``, one JSON line per standalone
``python3 bench_torch.py`` run on a card, copied exactly as the bench
printed it (append with
``python3 bench_torch.py | tee -a tools/bench_runs_torch.jsonl``).  The TPU
runs (``BENCH_r*.json``, ``tools/bench_runs.jsonl``) are never read: they
belong to ``tools/gen_readme_perf.py``.

The script rewrites the text between ``<!-- perf_torch:headline begin -->``
and ``<!-- perf_torch:headline end -->`` in README.md.  Runs are grouped by
card, (``device.name``, ``device.power_limit_w``); each group's heading
names its card, and every range spans all of that card's runs and no
other card's.  A line without a card (no name, the CPU, no power limit or
a limit of 0) is refused, naming the line; so is a line that is not a JSON
object or lacks a key the block reads.  A leg listed in ``leg_errors``
loses its figures, and a run whose core leg failed is dropped, as in
``tools/gen_readme_perf.py``.

Usage: ``python tools/gen_readme_perf_torch.py [--check] [--root DIR]``
  --check: exit 1 if README.md is stale instead of rewriting it.
  --root:  the repository root to read and write (default: this checkout).

Imports only the standard library.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS_FILE = os.path.join("tools", "bench_runs_torch.jsonl")
BEGIN = "<!-- perf_torch:headline begin -->"
END = "<!-- perf_torch:headline end -->"

# leg_errors key (bench_torch.py, bench.py's leg names) -> the metric keys
# that leg produced.  A leg whose recovery check failed keeps its seconds in
# the recorded line but is not shown as a measured figure.
_LEG_METRICS = {
    "core": ("wall_clock_s", "value", "vs_baseline"),
    "api": ("end_to_end_api_s",),
    "carr": ("carrington_121x121_2048_s",),
    "carr_api": ("carrington_api_s",),
    "carr_coarse": ("carrington_coarse_121x121_s",),
    "mixed": ("mixed_grid_21x21x3_2048_s",),
    "synras": ("synras_spice_e2e_s",),
    "iterative": ("iterative_spice_5x5_s",),
}

# leg -> what it runs, as the block describes it
_LEG_TEXT = {
    "core": "121x121 CRVAL grid on a 2048x2048 pair, engine call",
    "api": "the same grid through Alignment: FITS -> results",
    "carr": "Carrington-frame 121x121 grid on a 2048x2048 grid, engine call",
    "carr_api": "the same through align_using_carrington",
    "carr_coarse": "coarse +-120\" Carrington 121x121 grid, +24\" recovered",
    "mixed": "21x21 CRVAL x 3 CROTA grid on the block path",
    "synras": "synthetic raster built, then a SPICE cube aligned",
    "iterative": "iterative SPICE context raster, 5x5 grid",
}

# every key the block reads; a line without one of them is refused
REQUIRED_KEYS = (*dict.fromkeys(k for ks in _LEG_METRICS.values() for k in ks),
                 "cpu_baseline_s_20core_est", "host_cpu", "leg_errors",
                 "launches", "device")


class RunRefused(ValueError):
    """A recorded line the block cannot stand on: not a bench JSON object,
    a key missing, or no card named."""


def card_of(run: dict):
    """(name, power limit in W) of the card a run names, or None when it
    names none: no name, the CPU, or no positive power limit."""
    dev = run.get("device")
    if not isinstance(dev, dict):
        return None
    name, power = dev.get("name"), dev.get("power_limit_w")
    if not isinstance(name, str) or not name or name.split(":")[0] == "cpu":
        return None
    if isinstance(power, bool) or not isinstance(power, (int, float)) \
            or not power > 0:
        return None
    return name, float(power)


def parse_run(line: str, where: str) -> dict:
    """One recorded bench line as a dict; raises RunRefused, naming
    ``where``, for a line the block cannot stand on."""
    try:
        run = json.loads(line)
    except ValueError as exc:
        raise RunRefused(f"{where}: not JSON ({exc})") from None
    if not isinstance(run, dict):
        raise RunRefused(f"{where}: not a JSON object")
    missing = [k for k in REQUIRED_KEYS if k not in run]
    if missing:
        raise RunRefused(f"{where}: no {', '.join(missing)}")
    if card_of(run) is None:
        raise RunRefused(f"{where}: names no card (device {run['device']!r}; "
                         "a name other than the CPU and a power limit "
                         "above 0 W are required)")
    return run


def mask_failed_legs(run: dict) -> dict | None:
    """Null out the metrics of legs whose recovery failed (or that raised);
    None when the core leg failed (the headline figure is meaningless
    then)."""
    errs = run.get("leg_errors") or {}
    if not errs:
        return run
    run = dict(run)
    for leg in errs:
        for key in _LEG_METRICS.get(leg, ()):
            run[key] = None
    if run.get("wall_clock_s") is None:
        return None
    return run


def load_runs(root: str):
    """Every recorded run in file order as (card, run): the run masked by
    :func:`mask_failed_legs`, None where its core leg failed.  Raises
    RunRefused on a bad line and SystemExit on a file with no run."""
    path = os.path.join(root, RUNS_FILE)
    runs = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            if line.strip():
                run = parse_run(line, f"{RUNS_FILE}:{lineno}")
                runs.append((card_of(run), mask_failed_legs(run)))
    if not runs:
        raise SystemExit(f"no bench_torch.py run in {RUNS_FILE}")
    return runs


def rng(runs, key, fmt="{:.4f}"):
    """Range string spanning every run; when the spread exceeds 2x, the
    latest run is called out.  None when no run has the key."""
    vals = [r[key] for r in runs if r.get(key) is not None]
    if not vals:
        return None
    lo, hi = min(vals), max(vals)
    slo, shi = fmt.format(lo), fmt.format(hi)
    s = slo if slo == shi else f"{slo}-{shi}"
    if lo > 0 and hi / lo > 2.0:
        s += f" (latest run {fmt.format(vals[-1])})"
    return s


def _launches(run, leg, kid):
    """Kernel ``kid``'s launches in the best run of ``leg`` (None where the
    leg raised)."""
    return ((run["launches"] or {}).get(leg) or {}).get(kid)


def _launch_text(runs, leg):
    """'K1 a-b / K2 c-d' over the runs' best-run launches of one leg."""
    parts = []
    for kid in ("K1", "K2"):
        vals = [v for v in (_launches(r, leg, kid) for r in runs)
                if v is not None]
        if not vals:
            parts.append(f"{kid} -")
        else:
            lo, hi = min(vals), max(vals)
            parts.append(f"{kid} {lo}" if lo == hi else f"{kid} {lo}-{hi}")
    return " / ".join(parts)


def _launched_in(runs, kid):
    """The legs in which kernel ``kid`` launched in any run's best run."""
    return [leg for leg in _LEG_METRICS
            if any(_launches(r, leg, kid) for r in runs)]


def _host_text(runs):
    """The host CPUs the runs name, each once."""
    hosts = dict.fromkeys(
        f"model {(r['host_cpu'] or {}).get('model')!r}, "
        f"{(r['host_cpu'] or {}).get('count')} logical CPUs" for r in runs)
    return "; ".join(hosts) or "not reported"


def card_block(card, runs, dropped):
    """The block's text for one card's runs."""
    name, power = card
    n = len(runs)
    head = (f"**{name}, {power:.2f} W**: {n} recorded run"
            f"{'s' if n != 1 else ''} of `python3 bench_torch.py`")
    if dropped:
        head += (f" ({dropped} more dropped: the core leg failed its "
                 "recovery check)")
    head += (f"; host CPU {_host_text(runs)}. Each leg warms once, then "
             "keeps the best of 2 timed runs, each ending with the "
             "hypercube on the host; each range spans every run on this "
             "card.")
    rows = ["| Leg | What it runs | Seconds | Launches in the best run |",
            "|---|---|---|---|"]
    for leg, keys in _LEG_METRICS.items():
        seconds = rng(runs, keys[0])
        if seconds is None:
            seconds = "no valid run"
        masked = sum(1 for r in runs if leg in (r.get("leg_errors") or {}))
        if masked:
            seconds += (f" ({masked} run{'s' if masked != 1 else ''} left "
                        "out: recovery failed)")
        rows.append(f"| {leg} | {_LEG_TEXT[leg]} | {seconds} | "
                    f"{_launch_text(runs, leg)} |")
    value = rng(runs, "value", "{:,.0f}")
    speedup = rng(runs, "vs_baseline", "{:,.0f}")
    cpu = rng(runs, "cpu_baseline_s_20core_est", "{:.2f}")
    k1 = _launched_in(runs, "K1")
    k2 = _launched_in(runs, "K2")
    facts = [
        f"- `value`: {value or 'no valid run'} lag evaluations/s (121x121 "
        "lags over the core leg's seconds).",
        f"- `vs_baseline`: {speedup or 'no valid run'}x the host per-lag "
        "reference x 20 cores on that machine's CPU (one lag of scipy's "
        "order-2 warp and a numpy Pearson, timed there, x 121x121 lags / "
        f"20: {cpu or 'no valid run'} s).",
        "- Kernels: K1 (`warp_score`) launched in "
        + (", ".join(k1) if k1 else "no leg") + "; K2 (`quad_score`) in "
        + (", ".join(k2) if k2 else "no leg") + ".",
    ]
    return "\n".join([head, "", *rows, "", *facts])


def build_block(runs):
    """The whole generated block from :func:`load_runs`' list: one section
    per card, in the order the cards first appear."""
    groups = {}
    for card, run in runs:
        groups.setdefault(card, []).append(run)
    return "\n\n".join(
        card_block(card, [r for r in group if r is not None],
                   sum(r is None for r in group))
        for card, group in groups.items())


def splice(text, payload):
    pat = re.compile(re.escape(BEGIN) + r".*?" + re.escape(END), re.S)
    if not pat.search(text):
        raise SystemExit(f"README.md is missing the {BEGIN} markers")
    return pat.sub(lambda _m: BEGIN + "\n" + payload + "\n" + END, text)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--check", action="store_true",
                   help="exit 1 if README.md is stale instead of rewriting it")
    p.add_argument("--root", default=ROOT,
                   help="repository root (default: this checkout)")
    args = p.parse_args(argv)
    try:
        runs = load_runs(args.root)
    except RunRefused as exc:
        print(f"refused: {exc}", file=sys.stderr)
        return 2
    readme = os.path.join(args.root, "README.md")
    with open(readme) as f:
        text = f.read()
    new = splice(text, build_block(runs))
    if args.check:
        if new != text:
            print("README.md perf_torch block is stale; run "
                  "tools/gen_readme_perf_torch.py")
            return 1
        print("README.md perf_torch block up to date")
        return 0
    if new != text:
        with open(readme, "w") as f:
            f.write(new)
        print(f"README.md perf_torch block regenerated from {len(runs)} runs")
    else:
        print("README.md perf_torch block already up to date")
    return 0


if __name__ == "__main__":
    sys.exit(main())
