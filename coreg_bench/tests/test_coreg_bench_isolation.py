"""What the benchmark may import: no JAX and no JAX package anywhere in it,
nothing of the program in its reference, none of the repo's other benches,
examples or tests."""
import ast
import os
import subprocess
import sys

import pytest

from _tiny import ROOT

BENCH_DIR = os.path.join(ROOT, "coreg_bench")
NEVER = {"jax", "jaxlib", "flax", "euispice_coreg_tpu", "bench",
         "bench_torch", "chip_smoke", "examples", "tests"}


def _sources():
    for d, _, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_source_imports_what_it_must_not(path):
    assert not set(_imports(path)) & NEVER
    if os.sep + "reference" + os.sep in path:
        assert "euispice_coreg_tpu_torch" not in set(_imports(path))


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in "
                          "sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    return set(out.stdout.split())


def test_the_harness_loads_no_jax_and_no_jax_package():
    loaded = _loaded("import coreg_bench.harness, coreg_bench.control\n"
                     "from coreg_bench import discover\n"
                     "import euispice_coreg_tpu_torch.hdrshift\n"
                     "for m in discover.benchmark()['per_layer'] + "
                     "discover.benchmark()['end_to_end']:\n"
                     "    discover.reader(m['name'])")
    assert "coreg_bench" in loaded and "euispice_coreg_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "euispice_coreg_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("import coreg_bench.reference.hypercube, "
                     "coreg_bench.reference.judge, coreg_bench.inputs, "
                     "coreg_bench.roofline, coreg_bench.frames.carrington, "
                     "coreg_bench.frames.helioprojective")
    assert not loaded & {"jax", "jaxlib", "flax", "euispice_coreg_tpu",
                         "euispice_coreg_tpu_torch"}
