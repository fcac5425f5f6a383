#!/usr/bin/env python3
"""Run one cell of the benchmark of euispice_coreg_tpu_torch once.

    python3 coreg_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the run's lines, then one JSON object as the last line of standard
output; the numbers the judgement compared, each beside its limit, are the
last lines of standard error.  Exits without a result unless the cell's
CUDA cards are there.  See coreg_bench/README.md.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's and the benchmark's caches stay inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
sys.path[0] = ROOT

from coreg_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
