"""k2_roofline: K2's (csrc/quad_score.cu) share of its roofline bound in %,
the bound from coreg_bench/roofline.py on counts the benchmark works out
itself, over the profiler's kernel time per launch."""
from coreg_bench.metrics._kernel import share


def read(rec):
    return share(rec, "K2", "K2", "quad_score", "warp_score")
