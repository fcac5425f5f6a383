"""k1_roofline.spice: K1's (csrc/warp_score.cu) share of its roofline bound
in %, on the SPICE raster's 1024 x 192 grid at CDELT1 != CDELT2: the bound
from coreg_bench/roofline.py on counts the benchmark works out itself,
over the profiler's kernel time per launch."""
from coreg_bench.metrics._kernel import share


def read(rec):
    return share(rec, "K1 tan", "K1", "warp_score", "quad_score")
