"""block_surfaces_ms: the program's stage ``fast_surfaces_s`` (the block
path's cuFFT correlation surfaces; it ends with a sync), mean per traced
file."""
from coreg_bench.metrics._stage import per_file_ms


def read(rec):
    return per_file_ms(rec, "fast_surfaces_s")
