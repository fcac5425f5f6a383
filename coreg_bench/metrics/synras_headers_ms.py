"""synras_headers_ms: the program's span ``synras_headers_s``
(synras/map_builder.py: the composed rasters' headers, one per lag in the
iterative search, on the host), mean per traced file."""
from coreg_bench.metrics._stage import per_file_ms


def read(rec):
    return per_file_ms(rec, "synras_headers_s")
