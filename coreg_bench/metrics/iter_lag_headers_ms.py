"""iter_lag_headers_ms: the program's span ``iter_lag_headers_s``
(hdrshift/alignment_spice.py: each chunk's lag headers shifted, on the
host), mean per traced file."""
from coreg_bench.metrics._stage import per_file_ms


def read(rec):
    return per_file_ms(rec, "iter_lag_headers_s")
