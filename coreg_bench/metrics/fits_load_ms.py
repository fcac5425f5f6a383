"""fits_load_ms: the program's stage ``api_fits_load_s`` (io/fits.py, on the
host; it ends with the arrays in memory), mean per traced file."""
from coreg_bench.metrics._stage import per_file_ms


def read(rec):
    return per_file_ms(rec, "api_fits_load_s")
