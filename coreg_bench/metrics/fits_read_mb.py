"""fits_read_mb: the program's counter ``fits_read_bytes`` (io/fits.open:
bytes read from disk) in MB, mean per traced file."""
from coreg_bench.metrics._span import counter_mb


def read(rec):
    return counter_mb(rec, "fits_read_bytes")
