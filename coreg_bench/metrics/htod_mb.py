"""htod_mb: the program's counter ``htod_bytes`` (utils/torchcfg.to_tensor:
bytes copied from the host to the card) in MB, mean per traced file."""
from coreg_bench.metrics._span import counter_mb


def read(rec):
    return counter_mb(rec, "htod_bytes")
