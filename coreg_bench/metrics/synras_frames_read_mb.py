"""synras_frames_read_mb: the program's counter ``synras_frame_read_bytes``
(synras/map_builder.py: bytes of the imager frames' data units read from
disk) in MB, mean per traced file."""
from coreg_bench.metrics._span import counter_mb


def read(rec):
    return counter_mb(rec, "synras_frame_read_bytes")
