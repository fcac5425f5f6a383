"""synras_frames_load_ms: the program's span ``synras_frames_load_s``
(synras/map_builder.py: an imager frame read from its file and moved to
the card, on the host), mean per traced file."""
from coreg_bench.metrics._stage import per_file_ms


def read(rec):
    return per_file_ms(rec, "synras_frames_load_s")
