"""synras_compose_ms: the card extent of the program's span
``synras_compose_s`` (synras/map_builder.py: one imager frame sampled at
its raster columns, for one header or for every lag of a chunk), summed
over the frames, mean per traced file."""
from coreg_bench.metrics._span import card_ms


def read(rec):
    return card_ms(rec, "synras_compose_s")
