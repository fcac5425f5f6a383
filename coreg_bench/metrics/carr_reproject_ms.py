"""carr_reproject_ms: the card extent of the program's span
``carr_api_reproject_s`` (the reference reprojected onto the Carrington
grid, queued on the card), mean per traced file."""
from coreg_bench.metrics._span import card_ms


def read(rec):
    return card_ms(rec, "carr_api_reproject_s")
