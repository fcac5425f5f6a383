"""iter_score_ms: the card extent of the program's span ``iter_score_s``
(hdrshift/alignment_spice.py: each chunk of composed rasters scored
against the raster, queued on the card), mean per traced file."""
from coreg_bench.metrics._span import card_ms


def read(rec):
    return card_ms(rec, "iter_score_s")
