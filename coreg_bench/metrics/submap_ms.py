"""submap_ms: the card extent of the program's span ``api_submap_s``
(lag_search.prepare_grid_and_submap: the comparison grid and the reference
resampled onto it, queued on the card), mean per traced file."""
from coreg_bench.metrics._span import card_ms


def read(rec):
    return card_ms(rec, "api_submap_s")
