"""block_warp_ms: the card extent of the program's span ``block_warp_s``
(the block path's warp of the small image, one per cdelt/crota combo),
summed over the combos, mean per traced file."""
from coreg_bench.metrics._span import card_ms


def read(rec):
    return card_ms(rec, "block_warp_s")
