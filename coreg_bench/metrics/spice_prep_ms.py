"""spice_prep_ms: the program's span ``spice_load_prep_s``
(hdrshift/alignment_spice.py: the L2 raster read, its window summed over
wavelength and its dumbbells left out, on the host), mean per traced
file."""
from coreg_bench.metrics._stage import per_file_ms


def read(rec):
    return per_file_ms(rec, "spice_load_prep_s")
