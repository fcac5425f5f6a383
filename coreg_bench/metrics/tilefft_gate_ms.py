"""tilefft_gate_ms: the program's stage ``carr_tilefft_gate_s`` (tile-FFT's
gate and tile picker, on the host), mean per traced file."""
from coreg_bench.metrics._stage import per_file_ms


def read(rec):
    return per_file_ms(rec, "carr_tilefft_gate_s")
