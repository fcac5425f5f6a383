"""file_p85_s.fft_routes: file_p85_s read in the traced run, for the cells
whose routes leave the card idle for much of a file (the host sets the
pace there, so its tail is no end-to-end bound)."""
from coreg_bench.metrics.file_p85_s import read  # noqa: F401
