"""fit_ms: the program's span ``api_fit_s`` (AlignmentResults: the
hypercube's argmax and the Gaussian fit of its peak, on the host), mean per
traced file."""
from coreg_bench.metrics._stage import per_file_ms


def read(rec):
    return per_file_ms(rec, "api_fit_s")
