"""corrected_header_ms: the program's span ``api_corrected_header_s``
(AlignmentResults.return_corrected_header: the small file read again and
its header corrected, on the host), mean per traced file."""
from coreg_bench.metrics._stage import per_file_ms


def read(rec):
    return per_file_ms(rec, "api_corrected_header_s")
