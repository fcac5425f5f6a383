"""align_untraced_ms: the self time of the program's span ``api_align_s``
(the body of ``align_using_*``): its duration less what its child spans
cover, mean per traced file.  What the program's spans leave unnamed."""
from coreg_bench.metrics._span import self_ms


def read(rec):
    return self_ms(rec, "api_align_s")
