"""Shared by the roofline readers: a kernel's measured milliseconds per
launch from the profiler's table, and its share of the bound."""
from coreg_bench import roofline

REDUCE = "reduce_partials"


def share(rec, kernel, launch_key, name_part, other_part):
    """``kernel``'s share of its bound in %, or None where it did not run.
    Its time is its own kernel's plus the partial-sum reduction that
    follows each launch, when no other kernel shares that reduction."""
    n = rec["launches"].get(launch_key, 0)
    table = rec["kernels"]
    own = sum(v["seconds"] for k, v in table.items() if name_part in k)
    if n <= 0 or own <= 0:
        return None
    if not any(other_part in k for k in table):
        own += sum(v["seconds"] for k, v in table.items() if REDUCE in k)
    counts = rec["counts"](kernel)
    if counts is None:
        return None
    return roofline.share_percent(kernel, counts, 1e3 * own / n)
