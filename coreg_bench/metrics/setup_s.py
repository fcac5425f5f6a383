"""setup_s: process start to the end of the warm-up call (host clock):
imports, the card, the kernels' build or load, the pairs rendered and
written, one call on the cell's shapes."""


def read(rec):
    return rec["run"]["setup_s"]
