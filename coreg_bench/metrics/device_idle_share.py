"""device_idle_share: the share, in %, of the traced stretch in which no
kernel, copy or set ran on the card (torch.profiler's device events)."""


def read(rec):
    if rec["window_s"] <= 0 or rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
