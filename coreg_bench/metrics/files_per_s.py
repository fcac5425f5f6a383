"""files_per_s: files completed in the window over the window's seconds
(host clock; the window closes when its last file ends)."""


def read(rec):
    run = rec["run"]
    if run["window_s"] <= 0:
        return None
    return run["completed"] / run["window_s"]
