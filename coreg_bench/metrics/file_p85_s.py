"""file_p85_s: the 85th percentile of the per-file wall time, FITS load to
corrected header on the host, over every file of the window (host clock).
The 85th is the highest percentile with ten files beyond it in a 51-s
window of the slowest cell (about 83 files)."""
import numpy as np


def read(rec):
    t = rec["run"]["file_seconds"]
    return float(np.percentile(t, 85)) if t else None
