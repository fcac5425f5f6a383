"""Shared by the stage readers: a program stage's mean milliseconds per
traced file, or None where the stage did not run."""


def per_file_ms(rec, label):
    s = rec["stages"].get(label)
    if s is None or not rec["files"]:
        return None
    return 1e3 * s / rec["files"]
