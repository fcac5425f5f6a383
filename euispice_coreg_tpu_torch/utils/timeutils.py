"""FITS timestamp parsing and arithmetic without astropy.

The reference package uses ``astropy.time.Time`` for DATE-OBS/DATE-AVG
parsing and second-level differences (e.g.
``euispice_coreg/synras/map_builder.py:223-237``,
``rectify.py:416-418``).  Here timestamps are handled as UTC epoch seconds
(float, microsecond precision), which is sufficient: every consumer only ever
takes differences in seconds or re-renders the ISO string.
"""
from __future__ import annotations

import datetime as _dt
import re

_ISO_RE = re.compile(
    r"^(\d{4})-(\d{2})-(\d{2})"
    r"(?:[T ](\d{2}):(\d{2}):(\d{2})(?:\.(\d+))?)?$"
)

_EPOCH = _dt.datetime(2000, 1, 1, tzinfo=_dt.timezone.utc)


def parse_fits_time(value: str) -> float:
    """Parse a FITS ISO-8601 timestamp into seconds since 2000-01-01 UTC."""
    value = value.strip()
    # tolerate a trailing 'Z'
    if value.endswith("Z"):
        value = value[:-1]
    m = _ISO_RE.match(value)
    if not m:
        raise ValueError(f"unparsable FITS timestamp: {value!r}")
    y, mo, d = int(m[1]), int(m[2]), int(m[3])
    hh = int(m[4] or 0)
    mm = int(m[5] or 0)
    ss = int(m[6] or 0)
    frac = m[7] or ""
    micro = int(round(float("0." + frac) * 1e6)) if frac else 0
    t = _dt.datetime(y, mo, d, hh, mm, ss, micro, tzinfo=_dt.timezone.utc)
    return (t - _EPOCH).total_seconds()


def format_fits_time(seconds: float, ndecimals: int = 3) -> str:
    """Render epoch seconds (since 2000-01-01 UTC) as a FITS ISO string."""
    t = _EPOCH + _dt.timedelta(seconds=float(seconds))
    base = t.strftime("%Y-%m-%dT%H:%M:%S")
    if ndecimals > 0:
        frac = t.microsecond / 1e6
        digits = f"{frac:.{ndecimals}f}"[2:]
        return f"{base}.{digits}"
    return base


def time_diff_seconds(a: str, b: str) -> float:
    """(a - b) in seconds, both FITS ISO strings."""
    return parse_fits_time(a) - parse_fits_time(b)


def time_diff_days(a: str, b: str) -> float:
    return time_diff_seconds(a, b) / 86400.0
