"""Minimal angular-unit conversion helpers.

The reference package leans on ``astropy.units`` for converting lag arrays and
header values between arcsec/deg/rad (e.g. ``u.Quantity(...).to(...)`` in
``euispice_coreg/utils/Util.py:163-215``).  astropy is not a
dependency of this framework; all angle bookkeeping is done with plain floats
in the unit recorded next to them, converted through this module.

Only angular units are needed anywhere in the pipeline.
"""
from __future__ import annotations

import numpy as np

# conversion factor: unit -> degrees
_TO_DEG = {
    "deg": 1.0,
    "degree": 1.0,
    "degrees": 1.0,
    "arcmin": 1.0 / 60.0,
    "arcsec": 1.0 / 3600.0,
    "mas": 1.0 / 3_600_000.0,
    "rad": 180.0 / np.pi,
    "radian": 180.0 / np.pi,
}


def _factor(unit: str) -> float:
    try:
        return _TO_DEG[unit.strip().lower()]
    except KeyError:
        raise ValueError(f"unsupported angular unit: {unit!r}") from None


def convert(value, from_unit: str, to_unit: str):
    """Convert ``value`` (scalar or ndarray) between angular units."""
    if from_unit == to_unit:
        return value
    f = _factor(from_unit) / _factor(to_unit)
    return value * f


def to_deg(value, unit: str):
    return convert(value, unit, "deg")


def from_deg(value, unit: str):
    return convert(value, "deg", unit)


def ang2pipi_deg(ang_deg):
    """Wrap an angle in degrees into ]-180, +180].

    Port of the semantics of ``AlignCommonUtil.ang2pipi``
    (``euispice_coreg/utils/Util.py:76-80``):
    ``-((-ang + 180) % 360 - 180)``.
    """
    return -((-np.asarray(ang_deg) + 180.0) % 360.0 - 180.0)


def ang2pipi(value, unit: str):
    """Wrap into ]-180, 180] deg, expressed in ``unit``."""
    return from_deg(ang2pipi_deg(to_deg(value, unit)), unit)
