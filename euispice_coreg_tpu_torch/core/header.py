"""FITS header container and host-side pointing/header math.

astropy is not a dependency of this framework, so headers are represented by
:class:`Header`, a thin ordered mapping with FITS-like key semantics, and all
header math (PC/CROTA reconciliation, pointing shifts) is implemented here in
float64 numpy.

Reference semantics reimplemented (not copied) from
``euispice_coreg/hdrshift/alignment.py:580-611`` (PC creation)
and ``euispice_coreg/utils/Util.py:163-245``
(``correct_pointing_header``).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

from ..utils import units


class Header:
    """Ordered, case-insensitive (uppercased) FITS-like header mapping."""

    def __init__(self, cards=None):
        self._cards: dict[str, object] = {}
        self._comments: dict[str, str] = {}
        if cards is not None:
            if isinstance(cards, Header):
                self._cards = dict(cards._cards)
                self._comments = dict(cards._comments)
            elif isinstance(cards, dict):
                for k, v in cards.items():
                    self[k] = v
            else:  # iterable of (key, value) or (key, value, comment)
                for item in cards:
                    if len(item) == 3:
                        k, v, c = item
                        self[k] = v
                        self._comments[self._norm(k)] = c
                    else:
                        k, v = item
                        self[k] = v

    @staticmethod
    def _norm(key: str) -> str:
        return str(key).strip().upper()

    def __getitem__(self, key):
        return self._cards[self._norm(key)]

    def __setitem__(self, key, value):
        self._cards[self._norm(key)] = value

    def __delitem__(self, key):
        del self._cards[self._norm(key)]

    def __contains__(self, key):
        return self._norm(key) in self._cards

    def __iter__(self):
        return iter(self._cards)

    def __len__(self):
        return len(self._cards)

    def __eq__(self, other):
        if not isinstance(other, Header):
            return NotImplemented
        return self._cards == other._cards

    def get(self, key, default=None):
        return self._cards.get(self._norm(key), default)

    def keys(self):
        return self._cards.keys()

    def items(self):
        return self._cards.items()

    def values(self):
        return self._cards.values()

    def pop(self, key, *default):
        return self._cards.pop(self._norm(key), *default)

    def setdefault(self, key, value):
        return self._cards.setdefault(self._norm(key), value)

    def update(self, other):
        items = other.items() if hasattr(other, "items") else other
        for k, v in items:
            self[k] = v

    def copy(self) -> "Header":
        return Header(self)

    def comment(self, key) -> str:
        return self._comments.get(self._norm(key), "")

    def set_comment(self, key, comment: str):
        self._comments[self._norm(key)] = comment

    def __repr__(self):
        inner = ", ".join(f"{k}={v!r}" for k, v in self._cards.items())
        return f"Header({inner})"


# ---------------------------------------------------------------------------
# PC / CROTA reconciliation
# ---------------------------------------------------------------------------

def pc_from_crota(crota_deg: float, cdelt1: float, cdelt2: float):
    """PCi_j matrix encoding a CROTA rotation (FITS paper II convention).

    Matches the construction used throughout the reference
    (``alignment.py:462-468``, ``Util.py:209-215``):
    ``PC = [[cos r, -lam sin r], [sin r / lam, cos r]]`` with
    ``lam = CDELT2 / CDELT1``.
    """
    rho = np.deg2rad(crota_deg)
    lam = cdelt2 / cdelt1
    return (
        float(np.cos(rho)),
        float(-lam * np.sin(rho)),
        float(np.sin(rho) / lam),
        float(np.cos(rho)),
    )


def crota_from_pc(pc11: float, pc12: float) -> float:
    """Derive CROTA from PC1_1/PC1_2 the way the reference does.

    ``crota = sign * rad2deg(arccos(PC1_1))`` with
    ``sign = -sign(PC1_2) + (PC1_2 == 0)`` (``alignment.py:609-611``).
    """
    s = -np.sign(pc12) + (pc12 == 0.0)
    return float(s * np.rad2deg(np.arccos(np.clip(pc11, -1.0, 1.0))))


def ensure_pcij(hdr: Header, force_crota_0: bool = False):
    """Guarantee the header carries a PCi_j matrix and a CROTA keyword.

    Behavioural port of ``Alignment._check_ant_create_pcij_matrix``
    (``alignment.py:580-611``), including the PC1_1 >= 1 clamp.  Extension:
    CDi_j-matrix headers are first normalized to CDELT + PCi_j
    (CDi_j = CDELTi * PCi_j, Calabretta & Greisen 2002 eq. 1) — astropy
    accepts them for coordinates in the reference stack, but the reference's
    own shift path reads CDELT directly and would crash.
    """
    if "PC1_1" not in hdr and "CD1_1" in hdr and "CD2_2" in hdr:
        import math

        cd11 = float(hdr["CD1_1"])
        cd12 = float(hdr.get("CD1_2", 0.0))
        cd21 = float(hdr.get("CD2_1", 0.0))
        cd22 = float(hdr["CD2_2"])
        # the PCi_j/CROTA convention used throughout (pc_from_crota; refer-
        # ence Util.py:217-245) gives CD = [[c1 cos, -c2 sin], [c1 sin,
        # c2 cos]], so the CDELTs are the COLUMN norms of CD
        cdelt1 = math.hypot(cd11, cd21)
        cdelt2 = math.hypot(cd12, cd22)
        if cdelt1 > 0 and cdelt2 > 0:
            crota = math.degrees(math.atan2(cd21, cd11))
            # the EXACT decomposition PC = diag(1/CDELT) * CD is always
            # stored (correct for every flow that keeps PC verbatim — i.e.
            # all CRVAL-only searches and every reference-header use); CROTA
            # is only a faithful summary when the CD actually has the AIPS
            # rotation+scale form, and the engine rebuilds PC from (CROTA,
            # CDELT) whenever a cdelt/crota LAG is applied — warn loudly for
            # flip/skew matrices so those lag axes aren't trusted
            pc11, pc12, pc21, pc22 = pc_from_crota(crota, cdelt1, cdelt2)
            ok = (abs(pc11 - cd11 / cdelt1) < 1e-8
                  and abs(pc12 - cd12 / cdelt1) < 1e-8
                  and abs(pc21 - cd21 / cdelt2) < 1e-8
                  and abs(pc22 - cd22 / cdelt2) < 1e-8)
            if not ok:
                warnings.warn(
                    "CDi_j matrix is not a pure rotation+scale (negative "
                    "determinant or skew): CRVAL lag searches use the exact "
                    "PC decomposition and are fine, but CDELT/CROTA lags "
                    "rebuild PC from the synthesized CROTA and would search "
                    "a mirrored frame — do not use them with this header."
                )
            hdr["CDELT1"] = cdelt1
            hdr["CDELT2"] = cdelt2
            hdr["PC1_1"], hdr["PC1_2"] = cd11 / cdelt1, cd12 / cdelt1
            hdr["PC2_1"], hdr["PC2_2"] = cd21 / cdelt2, cd22 / cdelt2
            hdr["CROTA"] = crota
    if "PC1_1" not in hdr:
        if "CROTA" in hdr:
            crot = hdr["CROTA"]
        elif "CROTA2" in hdr:
            crot = hdr["CROTA2"]
        elif force_crota_0:
            crot = 0.0
            hdr["CROTA"] = 0.0
        else:
            raise ValueError(
                "No CROTA, CROTA2 or PCi_j matrix in the FITS header. "
                "Set force_crota_0=True to force CROTA=0."
            )
        pc11, pc12, pc21, pc22 = pc_from_crota(crot, hdr["CDELT1"], hdr["CDELT2"])
        hdr["PC1_1"], hdr["PC1_2"] = pc11, pc12
        hdr["PC2_1"], hdr["PC2_2"] = pc21, pc22
    if hdr["PC1_1"] >= 1.0:
        if hdr["PC1_1"] > 1.0:
            warnings.warn(f"PC1_1={hdr['PC1_1']} > 1, clamping to identity.")
        if hdr["PC1_1"] != 1.0 or hdr.get("PC1_2", 0.0) != 0.0:
            hdr["PC1_1"] = 1.0
            hdr["PC2_2"] = 1.0
            hdr["PC1_2"] = 0.0
            hdr["PC2_1"] = 0.0
            hdr["CROTA"] = 0.0
    if "CROTA" not in hdr:
        hdr["CROTA"] = crota_from_pc(hdr["PC1_1"], hdr["PC1_2"])


def get_crota(hdr: Header) -> float:
    """CROTA in degrees, from CROTA/CROTA2/PC."""
    if "CROTA" in hdr:
        return float(hdr["CROTA"])
    if "CROTA2" in hdr:
        return float(hdr["CROTA2"])
    return crota_from_pc(hdr["PC1_1"], hdr["PC1_2"])


# ---------------------------------------------------------------------------
# Pointing correction (the write-side header shift)
# ---------------------------------------------------------------------------

def correct_pointing_header(
    hdr: Header,
    lag_crval1=None,
    lag_crval2=None,
    lag_cdelt1=None,
    lag_cdelt2=None,
    lag_crota=None,
):
    """Apply arcsec pointing lags to a header in place.

    Behavioural port of ``AlignCommonUtil.correct_pointing_header``
    (``Util.py:163-215``): CRVAL1/2 += lag (arcsec -> CUNIT), CDELT1/2 += lag,
    CROTA += lag (deg) and the PCi_j matrix is rebuilt whenever CDELT/CROTA
    change.
    """
    _ensure_pc_for_correction(hdr)
    change_pcij = False
    if lag_crval1 is not None:
        hdr["CRVAL1"] = hdr["CRVAL1"] + units.convert(lag_crval1, "arcsec", hdr["CUNIT1"])
    if lag_crval2 is not None:
        hdr["CRVAL2"] = hdr["CRVAL2"] + units.convert(lag_crval2, "arcsec", hdr["CUNIT2"])

    key_rota = None
    if "CROTA" in hdr:
        key_rota = "CROTA"
        crota = hdr[key_rota]
    elif "CROTA2" in hdr:
        key_rota = "CROTA2"
        crota = hdr[key_rota]
    else:
        crota = crota_from_pc(hdr["PC1_1"], hdr["PC1_2"])

    if lag_crota is not None:
        crota = crota + lag_crota
        if key_rota is not None:
            hdr[key_rota] = crota
        change_pcij = True
    if lag_cdelt1 is not None:
        hdr["CDELT1"] = hdr["CDELT1"] + units.convert(lag_cdelt1, "arcsec", hdr["CUNIT1"])
        change_pcij = True
    if lag_cdelt2 is not None:
        hdr["CDELT2"] = hdr["CDELT2"] + units.convert(lag_cdelt2, "arcsec", hdr["CUNIT2"])
        change_pcij = True
    if change_pcij:
        pc11, pc12, pc21, pc22 = pc_from_crota(crota, hdr["CDELT1"], hdr["CDELT2"])
        hdr["PC1_1"], hdr["PC1_2"] = pc11, pc12
        hdr["PC2_1"], hdr["PC2_2"] = pc21, pc22


def _ensure_pc_for_correction(hdr: Header):
    """Port of ``AlignCommonUtil._check_and_create_pcij_crota_hdr``
    (``Util.py:217-245``): like :func:`ensure_pcij` but defaults CROTA to 0
    instead of raising, and clamps PC1_1 > 1."""
    if "PC1_1" not in hdr:
        if "CROTA" in hdr:
            crot = hdr["CROTA"]
        elif "CROTA2" in hdr:
            crot = hdr["CROTA2"]
        else:
            hdr["CROTA"] = 0.0
            crot = 0.0
        pc11, pc12, pc21, pc22 = pc_from_crota(crot, hdr["CDELT1"], hdr["CDELT2"])
        hdr["PC1_1"], hdr["PC1_2"] = pc11, pc12
        hdr["PC2_1"], hdr["PC2_2"] = pc21, pc22
    if hdr["PC1_1"] > 1.0:
        warnings.warn(f"PC1_1={hdr['PC1_1']} > 1, clamping to identity.")
        hdr["PC1_1"] = 1.0
        hdr["PC2_2"] = 1.0
        hdr["PC1_2"] = 0.0
        hdr["PC2_1"] = 0.0
        hdr["CROTA"] = 0.0
    if "CROTA" not in hdr and "CROTA2" not in hdr:
        hdr["CROTA"] = crota_from_pc(hdr["PC1_1"], hdr["PC1_2"])


# ---------------------------------------------------------------------------
# Compact WCS parameter bundle shipped to device
# ---------------------------------------------------------------------------

@dataclass
class WCSParams:
    """Scalars of a 2-D celestial WCS, angles in degrees, ready for JAX.

    ``kind`` is ``"tan"`` (gnomonic, HPLN/HPLT-TAN) or ``"car"``
    (linear plate carree, CRLN/CRLT-CAR with CRVAL2 == 0).
    """

    crval1: float
    crval2: float
    crpix1: float
    crpix2: float
    cdelt1: float
    cdelt2: float
    pc11: float
    pc12: float
    pc21: float
    pc22: float
    kind: str = "tan"

    def as_dict(self):
        return {
            "crval1": self.crval1,
            "crval2": self.crval2,
            "crpix1": self.crpix1,
            "crpix2": self.crpix2,
            "cdelt1": self.cdelt1,
            "cdelt2": self.cdelt2,
            "pc11": self.pc11,
            "pc12": self.pc12,
            "pc21": self.pc21,
            "pc22": self.pc22,
        }


def wcs_params_from_header(hdr: Header) -> WCSParams:
    """Extract a 2-D celestial :class:`WCSParams` (in degrees) from a header."""
    cunit1 = hdr.get("CUNIT1", "deg")
    cunit2 = hdr.get("CUNIT2", "deg")
    ctype1 = str(hdr.get("CTYPE1", "HPLN-TAN"))
    kind = "tan" if ctype1.endswith("-TAN") else "car"
    pc11 = hdr.get("PC1_1")
    if pc11 is None:
        crota = get_crota(hdr) if ("CROTA" in hdr or "CROTA2" in hdr or "PC1_1" in hdr) else 0.0
        pc11, pc12, pc21, pc22 = pc_from_crota(crota, hdr["CDELT1"], hdr["CDELT2"])
    else:
        pc12 = hdr.get("PC1_2", 0.0)
        pc21 = hdr.get("PC2_1", 0.0)
        pc22 = hdr.get("PC2_2", 1.0)
    return WCSParams(
        crval1=units.to_deg(float(hdr["CRVAL1"]), cunit1),
        crval2=units.to_deg(float(hdr["CRVAL2"]), cunit2),
        crpix1=float(hdr["CRPIX1"]),
        crpix2=float(hdr["CRPIX2"]),
        cdelt1=units.to_deg(float(hdr["CDELT1"]), cunit1),
        cdelt2=units.to_deg(float(hdr["CDELT2"]), cunit2),
        pc11=float(pc11),
        pc12=float(pc12),
        pc21=float(pc21),
        pc22=float(pc22),
        kind=kind,
    )

