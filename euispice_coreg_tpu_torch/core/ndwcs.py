"""N-dimensional FITS WCS for spectrometer cubes (host-side, float64).

Host copy of ``euispice_coreg_tpu/core/ndwcs.py``.  The reference leans on
astropy's generic ``WCS`` + ``dropaxis`` for the SPICE 4-D (x, y, lambda, t)
headers (reference ``hdrshift/alignment_spice.py:250-323``,
``synras/map_builder.py:249-349``).  This class implements the subset the
framework needs:

* arbitrary axis count with a full PCi_j matrix,
* ``dropaxis`` / ``set_pc`` surgery (e.g. decoupling time from x before
  flattening to a spatial 2-D header),
* per-axis linear world evaluation; the celestial (``*-TAN`` / ``*-CAR``)
  pair goes through the projection math of :mod:`.wcs` (``xp=np``),
* ``UTC`` axes return seconds offset from DATEREF (or DATE-BEG/DATE-OBS).
"""
from __future__ import annotations

import numpy as np

from ..utils import units
from . import wcs as wcs2d
from .header import Header


class NDWCS:
    def __init__(self, n, crval, crpix, cdelt, cunit, ctype, pc, meta=None):
        self.n = n
        self.crval = np.asarray(crval, dtype=np.float64)
        self.crpix = np.asarray(crpix, dtype=np.float64)
        self.cdelt = np.asarray(cdelt, dtype=np.float64)
        self.cunit = list(cunit)
        self.ctype = list(ctype)
        self.pc = np.asarray(pc, dtype=np.float64)
        self.meta = dict(meta or {})

    @classmethod
    def from_header(cls, hdr: Header) -> "NDWCS":
        n = int(hdr.get("WCSAXES", hdr.get("NAXIS", 2)))
        crval = [float(hdr.get(f"CRVAL{i}", 0.0)) for i in range(1, n + 1)]
        crpix = [float(hdr.get(f"CRPIX{i}", 0.0)) for i in range(1, n + 1)]
        cdelt = [float(hdr.get(f"CDELT{i}", 1.0)) for i in range(1, n + 1)]
        cunit = [str(hdr.get(f"CUNIT{i}", "")) for i in range(1, n + 1)]
        ctype = [str(hdr.get(f"CTYPE{i}", "")) for i in range(1, n + 1)]
        pc = np.eye(n)
        for i in range(n):
            for j in range(n):
                key = f"PC{i + 1}_{j + 1}"
                if key in hdr:
                    pc[i, j] = float(hdr[key])
        meta = {}
        for k in ("DATEREF", "DATE-BEG", "DATE-OBS", "DATE-AVG", "CROTA", "CROTA2"):
            if k in hdr:
                meta[k] = hdr[k]
        return cls(n, crval, crpix, cdelt, cunit, ctype, pc, meta)

    def copy(self) -> "NDWCS":
        return NDWCS(self.n, self.crval.copy(), self.crpix.copy(),
                     self.cdelt.copy(), list(self.cunit), list(self.ctype),
                     self.pc.copy(), dict(self.meta))

    def set_pc(self, i: int, j: int, value: float):
        """Zero/patch a PC element (0-based axis indices), e.g. decouple the
        time axis from x (`w.wcs.pc[2, 0] = 0` in the reference)."""
        self.pc[i, j] = value

    def dropaxis(self, ax: int) -> "NDWCS":
        """Remove pixel/world axis ``ax`` (0-based, FITS axis order)."""
        keep = [i for i in range(self.n) if i != ax]
        return NDWCS(
            self.n - 1,
            self.crval[keep],
            self.crpix[keep],
            self.cdelt[keep],
            [self.cunit[i] for i in keep],
            [self.ctype[i] for i in keep],
            self.pc[np.ix_(keep, keep)],
            dict(self.meta),
        )

    def axis_index(self, ctype_prefix: str) -> int:
        for i, ct in enumerate(self.ctype):
            if ct.startswith(ctype_prefix) or ct == ctype_prefix:
                return i
        raise KeyError(f"no axis with CTYPE {ctype_prefix!r} in {self.ctype}")

    # ------------------------------------------------------------------
    def intermediate(self, pixel_coords):
        """Linear part: x_i = cdelt_i * sum_j pc[i,j] (p_j + 1 - crpix_j).

        ``pixel_coords``: sequence of n arrays (0-based pixels, broadcastable).
        """
        qs = [np.asarray(p, dtype=np.float64) + 1.0 - self.crpix[j]
              for j, p in enumerate(pixel_coords)]
        out = []
        for i in range(self.n):
            acc = 0.0
            for j in range(self.n):
                if self.pc[i, j] != 0.0:
                    acc = acc + self.pc[i, j] * qs[j]
            out.append(self.cdelt[i] * np.asarray(acc, dtype=np.float64))
        return out

    def celestial_pair(self):
        """(lon_axis, lat_axis) indices of the celestial pair, or None."""
        lon = lat = None
        for i, ct in enumerate(self.ctype):
            if ct.startswith(("HPLN", "CRLN", "RA--", "GLON")):
                lon = i
            elif ct.startswith(("HPLT", "CRLT", "DEC-", "GLAT")):
                lat = i
        if lon is None or lat is None:
            return None
        return lon, lat

    def pixel_to_world(self, *pixel_coords):
        """World values per axis.

        Celestial pair: degrees (projected).  UTC axes: seconds from DATEREF
        (fallback DATE-BEG, DATE-OBS).  Other axes: linear, in CUNIT.
        """
        inter = self.intermediate(pixel_coords)
        out = list(inter)
        pair = self.celestial_pair()
        if pair is not None:
            ilon, ilat = pair
            x_deg = units.to_deg(inter[ilon], self.cunit[ilon] or "deg")
            y_deg = units.to_deg(inter[ilat], self.cunit[ilat] or "deg")
            kind = "tan" if self.ctype[ilon].endswith("-TAN") else "car"
            params = {
                "crval1": units.to_deg(self.crval[ilon], self.cunit[ilon] or "deg"),
                "crval2": units.to_deg(self.crval[ilat], self.cunit[ilat] or "deg"),
                # intermediate coords already computed; identity linear part
                "crpix1": 1.0, "crpix2": 1.0, "cdelt1": 1.0, "cdelt2": 1.0,
                "pc11": 1.0, "pc12": 0.0, "pc21": 0.0, "pc22": 1.0,
            }
            if kind == "tan":
                lon, lat = wcs2d.tan_pixel_to_world(params, x_deg, y_deg, xp=np)
            else:
                lon, lat = x_deg + params["crval1"], y_deg + params["crval2"]
            out[ilon], out[ilat] = lon, lat
        for i, ct in enumerate(self.ctype):
            if ct in ("UTC", "TIME") and i not in (pair or ()):
                scale = {"s": 1.0, "": 1.0, "min": 60.0, "h": 3600.0}.get(
                    self.cunit[i].strip(), 1.0)
                out[i] = (np.asarray(inter[i]) + self.crval[i]) * scale
        return out

    def time_origin_seconds(self) -> float:
        """Epoch seconds (since 2000-01-01) of the time axis origin."""
        from ..utils import timeutils

        for key in ("DATEREF", "DATE-BEG", "DATE-OBS"):
            if key in self.meta:
                return timeutils.parse_fits_time(str(self.meta[key]))
        raise ValueError("no DATEREF/DATE-BEG/DATE-OBS for the time axis")

    # ------------------------------------------------------------------
    def to_header(self, extra=None) -> Header:
        hdr = Header({"WCSAXES": self.n})
        for i in range(self.n):
            hdr[f"CRVAL{i + 1}"] = float(self.crval[i])
            hdr[f"CRPIX{i + 1}"] = float(self.crpix[i])
            hdr[f"CDELT{i + 1}"] = float(self.cdelt[i])
            hdr[f"CUNIT{i + 1}"] = self.cunit[i]
            hdr[f"CTYPE{i + 1}"] = self.ctype[i]
            for j in range(self.n):
                hdr[f"PC{i + 1}_{j + 1}"] = float(self.pc[i, j])
        for k, v in self.meta.items():
            hdr[k] = v
        if extra:
            hdr.update(extra)
        return hdr
