"""The plain reference of the correlation hypercube, one pair at a time.

Each class works out again, from the arrays and headers the benchmark wrote
into the pair's FITS files and from the cell's lag grid, everything the
program derives inside an ``Alignment`` call, and scores any set of lags on
demand (``r``), keeping what it scored.  Lags are addressed by their 5-D
index ``(i_crval1, i_crval2, i_cdelt1, i_cdelt2, i_crota)``.

* :class:`HelioReference` is the helioprojective search of every route
  (K1, the block path, the FFT path): per lag the small image is resampled
  once, through the lagged TAN WCS, onto the world coordinates of its own
  header's pixel grid, and scored against the reference image resampled
  onto the same grid.  The block path resamples twice (a warp per
  CDELT/CROTA combo, then a tap stencil per CRVAL lag), so it departs from
  these numbers by its own smoothing; K1 computes them.
* :class:`CarrReference` is the Carrington search of the select path (K2 and
  tile-FFT).  Both images are reprojected once onto the Carrington grid; a
  CRVAL lag moves the detector sampling by a constant vector, which is
  carried into grid pixels at a 4 x 4 grid of probes and fitted there by a
  quadratic map in the grid indices; the reprojected small image, a canvas
  the size of the grid, is sampled through that map.  This is the select
  path's own algorithm, not a per-lag reprojection of the whole detector:
  the two part where a lag moves the footprint past the grid's edge.

The device parts compute in ``dtype`` (float64 here; the benchmark's control
runs them one precision below the program's float32), the probe fit in
float64 (float32 for a control).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import geometry as g
from .sampling import finite_pairs, pearson, sample

BATCH = 8  # lags scored per stacked call


def fits_days(a: str, b: str) -> float:
    """(a - b) in days, both FITS ISO timestamps."""
    def t(s):
        return np.datetime64(str(s).strip().replace("Z", ""), "us")
    return float((t(a) - t(b)) / np.timedelta64(1, "us")) / 86400e6


class _Reference:
    """Caching front of both references: ``r(idx)`` scores the (K, 5) lag
    indices ``idx`` and keeps every score by its index tuple."""

    def __init__(self, lags_deg, dtype, device):
        self.lags = [np.asarray(v, dtype=np.float64) for v in lags_deg]
        self.dtype = dtype
        self.device = torch.device(device)
        self.scores: dict[tuple, float] = {}
        self.pairs: dict[tuple, int] = {}

    @property
    def shape(self):
        return tuple(len(v) for v in self.lags)

    def r(self, idx):
        idx = [tuple(int(k) for k in row) for row in np.atleast_2d(idx)]
        todo = [k for k in dict.fromkeys(idx) if k not in self.scores]
        for s in range(0, len(todo), BATCH):
            chunk = todo[s:s + BATCH]
            sampled = torch.stack([self._sampled(k) for k in chunk])
            vals = pearson(self.ref, sampled).double().cpu().numpy()
            counts = finite_pairs(self.ref, sampled).cpu().numpy()
            for k, v, c in zip(chunk, vals, counts):
                self.scores[k] = float(v)
                self.pairs[k] = int(c)
        return np.array([self.scores[k] for k in idx])

    def n_ref(self):
        """Pixels at which the reference image is finite."""
        return int(torch.isfinite(self.ref).sum())

    def _sampled(self, k):
        raise NotImplementedError


class HelioReference(_Reference):
    """Helioprojective TAN search of one pair (see the module's text)."""

    def __init__(self, large, small, hdr_large, hdr_small, lags_deg, *,
                 dtype=torch.float64, device="cpu"):
        super().__init__(lags_deg, dtype, device)
        self.p_small = g.tan_params(hdr_small)
        p_large = g.tan_params(hdr_large)
        h, w = small.shape
        y, x = torch.meshgrid(torch.arange(h, dtype=dtype, device=self.device),
                              torch.arange(w, dtype=dtype, device=self.device),
                              indexing="ij")
        self.lon, self.lat = g.tan_pixel_to_world(self.p_small, x, y)
        xl, yl = g.tan_world_to_pixel(p_large, self.lon, self.lat)
        self.ref = sample(torch.as_tensor(large, device=self.device).to(dtype),
                          xl, yl)
        self.small = torch.as_tensor(small, device=self.device).to(dtype)

    def _sampled(self, k):
        d = [float(self.lags[a][k[a]]) for a in range(5)]
        q = g.lagged(self.p_small, *d)
        x, y = g.tan_world_to_pixel(q, self.lon, self.lat)
        return sample(self.small, x, y)


class CarrReference(_Reference):
    """Carrington select-path search of one pair (see the module's text);
    CRVAL lags only."""

    def __init__(self, large, small, hdr_large, hdr_small, lags_deg, *,
                 lonlims, latlims, shape, d_solar_r, reference_date,
                 dtype=torch.float64, device="cpu"):
        super().__init__(lags_deg, dtype, device)
        if any(np.any(v != 0.0) for v in self.lags[2:]):
            raise ValueError("the Carrington reference takes CRVAL lags only")
        band = g.RATE_BAND.get(str(int(hdr_large["WAVELNTH"])))
        self.band = band
        lon, lat = g.carrington_grid(lonlims, latlims, shape, dtype,
                                     self.device)
        dt_l = fits_days(hdr_large["DATE-OBS"], reference_date)
        self.dt = fits_days(hdr_small["DATE-OBS"], reference_date)
        self.sc_l = g.sphere_scalars(hdr_large, d_solar_r)
        self.sc = g.sphere_scalars(hdr_small, d_solar_r)
        nx, ny = g.sphere_to_detector(
            self.sc_l, lon - g.diff_rot(lat, dt_l, band), lat)
        self.ref = sample(torch.as_tensor(large, device=self.device).to(dtype),
                          nx, ny)
        nx, ny = g.sphere_to_detector(
            self.sc, lon - g.diff_rot(lat, self.dt, band), lat)
        self.warped = sample(torch.as_tensor(small, device=self.device)
                             .to(dtype), nx, ny)
        self.lonlims, self.latlims = lonlims, latlims
        w, h = shape
        self.h, self.w = h, w
        self.dlon = (lonlims[1] - lonlims[0]) / (w - 1)
        self.dlat = (latlims[1] - latlims[0]) / (h - 1)
        self.fit_dtype = torch.float64 if dtype == torch.float64 \
            else torch.float32
        self._probes()
        jj = torch.arange(w, dtype=dtype, device=self.device).expand(h, w)
        ii = torch.arange(h, dtype=dtype, device=self.device)[:, None] \
            .expand(h, w)
        self.basis = (jj, ii, torch.ones_like(jj), jj * jj, ii * ii, jj * ii)

    def _probes(self):
        """The 4 x 4 probe grid, its exact detector pixels and the
        least-squares operator of the quadratic basis on normalised grid
        indices."""
        ft = self.fit_dtype
        py = np.unique(np.linspace(0, self.h - 1, 4).astype(np.int64))
        px = np.unique(np.linspace(0, self.w - 1, 4).astype(np.int64))
        pyg, pxg = np.meshgrid(py, px, indexing="ij")
        self.pxf = torch.as_tensor(pxg.ravel(), dtype=ft)
        self.pyf = torch.as_tensor(pyg.ravel(), dtype=ft)
        lon_p = self.lonlims[0] + self.pxf * self.dlon
        lat_p = self.latlims[0] + self.pyf * self.dlat
        self.nx0, self.ny0 = g.sphere_to_detector(
            self.sc, lon_p - g.diff_rot(lat_p, self.dt, self.band), lat_p)
        sx, sy = float(max(self.w - 1, 1)), float(max(self.h - 1, 1))
        xs, ys = self.pxf / sx, self.pyf / sy
        design = torch.stack([xs, ys, torch.ones_like(xs), xs * xs, ys * ys,
                              xs * ys], dim=-1)
        self.pinv = torch.linalg.pinv(design)
        self.rescale = torch.tensor([1 / sx, 1 / sy, 1.0, 1 / (sx * sx),
                                     1 / (sy * sy), 1 / (sx * sy)], dtype=ft)

    def coeffs(self, d1, d2):
        """(6, 2) quadratic map, grid pixels, of the CRVAL lag (d1, d2) deg:
        the constant detector displacement carried to the grid at the
        probes, fitted by least squares."""
        dc1, dc2 = d1 * 3600.0, d2 * 3600.0
        r = self.sc["roll"] * g.RAD
        csx = -(math.cos(r) * dc1 + math.sin(r) * dc2) / self.sc["cdelt1"]
        csy = -(-math.sin(r) * dc1 + math.cos(r) * dc2) / self.sc["cdelt2"]
        lon, lat = g.detector_to_sphere(self.sc, self.nx0 + csx,
                                        self.ny0 + csy)
        lon = lon + g.diff_rot(lat, self.dt, self.band)
        gx = (lon - self.lonlims[0]) / self.dlon
        gy = (lat - self.latlims[0]) / self.dlat
        c = torch.stack([gx - self.pxf, gy - self.pyf], dim=-1)
        return (self.pinv @ c) * self.rescale[:, None]

    def _sampled(self, k):
        c = self.coeffs(float(self.lags[0][k[0]]), float(self.lags[1][k[1]]))
        c = c.to(dtype=self.dtype, device=self.device)
        dx = sum(c[t, 0] * self.basis[t] for t in range(6))
        dy = sum(c[t, 1] * self.basis[t] for t in range(6))
        return sample(self.warped, self.basis[0] + dx, self.basis[1] + dy)
