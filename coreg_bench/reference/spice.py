"""The plain reference of a SPICE L2 raster against an imager sequence.

Worked out again from the arrays and headers the benchmark wrote into the
pair's files, as the program derives them inside a call, importing nothing
of the program:

* the raster's spatial header: its CRVAL, CRPIX, CDELT and PC with the roll
  read from the PC (:func:`spatial`), and the spectral sum of the aligned
  window over the slit's usable rows, the dumbbells left out
  (:func:`usable_rows`, :func:`masked_sum`; upstream
  ``AlignSpiceUtil.vertical_edges_limits``);
* the composed raster (:func:`compose`): each column's time from the L2
  header itself (DATE-BEG, then CRVAL4, CDELT4 and PC4_1 of the UTC axis
  coupled to x), the frame nearest in DATE-AVG (:func:`nearest_frames`),
  sampled at the slit's world coordinates through the frame's TAN header
  (:func:`sampling.sample`, order 2, mirror rule);
* :class:`RasterReference`, the search on one composed raster
  (``AlignmentSpice`` on the synthetic raster): the composed raster under
  the handed-over header is the reference image, resampled onto the
  raster's own grid, and per lag the spectral sum is resampled through the
  lagged header, as :class:`hypercube.HelioReference` does;
* :class:`IterativeReference`, the search of the iterative context raster:
  per lag the raster's spatial header is shifted, the raster composed again
  under it, and the spectral sum mapped through the same shifted header
  onto the composed grid; r is Pearson's over the pixels finite in both.

Images are sampled and scored in ``dtype`` (float64; bfloat16 for the
control), the geometry in float64, in float32 for a control, as the
Carrington reference's probe fit: in bfloat16 the TAN projection near the
pole of its sphere loses the raster's whole field.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import geometry as g
from .hypercube import BATCH, _Reference, fits_days
from .judge import roll_deg
from .sampling import finite_pairs, pearson, sample

SPATIAL = ("CRVAL1", "CRVAL2", "CRPIX1", "CRPIX2", "CDELT1", "CDELT2",
           "PC1_1", "PC1_2", "PC2_1", "PC2_2")


def spatial(hdr):
    """The raster's 2-D spatial header, the roll read from its PC."""
    return dict({k: hdr[k] for k in SPATIAL}, CROTA=roll_deg(hdr))


def usable_rows(hdr):
    """[first, end) rows of the slit less 20 unbinned rows at each end
    (upstream AlignSpiceUtil.slit_pxl and vertical_edges_limits)."""
    ybin = hdr["NBIN2"]
    h_detector = 1024 / ybin
    h_slit = {"SW": 600, "LW": 626}[hdr["DETECTOR"]] / ybin
    beg = (h_detector - h_slit) / 2
    end = h_detector - beg
    beg = beg - hdr["PXBEG2"] / ybin + 1
    end = end - hdr["PXBEG2"] / ybin + 1
    return (int(math.ceil(beg)) + int(20 / ybin),
            int(math.floor(end)) - int(20 / ybin))


def masked_sum(cube, hdr):
    """The spectral sum of a (1, nlam, ny, nx) window in float64, NaN on
    the rows outside the slit's usable part."""
    img = np.asarray(cube[0], dtype=np.float64).sum(axis=0)
    lo, hi = usable_rows(hdr)
    img[:lo] = np.nan
    img[hi:] = np.nan
    return img


def column_seconds(hdr, nx):
    """Each raster column's time in seconds after DATE-BEG: the UTC axis
    at its first (only) pixel, coupled to x through PC4_1."""
    x = np.arange(nx, dtype=np.float64)
    return hdr["CRVAL4"] + hdr["CDELT4"] * (
        hdr["PC4_1"] * (x + 1.0 - hdr["CRPIX1"])
        + hdr.get("PC4_4", 1.0) * (1.0 - hdr["CRPIX4"]))


def nearest_frames(hdr, nx, frame_headers):
    """Index of the frame nearest in DATE-AVG to each raster column."""
    t = column_seconds(hdr, nx)
    tf = np.array([86400.0 * fits_days(h["DATE-AVG"], hdr["DATE-BEG"])
                   for h in frame_headers])
    return np.argmin(np.abs(t[:, None] - tf[None, :]), axis=1)


def geometry_dtype(dtype):
    """The dtype of the reference's geometry for images in ``dtype``."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def pixel_grid(shape, dtype, device):
    """(x, y) of every pixel of an image of ``shape``."""
    y, x = torch.meshgrid(torch.arange(shape[0], dtype=dtype, device=device),
                          torch.arange(shape[1], dtype=dtype, device=device),
                          indexing="ij")
    return x, y


def compose(frames, frame_params, column_frame, lon, lat):
    """The composed raster on (lon, lat) (ny, nx, degrees): column c of
    ``frames[column_frame[c]]`` (tensors by frame index, all in one dtype)
    sampled through that frame's TAN parameters; NaN where its pixel
    leaves the frame."""
    dtype = next(iter(frames.values())).dtype
    out = torch.full(lon.shape, math.nan, dtype=dtype, device=lon.device)
    for f in np.unique(column_frame):
        cols = torch.as_tensor(np.nonzero(column_frame == f)[0],
                               device=lon.device)
        x, y = g.tan_world_to_pixel(frame_params[int(f)], lon[:, cols],
                                    lat[:, cols])
        out[:, cols] = sample(frames[int(f)], x, y)
    return out


class Sequence:
    """The imager sequence of a raster as the composition reads it: the
    frames each column takes, on the device in ``dtype``, their TAN
    parameters and the raster's pixel grid (in the geometry's dtype)."""

    def __init__(self, frames, frame_headers, hdr_l2, shape, dtype, device):
        self.column_frame = nearest_frames(hdr_l2, shape[1], frame_headers)
        self.frames = {int(f): torch.as_tensor(frames[int(f)],
                                               device=device).to(dtype)
                       for f in np.unique(self.column_frame)}
        self.params = [g.tan_params(h) for h in frame_headers]
        self.x, self.y = pixel_grid(shape, geometry_dtype(dtype), device)

    def world(self, p):
        """(lon, lat) of the raster's pixels under TAN parameters ``p``."""
        return g.tan_pixel_to_world(p, self.x, self.y)

    def compose(self, p):
        """The composed raster under the raster's TAN parameters ``p``."""
        return compose(self.frames, self.params, self.column_frame,
                       *self.world(p))


class RasterReference(_Reference):
    """The search on one composed raster (see the module's text): ``large``
    and ``small`` on one grid under the spatial header ``hdr``."""

    def __init__(self, large, small, hdr, lags_deg, *, dtype=torch.float64,
                 device="cpu"):
        super().__init__(lags_deg, dtype, device)
        self.p = g.tan_params(hdr)
        x, y = pixel_grid(small.shape, geometry_dtype(dtype), self.device)
        self.lon, self.lat = g.tan_pixel_to_world(self.p, x, y)
        xl, yl = g.tan_world_to_pixel(self.p, self.lon, self.lat)
        self.ref = sample(torch.as_tensor(large, device=self.device)
                          .to(dtype), xl, yl)
        self.small = torch.as_tensor(small, device=self.device).to(dtype)

    def _sampled(self, k):
        q = g.lagged(self.p, *[float(self.lags[a][k[a]]) for a in range(5)])
        x, y = g.tan_world_to_pixel(q, self.lon, self.lat)
        return sample(self.small, x, y)


class IterativeReference(_Reference):
    """The iterative context raster's search of one pair (see the module's
    text): ``ref`` is the raster's masked spectral sum, and each lag scores
    the raster composed under the lagged header against that sum mapped
    through the same header."""

    def __init__(self, frames, frame_headers, cube, hdr_l2, lags_deg, *,
                 dtype=torch.float64, device="cpu"):
        super().__init__(lags_deg, dtype, device)
        img = masked_sum(cube, hdr_l2)
        self.ref = torch.as_tensor(img, device=self.device).to(dtype)
        self.p = g.tan_params(spatial(hdr_l2))
        self.seq = Sequence(frames, frame_headers, hdr_l2, img.shape, dtype,
                            self.device)

    def _lag_pair(self, k):
        """(composed raster, mapped spectral sum) of lag ``k``."""
        q = g.lagged(self.p, *[float(self.lags[a][k[a]]) for a in range(5)])
        lon, lat = self.seq.world(q)
        composed = compose(self.seq.frames, self.seq.params,
                           self.seq.column_frame, lon, lat)
        x, y = g.tan_world_to_pixel(q, lon, lat)
        return composed, sample(self.ref, x, y)

    def r(self, idx):
        idx = [tuple(int(k) for k in row) for row in np.atleast_2d(idx)]
        todo = [k for k in dict.fromkeys(idx) if k not in self.scores]
        for s in range(0, len(todo), BATCH):
            chunk = todo[s:s + BATCH]
            composed, mapped = (torch.stack(t) for t in zip(
                *[self._lag_pair(k) for k in chunk]))
            vals = pearson(composed, mapped).double().cpu().numpy()
            counts = finite_pairs(composed, mapped).cpu().numpy()
            for k, v, c in zip(chunk, vals, counts):
                self.scores[k] = float(v)
                self.pairs[k] = int(c)
        return np.array([self.scores[k] for k in idx])
