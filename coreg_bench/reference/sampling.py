"""Plain image sampling and scoring of the benchmark's reference.

``sample`` is ``scipy.ndimage.map_coordinates(image, [y, x], order=2,
mode="constant", cval=nan, prefilter=False)`` on torch tensors: the centred
quadratic B-spline's three taps per axis, a coordinate outside
``[0, n - 1]`` gives NaN, and taps that cross an edge are mirrored about the
edge pixel (period ``2n - 2``), as scipy does in that mode.  A coordinate
within ``EDGE_TOL`` pixel of an edge counts as on it: at the zero lag the
image to correct is mapped onto its own grid, and comes back from float64
geometry some 1e-12 pixel off its edge pixels, where the program's float32
lands on them.  ``pearson`` is
the two-pass Pearson r over the pixels finite in both images.
"""
from __future__ import annotations

import math

import torch

EDGE_TOL = 1e-6  # pixel


def _mirror(k, n):
    period = 2 * n - 2
    k = torch.remainder(torch.abs(k), period)
    return torch.where(k >= n, period - k, k)


def sample(image, x, y):
    """Order-2 sample of ``image`` (h, w) at columns ``x`` and rows ``y``
    (any matching shape), in the image's dtype."""
    h, w = image.shape
    bad = torch.isnan(x) | torch.isnan(y) | (x < -EDGE_TOL) \
        | (x > w - 1 + EDGE_TOL) | (y < -EDGE_TOL) | (y > h - 1 + EDGE_TOL)
    x = torch.where(bad, torch.zeros_like(x), x.clamp(0, w - 1))
    y = torch.where(bad, torch.zeros_like(y), y.clamp(0, h - 1))
    flat = image.reshape(-1)

    def taps(c):
        k = torch.floor(c + 0.5)
        t = c - k
        k = k.long()
        lo, hi = 0.5 - t, 0.5 + t
        return (k - 1, k, k + 1), (0.5 * lo * lo, 0.75 - t * t, 0.5 * hi * hi)

    kx, wx = taps(x)
    ky, wy = taps(y)
    out = torch.zeros(x.shape, dtype=image.dtype, device=image.device)
    for iy, fy in zip(ky, wy):
        row = _mirror(iy, h) * w
        for ix, fx in zip(kx, wx):
            out = out + (fy * fx).to(image.dtype) * flat[row + _mirror(ix, w)]
    return torch.where(bad, torch.full_like(out, math.nan), out)


def pearson(a, b):
    """Pearson r of ``a`` (h, w) against each of ``b`` (..., h, w), over the
    pixels finite in both; NaN where none are or a variance is zero."""
    a, b = torch.broadcast_tensors(a, b)
    a, b = a.flatten(-2), b.flatten(-2)
    m = torch.isfinite(a) & torch.isfinite(b)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    n = m.sum(-1, keepdim=True).to(a.dtype)
    ma = torch.where(m, a, zero).sum(-1, keepdim=True) / n
    mb = torch.where(m, b, zero).sum(-1, keepdim=True) / n
    da = torch.where(m, a - ma, zero)
    db = torch.where(m, b - mb, zero)
    return (da * db).sum(-1) / torch.sqrt((da * da).sum(-1) * (db * db).sum(-1))


def finite_pairs(a, b):
    """Number of pixels finite in both, per image of ``b``."""
    return (torch.isfinite(a) & torch.isfinite(b)).flatten(-2).sum(-1)
