"""Gather-based image resampling matching ``scipy.ndimage.map_coordinates``
with ``prefilter=False`` and ``mode='constant'``, on torch tensors.

Counterpart of ``sample_image`` in ``euispice_coreg_tpu/core/resample.py``.
Orders 0..3 are supported; scipy tap/weight conventions:

* even order:  start tap ``k = floor(c + 0.5) - order//2``
* odd order:   start tap ``k = floor(c)   - order//2``
* weights are the centered B-spline of the given order evaluated at the
  fractional offset;
* a coordinate strictly outside ``[0, n-1]`` on either axis yields ``cval``
  (NaN fill -> masked pixel downstream);
* for in-range coordinates whose spline footprint crosses the edge, taps are
  *mirrored* about the edge pixel (scipy applies mirror extension to spline
  taps even in constant mode).

The JAX package's gather-free samplers (``sample_image_select``,
``sample_image_upsample``) work around the TPU's slow gather and have no
counterpart here: the GPU gathers directly.
"""
from __future__ import annotations

import math

import torch


def _taps_and_weights(c, order):
    """Per-axis tap indices (int64, list) and weights (list) for coordinate c."""
    if order == 0:
        k = torch.floor(c + 0.5).long()
        return [k], [torch.ones_like(c)]
    if order == 1:
        k = torch.floor(c)
        t = c - k
        k = k.long()
        return [k, k + 1], [1.0 - t, t]
    if order == 2:
        k = torch.floor(c + 0.5)
        t = c - k
        k = k.long()
        h = 0.5 - t
        g = 0.5 + t
        return [k - 1, k, k + 1], [0.5 * (h * h), 0.75 - t * t, 0.5 * (g * g)]
    if order == 3:
        k = torch.floor(c)
        t = c - k
        k = k.long()
        t2 = t * t
        t3 = t2 * t
        w_m1 = (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0
        w_0 = (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0
        w_p1 = (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0
        w_p2 = t3 / 6.0
        return [k - 1, k, k + 1, k + 2], [w_m1, w_0, w_p1, w_p2]
    raise NotImplementedError(f"spline order {order} not supported (use 0..3)")


def _mirror(idx, n):
    """Mirror an (possibly out-of-range) tap index about the edge pixels,
    scipy 'mirror' convention (period 2n-2, edge not repeated)."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * n - 2
    idx = torch.abs(idx) % period
    return torch.where(idx >= n, period - idx, idx)


def sample_image(image, x, y, order: int = 2, cval=math.nan):
    """Sample ``image[row, col]`` at fractional coordinates (x=col, y=row).

    Equivalent to ``scipy.ndimage.map_coordinates(image, [y, x], order=order,
    mode='constant', cval=cval, prefilter=False)``.  NaN coordinates produce
    ``cval``.  Arbitrary leading batch dims on x/y are allowed; the result
    has the dtype of ``image``.
    """
    h, w = image.shape
    flat = image.reshape(-1)

    invalid = (
        torch.isnan(x) | torch.isnan(y)
        | (x < 0) | (x > w - 1)
        | (y < 0) | (y > h - 1)
    )
    xs = torch.where(invalid, 0.0, x)
    ys = torch.where(invalid, 0.0, y)

    tx, wx = _taps_and_weights(xs, order)
    ty, wy = _taps_and_weights(ys, order)

    acc = torch.zeros(torch.broadcast_shapes(x.shape, y.shape),
                      dtype=image.dtype, device=image.device)
    for iy, wyi in zip(ty, wy):
        iym = _mirror(iy, h)
        for ix, wxi in zip(tx, wx):
            ixm = _mirror(ix, w)
            acc = acc + (wyi * wxi) * flat[iym * w + ixm]
    return torch.where(invalid, cval, acc)


def interpol2d(image, x, y, fill=math.nan, order: int = 2, dst=None, *,
               device="cuda"):
    """API-compatible stand-in for ``AlignCommonUtil.interpol2d``
    (``Util.py:82-104``): note the (x, y) argument order.

    Counterpart of ``interpol2d`` in ``euispice_coreg_tpu/core/resample.py``.
    A tensor ``image`` samples on its own device in its own dtype; numpy
    inputs go to ``device`` in float64 and come back as a tensor there.
    With ``dst`` the result is written into it and None is returned."""
    if isinstance(image, torch.Tensor):
        dev, dt = image.device, image.dtype
    else:
        from ..utils.torchcfg import resolve_device

        dev, dt = resolve_device(device), torch.float64
    img, xs, ys = (a.to(device=dev, dtype=dt) if isinstance(a, torch.Tensor)
                   else torch.as_tensor(a, dtype=dt).to(dev)
                   for a in (image, x, y))
    out = sample_image(img, xs, ys, order=order, cval=fill)
    if dst is None:
        return out
    dst[...] = out.cpu().numpy()
    return None
