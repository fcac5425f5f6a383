"""Lag-grid search engine (torch).

Counterpart of ``euispice_coreg_tpu/engine/lag_search.py``: each lag
candidate is a closed-form perturbation of the small image's WCS scalars
(crval1/2, cdelt1/2, crota); per lag the small image is warped onto the
comparison grid through the lagged WCS and scored against the reference
submap.  :func:`evaluate_lag_grid` picks the path:

* ``allow_fast="pallas"``: the fused warp+score kernel K1
  (:mod:`.warp_score`);
* CRVAL-only grids with ``correlation``/``residus_masked``: the FFT
  surface fast path (:mod:`.fast_corr`);
* otherwise the exact per-lag engine: K1 on a CUDA device for correlation
  at order 0-2 (it computes exactly the per-lag gather's numbers), the torch
  per-lag gather in lag chunks for everything else.

The JAX package's block fleet path for large mixed grids is not ported yet
(ROADMAP.md, "block fleet path"); neither are its TPU workarounds (the
gather-free select sampler, chunk retries, probe caches, mesh sharding).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import resample, score, wcs
from ..utils.obs import Progress, logger
from ..utils.torchcfg import resolve_device, resolve_dtype, to_tensor
from . import warp_score

# lag vector layout along the last axis of the (L, 5) lag matrix
D_CRVAL1, D_CRVAL2, D_CDELT1, D_CDELT2, D_CROTA = range(5)

BLOCK_NOT_PORTED = ("block fleet path (allow_fast='block', mixed grids of "
                    "more than 2000 candidates): not yet ported, see ROADMAP")


def apply_lag_to_params(base: dict, d):
    """Shift WCS scalars by lag vectors ``d`` ((..., 5) tensor, degrees).

    ``Alignment._shift_header`` semantics with the CDELT bookkeeping fixed:
    CRVAL/CDELT shift additively, CROTA shifts in degrees, and the PC matrix
    is rebuilt from (CROTA, CDELT) whenever any of CDELT1/CDELT2/CROTA lags
    is nonzero; otherwise the original PC matrix is kept verbatim.  Returns
    a dict of tensors of shape ``d.shape[:-1]`` in ``d``'s dtype.
    """
    def b(k):
        return torch.as_tensor(base[k], dtype=d.dtype, device=d.device)

    crval1 = b("crval1") + d[..., D_CRVAL1]
    crval2 = b("crval2") + d[..., D_CRVAL2]
    cdelt1 = b("cdelt1") + d[..., D_CDELT1]
    cdelt2 = b("cdelt2") + d[..., D_CDELT2]
    crota = b("crota") + d[..., D_CROTA]

    rebuild = (d[..., D_CDELT1] != 0) | (d[..., D_CDELT2] != 0) \
        | (d[..., D_CROTA] != 0)
    rho = crota * wcs.RAD_PER_DEG
    lam = cdelt2 / cdelt1
    cos_r, sin_r = torch.cos(rho), torch.sin(rho)
    ones = torch.ones_like(crval1)
    return {
        "crval1": crval1,
        "crval2": crval2,
        "crpix1": b("crpix1") * ones,
        "crpix2": b("crpix2") * ones,
        "cdelt1": cdelt1,
        "cdelt2": cdelt2,
        "pc11": torch.where(rebuild, cos_r, b("pc11")),
        "pc12": torch.where(rebuild, -lam * sin_r, b("pc12")),
        "pc21": torch.where(rebuild, sin_r / lam, b("pc21")),
        "pc22": torch.where(rebuild, cos_r, b("pc22")),
    }


def _evaluate_flat(lags, small, ref, lon, lat, base, order, method, kind,
                   batch_size):
    """Exact per-lag engine: warp + score ``batch_size`` lags at a time
    (the counterpart of the JAX ``_score_one_lag``/``_evaluate_flat``).
    Returns an (L,) float64 numpy array."""
    n_lags = lags.shape[0]
    fn = score.SCORE_FUNCTIONS[method]
    out = []
    prog = Progress(total=n_lags, label="gather lag search",
                    enabled=n_lags > batch_size)
    for s in range(0, n_lags, batch_size):
        d = lags[s:s + batch_size]
        params = {k: v[:, None, None]
                  for k, v in apply_lag_to_params(base, d).items()}
        x, y = wcs.world_to_pixel(params, lon, lat, kind=kind)
        sampled = resample.sample_image(small, x, y, order=order)
        out.append(fn(ref, sampled).to(torch.float64).cpu())
        prog.step(d.shape[0])
    return torch.cat(out).numpy()


def evaluate_lag_grid(
    small_img,
    ref_img,
    lon,
    lat,
    base_params: dict,
    lag_crval1,
    lag_crval2,
    lag_cdelt1,
    lag_cdelt2,
    lag_crota,
    *,
    order: int = 2,
    method: str = "correlation",
    kind: str = "tan",
    device,
    compute_dtype="float32",
    batch_size: int = 8,
    allow_fast=True,
) -> np.ndarray:
    """Score the full 5-D lag hypercube; returns shape
    (n_crval1, n_crval2, n_cdelt1, n_cdelt2, n_crota) as float64 numpy.

    All lag arrays and ``base_params`` (WCS dict plus ``crota``) are in
    DEGREES.  Images and coordinate grids may be numpy arrays or tensors;
    they are moved to ``device`` in ``compute_dtype``.
    """
    l1 = np.asarray(lag_crval1, dtype=np.float64)
    l2 = np.asarray(lag_crval2, dtype=np.float64)
    l3 = np.asarray(lag_cdelt1, dtype=np.float64)
    l4 = np.asarray(lag_cdelt2, dtype=np.float64)
    l5 = np.asarray(lag_crota, dtype=np.float64)
    shape = (len(l1), len(l2), len(l3), len(l4), len(l5))
    dev = resolve_device(device)
    dt = resolve_dtype(compute_dtype)

    if allow_fast == "pallas":
        out = warp_score.evaluate_lag_grid_warp(
            small_img, ref_img, lon, lat, base_params,
            l1, l2, l3, l4, l5, order=order, method=method, kind=kind,
            device=dev, compute_dtype=dt,
        )
        if out is not None:
            logger.info("engine path: K1 fused warp+score kernel")
            return out
        logger.info("pallas preconditions failed, falling back")
        allow_fast = True

    if allow_fast and method in ("correlation", "residus_masked"):
        from . import fast_corr

        if fast_corr.fast_path_applicable(l3, l4, l5, order):
            fast = fast_corr.evaluate_crval_grid_fast(
                small_img, ref_img, lon, lat, base_params, l1, l2,
                order=order, kind=kind, device=dev, compute_dtype=dt,
                method=method,
            )
            if fast is not None:
                logger.info("engine path: FFT fast (crval grid)")
                return fast.reshape(shape)
            logger.info("engine path: FFT fast preconditions failed, "
                        "falling back")
        elif allow_fast == "block" and order in (0, 2):
            raise NotImplementedError(BLOCK_NOT_PORTED)

    if (dev.type == "cuda" and method == "correlation"
            and order in (0, 1, 2)):
        out = warp_score.evaluate_lag_grid_warp(
            small_img, ref_img, lon, lat, base_params,
            l1, l2, l3, l4, l5, order=order, method=method, kind=kind,
            device=dev, compute_dtype=dt,
        )
        if out is not None:
            logger.info("engine path: per-lag exact (K1 kernel)")
            return out

    grids = np.meshgrid(l1, l2, l3, l4, l5, indexing="ij")
    lags = np.stack([g.ravel() for g in grids], axis=-1)  # (L, 5)
    logger.info("engine path: per-lag gather")
    out = _evaluate_flat(
        torch.as_tensor(lags, dtype=dt, device=dev),
        to_tensor(small_img, device=dev, dtype=dt),
        to_tensor(ref_img, device=dev, dtype=dt),
        to_tensor(lon, device=dev, dtype=dt),
        to_tensor(lat, device=dev, dtype=dt),
        base_params, order, method, kind, batch_size)
    return out.reshape(shape)


def compute_world_grid(small_params: dict, h, w, kind, wrap, *, device,
                       compute_dtype="float32"):
    """World coordinates (deg) of the comparison grid, on ``device``."""
    dev = resolve_device(device)
    dt = resolve_dtype(compute_dtype)
    x = torch.arange(w, dtype=dt, device=dev).expand(h, w)
    y = torch.arange(h, dtype=dt, device=dev)[:, None].expand(h, w)
    lon, lat = wcs.pixel_to_world(small_params, x, y, kind=kind)
    if wrap:
        lon = wcs.ang2pipi_deg(lon)
        lat = wcs.ang2pipi_deg(lat)
    return lon.contiguous(), lat.contiguous()


def prepare_grid_and_submap(data_large, small_params, large_params, h, w,
                            kind, wrap, order, *, device,
                            compute_dtype="float32"):
    """Pipeline head: the comparison grid's world coordinates from the small
    header and the reference image resampled onto it (the submap step,
    reference ``alignment.py:987-1016``).

    Returns (lon, lat, ref_img) as (h, w) tensors on ``device``."""
    dev = resolve_device(device)
    dt = resolve_dtype(compute_dtype)
    lon, lat = compute_world_grid(small_params, h, w, kind, wrap, device=dev,
                                  compute_dtype=dt)
    xg, yg = wcs.world_to_pixel(large_params, lon, lat, kind=kind)
    ref_img = resample.sample_image(to_tensor(data_large, device=dev,
                                              dtype=dt), xg, yg, order=order)
    return lon, lat, ref_img


def resample_to_grid(image, x, y, order=2, *, device,
                     compute_dtype="float32"):
    """One-shot resample of ``image`` at pixel coordinates (x, y); float64
    numpy out."""
    dev = resolve_device(device)
    dt = resolve_dtype(compute_dtype)
    out = resample.sample_image(to_tensor(image, device=dev, dtype=dt),
                                to_tensor(x, device=dev, dtype=dt),
                                to_tensor(y, device=dev, dtype=dt),
                                order=order)
    return out.to(torch.float64).cpu().numpy()


def probe_pixel_points(h, w):
    """The 5 standard probe pixels (center + corners) as float64 (x, y)."""
    px0 = np.array([w // 2, 0, w - 1, 0, w - 1], dtype=np.float64)
    py0 = np.array([h // 2, 0, 0, h - 1, h - 1], dtype=np.float64)
    return px0, py0


def probe_values(lon, lat):
    """World coordinates at the 5 standard probe points (center + corners),
    as float64 numpy (one small device-to-host copy for tensors)."""
    h, w = lon.shape
    px0, py0 = probe_pixel_points(h, w)
    ii = py0.astype(np.int64)
    jj = px0.astype(np.int64)
    if isinstance(lon, torch.Tensor):
        it = torch.as_tensor(ii, device=lon.device)
        jt = torch.as_tensor(jj, device=lon.device)
        vals = torch.stack([lon[it, jt], lat[it, jt]]).to(torch.float64)
        pl, pb = vals.cpu().numpy()
    else:
        pl = np.asarray(lon, dtype=np.float64)[ii, jj]
        pb = np.asarray(lat, dtype=np.float64)[ii, jj]
    return pl, pb, px0, py0
