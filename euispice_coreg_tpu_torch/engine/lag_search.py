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
* ``allow_fast="block"`` on mixed grids at order 0/2: the block path, one
  warp per (cdelt1, cdelt2, crota) combo and the CRVAL sub-grid on FFT
  surfaces (:func:`_evaluate_block_fast`);
* otherwise the exact per-lag engine: K1 on a CUDA device for correlation
  at order 0-2 (it computes exactly the per-lag gather's numbers), the torch
  per-lag gather in lag chunks for everything else.

``mesh`` (a sequence of devices, :mod:`..utils.mesh`) is passed on to every
path: K1 and the gather split the lags over the devices, the FFT paths the
surface planes.

:func:`route_mixed_grid` is ``Alignment``'s ``"auto"`` choice for mixed
grids: on a CUDA device K1 or the block path by a cost model measured on
the card, elsewhere the JAX package's rule (the block path above 2000
candidates).  The JAX package's TPU workarounds are not carried over
(the gather-free select and upsample samplers, chunk retries, probe and
plan caches).
"""
from __future__ import annotations

import logging
import weakref

import numpy as np
import torch

from ..core import resample, score, wcs
from ..utils import mesh as mesh_mod
from ..utils.obs import Progress, logger, stage
from ..utils.torchcfg import resolve_device, resolve_dtype, to_tensor
from . import warp_score

# lag vector layout along the last axis of the (L, 5) lag matrix
D_CRVAL1, D_CRVAL2, D_CDELT1, D_CDELT2, D_CROTA = range(5)


# The "auto" router's cost model of a mixed grid on a CUDA device
# (:func:`estimate_mixed_grid_seconds`), fitted by chip_smoke.py phase R on
# one NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md section 6:
# 2048^2 at 11^2-51^2 CRVAL lags x 3 combos, 21^2 x 9 combos and at order
# 0, and a 1024 x 192 SPICE raster at 21^2 x 9).  It steers the
# choice between K1 and the block path only, never a reported number.
#
# K1 (lag_search_mode="pallas"): seconds per pixel-lag at the block path's
# orders (7.72e-12 at order 2, 5.98e-12 at order 0), and what the engine
# spends around the launch (the lag table, the centred canvas, the
# read-back).
_EST_K1_S_PER_PIXEL_LAG = {0: 6.0e-12, 2: 7.7e-12}
_EST_K1_S = 0.0025
# The block path (lag_search_mode="fast"): per combo, the warp and a fixed
# cost, and the float64 surfaces at 5.13e-11 s per element of the m x m
# forward and inverse transform planes (:func:`_block_planes`); per lag,
# the host displacement chain, the read-out and the host combine.
_EST_BLOCK_S_PER_COMBO = 0.005
_EST_BLOCK_S_PER_PLANE_ELEM = 5.1e-11
_EST_BLOCK_S_PER_LAG = 2.3e-6
# Above this many candidates the JAX package sends a mixed grid to the
# block path (its alignment.py:603, a TPU choice); the rule off a card.
JAX_BLOCK_MIN_LAGS = 2000


def _block_planes(order, method):
    """Forward and inverse transform planes of one block-path combo: the
    g and r fields (:func:`fast_corr._fields`) and the product surfaces."""
    from . import fast_corr

    nt = len(fast_corr._tap_offsets(order)) ** 2
    n_g = 3 if method == "correlation" else 6
    score = "pearson" if method == "correlation" else "residus"
    return n_g + 1 + nt + nt * (nt + 1) // 2 + fast_corr._n_surfaces(order,
                                                                     score)


def estimate_mixed_grid_seconds(n_crval, n_combos, h, w, *, order, method,
                                n_shards=1):
    """(K1 seconds, block-path seconds) of a mixed grid of ``n_crval`` CRVAL
    lags per (cdelt1, cdelt2, crota) combo and ``n_combos`` combos, for an
    h x w small image at spline order 0 or 2 on a CUDA device (the
    constants above, measured on an H100).  The block path's transforms
    are m x m with m the FFT size of the longer side (the CRVAL shift's few
    pixels left out).  A mesh of ``n_shards`` devices divides K1's lags and
    the block path's surface planes; K1's constant, the warp and the host
    terms stay whole (not measured across cards)."""
    from . import fast_corr

    n_lags = n_crval * n_combos
    rate = _EST_K1_S_PER_PIXEL_LAG[order]
    t_k1 = _EST_K1_S + rate * h * w * n_lags / n_shards
    m = fast_corr._fft_size(max(h, w) + 4)
    t_blk = _EST_BLOCK_S_PER_LAG * n_lags + n_combos * (
        _EST_BLOCK_S_PER_COMBO + _EST_BLOCK_S_PER_PLANE_ELEM
        * _block_planes(order, method) * m * m / n_shards)
    return t_k1, t_blk


def route_mixed_grid(n_crval1, n_crval2, n_combos, h, w, *, order, method,
                     device_type, n_shards=1, ref_shape=None):
    """``allow_fast`` for a mixed grid (cdelt or crota lags) under
    ``lag_search_mode="auto"``: ``"pallas"`` (K1), ``"block"`` (the block
    path) or True (the exact engine).

    Off a CUDA device: the JAX package's rule, the block path above
    :data:`JAX_BLOCK_MIN_LAGS` candidates, so the CPU keeps its routes.  On
    a CUDA device, where both K1 (:func:`warp_score.k1_applies`; the
    reference's shape ``ref_shape`` defaults to the small image's) and the
    block path (correlation or ``residus_masked`` at order 0 or 2) apply,
    the cheaper by :func:`estimate_mixed_grid_seconds`: K1 costs per
    pixel-lag, the block path per combo, so they cross at a number of CRVAL
    lags per combo.  A mesh of ``n_shards`` devices splits both (K1 the
    lags, the block path the surface planes), so they are compared per
    shard.  Where only K1 applies, K1; where only the block path, the JAX
    package's rule; where neither, the exact engine.  K1 is never chosen
    where it declines.  Logs the decision."""
    n_lags = n_crval1 * n_crval2 * n_combos
    jax_rule = "block" if n_lags > JAX_BLOCK_MIN_LAGS else True
    grid = (f"{n_combos} combos x {n_crval1 * n_crval2} crval lags, "
            f"{h}x{w}")
    if device_type != "cuda":
        logger.info("auto route: %d candidates, the JAX package's rule off "
                    "a card (block above %d) (%s) -> %s", n_lags,
                    JAX_BLOCK_MIN_LAGS, grid, jax_rule)
        return jax_rule
    k1_ok = warp_score.k1_applies(method, order, (h, w), ref_shape or (h, w))
    block_ok = method in ("correlation", "residus_masked") and order in (0, 2)
    if k1_ok and block_ok:
        t_k1, t_blk = estimate_mixed_grid_seconds(
            n_crval1 * n_crval2, n_combos, h, w, order=order, method=method,
            n_shards=n_shards)
        route = "pallas" if t_k1 <= t_blk else "block"
        logger.info("auto route: K1 est %.1f ms vs block est %.1f ms (%s, "
                    "%d shard(s)) -> %s", t_k1 * 1e3, t_blk * 1e3, grid,
                    n_shards, route)
        return route
    route = "pallas" if k1_ok else (jax_rule if block_ok else True)
    logger.info("auto route: %s (%s, %s at order %d) -> %s",
                "K1 alone applies" if k1_ok else
                "the block path alone applies" if block_ok else
                "neither K1 nor the block path applies", grid, method, order,
                route)
    return route


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
                   batch_size, devices):
    """Exact per-lag engine: warp + score ``batch_size`` lags at a time
    (the counterpart of the JAX ``_score_one_lag``/``_evaluate_flat``), the
    lags split over ``devices`` (the JAX ``_sharded_evaluator``), the
    operands replicated.  ``lags`` is an (L, 5) host array.  Returns an (L,)
    float64 numpy array."""
    n_lags = lags.shape[0]
    fn = score.SCORE_FUNCTIONS[method]
    dt = small.dtype
    ranges = mesh_mod.split(n_lags, devices)
    ops = [mesh_mod.replicate(t, devices) for t in (small, ref, lon, lat)]
    lags_d = [torch.as_tensor(lags[a:b], dtype=dt, device=d)
              for (a, b), d in zip(ranges, devices)]
    parts = {}
    prog = Progress(total=n_lags, label="gather lag search",
                    enabled=n_lags > batch_size)
    for k, s, e in mesh_mod.round_robin(ranges, batch_size):
        small_k, ref_k, lon_k, lat_k = (op[k] for op in ops)
        d = lags_d[k][s - ranges[k][0]:e - ranges[k][0]]
        params = {key: v[:, None, None]
                  for key, v in apply_lag_to_params(base, d).items()}
        x, y = wcs.world_to_pixel(params, lon_k, lat_k, kind=kind)
        sampled = resample.sample_image(small_k, x, y, order=order)
        parts[s] = fn(ref_k, sampled).to(torch.float64)
        prog.step(e - s)
    return mesh_mod.gather(parts).numpy()


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
    mesh=None,
    allow_fast=True,
) -> np.ndarray:
    """Score the full 5-D lag hypercube; returns shape
    (n_crval1, n_crval2, n_cdelt1, n_cdelt2, n_crota) as float64 numpy.

    All lag arrays and ``base_params`` (WCS dict plus ``crota``) are in
    DEGREES.  Images and coordinate grids may be numpy arrays or tensors;
    they are moved to ``device`` in ``compute_dtype``.  ``mesh``: a sequence
    of devices the work is split over (None: ``device`` alone); K1 runs on
    the exact-engine route when the mesh's devices are CUDA devices.
    """
    l1 = np.asarray(lag_crval1, dtype=np.float64)
    l2 = np.asarray(lag_crval2, dtype=np.float64)
    l3 = np.asarray(lag_cdelt1, dtype=np.float64)
    l4 = np.asarray(lag_cdelt2, dtype=np.float64)
    l5 = np.asarray(lag_crota, dtype=np.float64)
    shape = (len(l1), len(l2), len(l3), len(l4), len(l5))
    dev = resolve_device(device)
    dt = resolve_dtype(compute_dtype)
    devices = mesh_mod.resolve_mesh(mesh)
    run_dev = devices[0] if devices else dev

    if allow_fast == "pallas":
        out = warp_score.evaluate_lag_grid_warp(
            small_img, ref_img, lon, lat, base_params,
            l1, l2, l3, l4, l5, order=order, method=method, kind=kind,
            device=dev, compute_dtype=dt, mesh=devices,
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
                method=method, mesh=devices,
            )
            if fast is not None:
                logger.info("engine path: FFT fast (crval grid)")
                return fast.reshape(shape)
            logger.info("engine path: FFT fast preconditions failed, "
                        "falling back")
        elif allow_fast == "block" and order in (0, 2):
            fast = _evaluate_block_fast(
                small_img, ref_img, lon, lat, base_params, l1, l2, l3, l4, l5,
                order=order, kind=kind, device=dev, compute_dtype=dt,
                method=method, mesh=devices)
            if fast is not None:
                logger.info("engine path: FFT block fast (mixed grid)")
                return fast

    if (run_dev.type == "cuda" and method == "correlation"
            and order in (0, 1, 2)):
        out = warp_score.evaluate_lag_grid_warp(
            small_img, ref_img, lon, lat, base_params,
            l1, l2, l3, l4, l5, order=order, method=method, kind=kind,
            device=dev, compute_dtype=dt, mesh=devices,
        )
        if out is not None:
            logger.info("engine path: per-lag exact (K1 kernel)")
            return out

    grids = np.meshgrid(l1, l2, l3, l4, l5, indexing="ij")
    lags = np.stack([g.ravel() for g in grids], axis=-1)  # (L, 5)
    logger.info("engine path: per-lag gather")
    out = _evaluate_flat(
        lags,
        to_tensor(small_img, device=dev, dtype=dt),
        to_tensor(ref_img, device=dev, dtype=dt),
        to_tensor(lon, device=dev, dtype=dt),
        to_tensor(lat, device=dev, dtype=dt),
        base_params, order, method, kind, batch_size, devices or (dev,))
    return out.reshape(shape)


def _apply_lag_to_params_np(base: dict, d5) -> dict:
    """Host float64 twin of :func:`apply_lag_to_params` for one lag vector:
    the PC matrix is rebuilt only when a cdelt or crota lag is nonzero."""
    crval1 = base["crval1"] + d5[0]
    crval2 = base["crval2"] + d5[1]
    cdelt1 = base["cdelt1"] + d5[2]
    cdelt2 = base["cdelt2"] + d5[3]
    crota = base["crota"] + d5[4]
    out = dict(base, crval1=crval1, crval2=crval2,
               cdelt1=cdelt1, cdelt2=cdelt2, crota=crota)
    if d5[2] != 0 or d5[3] != 0 or d5[4] != 0:
        rho = np.deg2rad(crota)
        lam = cdelt2 / cdelt1
        out["pc11"] = np.cos(rho)
        out["pc12"] = -lam * np.sin(rho)
        out["pc21"] = np.sin(rho) / lam
        out["pc22"] = np.cos(rho)
    return out


def _warp_by_params(img, lon, lat, params, kind, order):
    """``img`` warped onto the (lon, lat) grid through the WCS ``params``
    (host scalars, made tensors of the grid's dtype), on the grid's
    device."""
    x, y = wcs.world_to_pixel(params, lon, lat, kind=kind)
    return resample.sample_image(img, x, y, order=order)


def _evaluate_block_fast(small_img, ref_img, lon, lat, base_params,
                         l1, l2, l3, l4, l5, *, order, kind, device,
                         compute_dtype, method="correlation", mesh=None):
    """Block fast path for mixed lag grids.

    For each (cdelt1, cdelt2, crota) combo the small image is warped once
    onto the comparison grid through the combo's WCS; the crval1 x crval2
    sub-grid then factorizes over FFT correlation surfaces as in
    :mod:`.fast_corr`, with every combo's displacements conjugated into the
    grid's pixel space in one host chain.  Combos run one after another,
    one warp resident at a time, each combo's surface planes split over
    ``mesh``.

    The spline interpolation is applied twice (pre-warp + per-lag tap
    stencil) where the exact engine interpolates once: a sub-percent
    smoothing of the values, argmax unchanged.  Returns the 5-D hypercube,
    or None when the spread gate (checked before any warp) or a frame-size
    precondition fails (the caller then runs the exact engine).
    """
    from . import fast_corr

    combos = [(i3, i4, i5,
               _apply_lag_to_params_np(base_params,
                                       np.array([0.0, 0.0, d3, d4, d5])))
              for i3, d3 in enumerate(l3)
              for i4, d4 in enumerate(l4)
              for i5, d5 in enumerate(l5)]
    g1, g2 = np.meshgrid(l1, l2, indexing="ij")
    lags2 = np.stack([g1.ravel(), g2.ravel()], axis=-1)     # (L, 2) deg
    with stage("fast_hostprep_s"):
        cs, spreads = fast_corr.displacement_per_lag_multi(
            [combo for _i3, _i4, _i5, combo in combos], lags2, lon, lat,
            kind, grid=base_params)
    if float(np.max(spreads)) > fast_corr.MAX_DISPLACEMENT_SPREAD_PX:
        return None

    out = np.zeros((len(l1), len(l2), len(l3), len(l4), len(l5)))
    small_d = to_tensor(small_img, device=device, dtype=compute_dtype)
    ref_d = to_tensor(ref_img, device=device, dtype=compute_dtype)
    lon_d = to_tensor(lon, device=device, dtype=compute_dtype)
    lat_d = to_tensor(lat, device=device, dtype=compute_dtype)
    for k, (i3, i4, i5, combo) in enumerate(combos):
        params = {key: v for key, v in combo.items() if key != "crota"}
        with stage("block_warp_s", card=True):
            warped = _warp_by_params(small_d, lon_d, lat_d, params, kind,
                                     order)
        vals = fast_corr.evaluate_from_displacements(
            warped, ref_d, cs[k], spreads[k], order=order, device=device,
            compute_dtype=compute_dtype, method=method, mesh=mesh)
        if vals is None:
            return None
        out[:, :, i3, i4, i5] = vals.reshape(len(l1), len(l2))
    return out


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
    with stage("api_submap_s", card=True, level=logging.INFO):
        lon, lat = compute_world_grid(small_params, h, w, kind, wrap,
                                      device=dev, compute_dtype=dt)
        xg, yg = wcs.world_to_pixel(large_params, lon, lat, kind=kind)
        ref_img = resample.sample_image(to_tensor(data_large, device=dev,
                                                  dtype=dt), xg, yg,
                                        order=order)
    return lon, lat, ref_img


def resample_to_grid(image, x, y, order=2, compute_dtype="float32", *,
                     device):
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


# probe values given by the code that built a grid (seed_probe_values):
# (id(lon), id(lat)) -> (weak reference to lon, to lat, pl, pb)
_SEEDED_PROBES: dict = {}


def seed_probe_values(lon, lat, pl, pb):
    """Give the 5 probe world values of freshly built grid tensors as the
    grid's builder computed them from its WCS in float64 (the JAX
    package's ``Alignment`` does, alignment.py:448-461): :func:`probe_values`
    then returns them for these two tensors instead of reading the grid,
    whose float32 values may sit ~0.01 px off the WCS.  The fast paths'
    displacement model is built from them, so the hypercube follows the
    JAX package's.  Held by weak reference only; no-op for numpy arrays."""
    if not isinstance(lon, torch.Tensor):
        return
    key = (id(lon), id(lat))
    _SEEDED_PROBES[key] = (
        weakref.ref(lon, lambda _: _SEEDED_PROBES.pop(key, None)),
        weakref.ref(lat), np.asarray(pl, dtype=np.float64),
        np.asarray(pb, dtype=np.float64))


def probe_values(lon, lat):
    """World coordinates at the 5 standard probe points (center + corners),
    as float64 numpy (one small device-to-host copy for tensors; the seeded
    values for tensors given to :func:`seed_probe_values`)."""
    h, w = lon.shape
    px0, py0 = probe_pixel_points(h, w)
    seed = _SEEDED_PROBES.get((id(lon), id(lat)))
    if seed is not None and seed[0]() is lon and seed[1]() is lat:
        return seed[2], seed[3], px0, py0
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
