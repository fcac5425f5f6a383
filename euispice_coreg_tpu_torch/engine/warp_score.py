"""K1: fused per-lag WCS warp + masked-Pearson sums (Hopper kernel + host).

Counterpart of ``euispice_coreg_tpu/engine/pallas_warp.py`` and of the parts
of ``engine/pallas_common.py`` that its kernel needs.  For every lag of a
5-D lag grid (crval1/2, cdelt1/2, crota) the small image is warped onto the
comparison grid through the lagged WCS and scored against the reference
image by masked Pearson r; the kernel returns the six raw sums
[n, Sa, Saa, Sb, Sbb, Sab] per lag and the host finishes r in float64.

* :func:`warp_score_sums` is the kernel's wrapper: on a CUDA tensor it
  launches ``csrc/warp_score.cu`` (built at first use, engine/_build.py) or
  raises; on a CPU tensor it runs :func:`warp_score_sums_reference`, the
  plain torch version built from ``core.wcs.world_to_pixel`` and
  ``core.resample.sample_image``.  Any other device raises.
* :func:`evaluate_lag_grid_warp` is the host wrapper (the counterpart of
  ``evaluate_lag_grid_pallas``): lag table, centring, mirror-padded canvas,
  launch and finish.

The semantics are exactly ``sample_image``'s (mirror taps, NaN fill), so the
TPU kernel's residual bound, its 8-px decline and its select windows have no
counterpart here.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..core import resample, wcs
from ..utils import mesh as mesh_mod
from ..utils.torchcfg import resolve_device, resolve_dtype, to_tensor
from . import _build

# kernel launches made by warp_score_sums (CUDA tensors only)
LAUNCHES = 0

PAD = 2           # canvas mirror padding: order <= 2 taps reach 1 px out
TARGET_BLOCKS = 8192  # blocks per launch to aim for (132 SMs x many waves)
MAX_LAGS = 65535  # lags per launch (the C entry points' limit)
KINDS = {"tan": 0, "car": 1}
TABLE_KEYS = ("crval1", "crval2", "crpix1", "crpix2", "cdelt1", "cdelt2",
              "pc11", "pc12", "pc21", "pc22")


def lag_table(base: dict, lags: np.ndarray) -> np.ndarray:
    """Per-lag WCS parameters after the lag, (L, 10) float64 in
    :data:`TABLE_KEYS` order, with ``lag_search.apply_lag_to_params``
    semantics: the PC matrix is rebuilt from (CROTA, CDELT) when a cdelt or
    crota lag is nonzero and kept verbatim otherwise."""
    lags = np.asarray(lags, dtype=np.float64).reshape(-1, 5)
    cdelt1 = base["cdelt1"] + lags[:, 2]
    cdelt2 = base["cdelt2"] + lags[:, 3]
    crota = base.get("crota", 0.0) + lags[:, 4]
    rebuild = (lags[:, 2] != 0) | (lags[:, 3] != 0) | (lags[:, 4] != 0)
    rho = crota * wcs.RAD_PER_DEG
    lam = cdelt2 / cdelt1
    n = lags.shape[0]
    cols = [
        base["crval1"] + lags[:, 0],
        base["crval2"] + lags[:, 1],
        np.full(n, float(base["crpix1"])),
        np.full(n, float(base["crpix2"])),
        cdelt1,
        cdelt2,
        np.where(rebuild, np.cos(rho), base["pc11"]),
        np.where(rebuild, -lam * np.sin(rho), base["pc12"]),
        np.where(rebuild, np.sin(rho) / lam, base["pc21"]),
        np.where(rebuild, np.cos(rho), base["pc22"]),
    ]
    return np.stack(cols, axis=-1)


def pearson_from_sums(sums):
    """(L, >=6) raw sums -> (L,) Pearson r, float64 on host."""
    sums = np.asarray(sums, dtype=np.float64)
    n, Sa, Saa, Sb, Sbb, Sab = (sums[:, k] for k in range(6))
    with np.errstate(invalid="ignore", divide="ignore"):
        num = Sab - Sa * Sb / n
        den = np.sqrt((Saa - Sa * Sa / n) * (Sbb - Sb * Sb / n))
        return num / den


def warp_score_sums_reference(canvas, ref, lon, lat, table, *, pad, order,
                              kind):
    """Plain torch version of the kernel: (L, 6) float64 sums
    [n, Sa, Saa, Sb, Sbb, Sab], 8 lags at a time.  The canvas interior is
    the (centred) small image; ``sample_image`` mirrors its taps itself."""
    h, w = ref.shape
    small = canvas[pad:pad + h, pad:pad + w]
    finite_a = torch.isfinite(ref)
    out = []
    for s in range(0, table.shape[0], 8):
        t = table[s:s + 8]
        params = {k: t[:, i].reshape(-1, 1, 1)
                  for i, k in enumerate(TABLE_KEYS)}
        x, y = wcs.world_to_pixel(params, lon, lat, kind=kind)
        b = resample.sample_image(small, x, y, order=order)
        mask = finite_a & torch.isfinite(b)
        am = torch.where(mask, ref, 0.0).double()
        bm = torch.where(mask, b, 0.0).double()
        out.append(torch.stack([
            mask.sum((-2, -1)).double(), am.sum((-2, -1)),
            (am * am).sum((-2, -1)), bm.sum((-2, -1)),
            (bm * bm).sum((-2, -1)), (am * bm).sum((-2, -1)),
        ], dim=-1))
    return torch.cat(out)


def _check_operands(canvas, ref, lon, lat, table, pad, order, kind):
    dev, dt = canvas.device, canvas.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"warp_score takes float32 or float64, got {dt}")
    h, w = ref.shape
    for name, t, shape in (("canvas", canvas, (h + 2 * pad, w + 2 * pad)),
                           ("ref", ref, (h, w)), ("lon", lon, (h, w)),
                           ("lat", lat, (h, w))):
        if t.device != dev or t.dtype != dt:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, expected "
                            f"{dt} on {dev}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {shape}, got "
                             f"{tuple(t.shape)}")
    if (table.device != dev or table.dtype != dt or table.ndim != 2
            or table.shape[1] != len(TABLE_KEYS) or not table.is_contiguous()):
        raise ValueError("table: expected a contiguous (L, 10) tensor of the "
                         "canvas dtype and device")
    if not 1 <= table.shape[0] <= MAX_LAGS:
        raise ValueError(f"table: 1..{MAX_LAGS} lags per launch, got "
                         f"{table.shape[0]}")
    if order not in (0, 1, 2) or kind not in KINDS or not 1 <= pad:
        raise ValueError(f"unsupported order={order} kind={kind} pad={pad}")
    if min(h, w) < 2 or pad > min(h, w) - 1:
        raise ValueError(f"image {h}x{w} too small for a {pad}-px mirror pad")


def warp_score_sums(canvas, ref, lon, lat, table, *, pad, order, kind):
    """(L, 6) float64 masked-Pearson sums [n, Sa, Saa, Sb, Sbb, Sab] per lag.

    ``canvas`` is the small image, mean-centred and mirror-padded by ``pad``
    px, ``ref`` the mean-centred reference on the comparison grid, ``lon``
    and ``lat`` the grid's world coordinates (deg), ``table`` the per-lag
    WCS (:func:`lag_table`) in the canvas dtype.  CUDA tensors launch the
    kernel; CPU tensors run the plain version.
    """
    _check_operands(canvas, ref, lon, lat, table, pad, order, kind)
    if canvas.device.type == "cuda":
        return _launch(canvas, ref, lon, lat, table, pad=pad, order=order,
                       kind=kind)
    if canvas.device.type == "cpu":
        return warp_score_sums_reference(canvas, ref, lon, lat, table,
                                         pad=pad, order=order, kind=kind)
    raise RuntimeError(f"warp_score: no kernel for device {canvas.device}")


def build_tiles(lib, name):
    """``(lags per block, pixel tile rows, pixel tile columns)`` of a build
    of ``csrc/<name>.cu`` (its ``<name>_tiles`` entry point)."""
    out = (ctypes.c_int * 3)()
    fn = getattr(lib, f"{name}_tiles")
    fn.argtypes, fn.restype = [ctypes.c_void_p], None
    fn(ctypes.addressof(out))
    return tuple(out)


def launch_geometry(h, w, n_lags, tiles):
    """Grid of K1 and K2 (csrc/sampling.cuh) for an (h, w) grid and
    ``n_lags`` lags: ``(n_lag_tiles, n_groups)``.

    ``tiles`` is the build's :func:`build_tiles`.  A block scores the lags
    of one lag tile over every ``n_groups``-th pixel tile.  ``n_groups``
    aims at :data:`TARGET_BLOCKS` blocks in all, at most one group per pixel
    tile, so the grid and the (n_lags, n_groups, n_sums) float64 partial
    buffer stay bounded at any lag count."""
    lag_tile, tile_rows, tile_cols = tiles
    n_tiles = -(-h // tile_rows) * -(-w // tile_cols)
    n_lag_tiles = -(-n_lags // lag_tile)
    n_groups = max(1, min(n_tiles, -(-TARGET_BLOCKS // n_lag_tiles)))
    return n_lag_tiles, n_groups


def _kernel_fn(lib, dtype):
    fn = lib.warp_score_sums_f32 if dtype == torch.float32 \
        else lib.warp_score_sums_f64
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(canvas, ref, lon, lat, table, *, pad, order, kind):
    global LAUNCHES
    lib = _build.load("warp_score")
    fn = _kernel_fn(lib, canvas.dtype)
    h, w = ref.shape
    n_lags = table.shape[0]
    _, n_groups = launch_geometry(h, w, n_lags,
                                  build_tiles(lib, "warp_score"))
    dev = canvas.device
    partial = torch.empty((n_lags, n_groups, 6), dtype=torch.float64,
                          device=dev)
    out = torch.empty((n_lags, 6), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(canvas.data_ptr(), ref.data_ptr(), lon.data_ptr(),
                 lat.data_ptr(), table.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), h, w, pad, n_lags, n_groups, order,
                 KINDS[kind], stream)
    if err != 0:
        raise RuntimeError(f"warp_score kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


def k1_applies(method, order, small_shape, ref_shape) -> bool:
    """Whether K1 computes this search: masked Pearson (``correlation``) at
    spline order 0-2, with the reference on the small image's grid.
    :func:`evaluate_lag_grid_warp` declines everything else, and the
    ``"auto"`` router (``lag_search.route_mixed_grid``) asks the same
    question."""
    return (method == "correlation" and order in (0, 1, 2)
            and tuple(ref_shape) == tuple(small_shape))


def evaluate_lag_grid_warp(
    small_img, ref_img, lon, lat, base_params,
    lag_crval1, lag_crval2, lag_cdelt1, lag_cdelt2, lag_crota,
    *, order=2, method="correlation", kind="tan", device,
    compute_dtype="float32", mesh=None,
):
    """Engine-compatible evaluator backed by K1.

    Returns the (n1..n5) float64 hypercube, or None for what the kernel
    does not compute (a method other than correlation, order 3, or a
    reference image whose shape differs from the small image's).  Lags and
    ``base_params`` (WCS dict plus ``crota``) are in degrees.

    ``mesh``: a sequence of devices (:mod:`..utils.mesh`); the lag axis is
    split over them in contiguous ranges, the operands replicated to each
    device, every shard launched before the first is read back.  A shard
    with fewer lags may sum its float64 partials in another order
    (:func:`launch_geometry`), so r moves at rounding only.
    """
    if not k1_applies(method, order, np.shape(small_img), np.shape(ref_img)):
        return None
    dev = resolve_device(device)
    dt = resolve_dtype(compute_dtype)
    devices = mesh_mod.resolve_mesh(mesh) or (dev,)
    ls = [np.asarray(v, dtype=np.float64) for v in
          (lag_crval1, lag_crval2, lag_cdelt1, lag_cdelt2, lag_crota)]
    shape5 = tuple(len(v) for v in ls)
    grids = np.meshgrid(*ls, indexing="ij")
    lags = np.stack([g.ravel() for g in grids], axis=-1)

    small = to_tensor(small_img, device=dev, dtype=dt)
    ref = to_tensor(ref_img, device=dev, dtype=dt)
    h, w = small.shape
    lon_t = to_tensor(lon, device=dev, dtype=dt)
    lat_t = to_tensor(lat, device=dev, dtype=dt)

    # centring is exact for Pearson and keeps the float32 sums well
    # conditioned
    ref_c = (ref - torch.nanmean(ref.double()).to(dt)).contiguous()
    small_c = small - torch.nanmean(small.double()).to(dt)
    canvas = F.pad(small_c[None, None], (PAD, PAD, PAD, PAD),
                   mode="reflect")[0, 0].contiguous()
    table = lag_table(base_params, lags)
    ranges = mesh_mod.split(lags.shape[0], devices)
    operands = [mesh_mod.replicate(t, devices)
                for t in (canvas, ref_c, lon_t, lat_t)]
    # every upload before the first launch: a host-to-device copy waits
    # for its device's queue
    tables = [torch.as_tensor(table[a:b], dtype=dt, device=d)
              for (a, b), d in zip(ranges, devices)]
    parts = {}
    for k, s, e in mesh_mod.round_robin(ranges, MAX_LAGS):
        a = ranges[k][0]
        parts[s] = warp_score_sums(
            *(op[k] for op in operands), tables[k][s - a:e - a],
            pad=PAD, order=order, kind=kind)
    r = pearson_from_sums(mesh_mod.gather(parts).numpy())
    return r.reshape(shape5)
