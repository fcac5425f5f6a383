"""Tile-local FFT factorization of the quadratic-displacement lag search
(torch).

Counterpart of ``euispice_coreg_tpu/engine/tile_fft.py`` and of the
tile-bound helpers of ``engine/pallas_quad.py`` (:func:`_tile_bounds`,
:func:`_tile_bounds_per_lag`, :func:`_shift_bound`, host numpy, copied).
The Carrington select path (``engine/carrington._carrington_select``)
scores L lags by sampling a pre-warped canvas through per-lag quadratic
displacement fields; kernel K2 (:mod:`.quad_score`) does that lag by lag.
This module scores the whole lag grid over tile-local correlation surfaces
instead:

* within a tile of ``th x tw`` grid pixels each lag's displacement is
  replaced by its value at the tile centre: a constant integer offset plus
  constant fractional spline weights;
* per tile, every masked-Pearson (or residue) sum then factorizes over
  cross-correlation surfaces between the reference tile and the shifted
  canvas fields, as in ``engine/fast_corr.py``: 3 (or 6) g planes and 55 r
  planes forward, 66 surface planes back, evaluated once for ALL lags;
* per (tile, lag): one gather of the 66 surface values at the tile's
  integer offset and the fractional tap-weight combination (stage 2).

The within-tile displacement deviation, in DETECTOR pixels, must stay below
``tol_det`` (:data:`TOL_DET_PX`); the tile shape is picked adaptively and
:func:`evaluate_select_tile_fft` returns None (the caller falls back) when
no shape meets the bound, or when the working set or the estimated stage-1
time is beyond the planning limits.

Device work is torch code: ``torch.fft.rfft2`` (cuFFT on a card) batched
over tiles and planes, complex conjugate products, the inverse by
``torch.fft.irfft2`` cropped to the offset box, ``torch.gather`` for the
readout.  No matmul is left (the quadratic field is evaluated term by
term), so nothing here depends on the TF32 setting.  Not carried over: the
real-folded partial-DFT matmuls and their precision setting (a TPU layer:
``irfft2`` plus a crop gives the same circular-correlation values), the
one-hot readout, the memo caches of the gate and the bounds and the
environment variables (``tile_batch`` and ``mem_budget_bytes`` are keyword
arguments).

Sharding (``mesh=``, a sequence of devices, :mod:`..utils.mesh`): the tile
axis is split over the devices, the fields replicated to each distinct
device; each device scans its tiles group by group and the (L, 6) partial
sums are added on the first device (the JAX ``psum``).  A device that holds
several shards runs them in its own stream order, one group resident at a
time.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import mesh as mesh_mod
from ..utils.obs import logger, stage
from ..utils.torchcfg import resolve_device, resolve_dtype, to_tensor

# Within-tile sampling-position tolerance, DETECTOR pixels (the JAX
# package's value and calibration).
TOL_DET_PX = 0.15

# Largest first: bigger tiles amortize the per-tile transforms; 96/64 let
# narrow-wide rectangles pass on weakly oversampled grids.
_TILE_SIZES = (1024, 768, 512, 384, 256, 192, 128, 96, 64)
_MAX_TILES = 1100

# Planning constants, set from chip_smoke.py slice I on one NVIDIA H100
# 80GB HBM3 at a 700 W power limit (PERF.md section 6, PR 7).  They steer
# host-side planning only (shape ranking, the screens, declines), never a
# reported number.
#
# Working-set budget of the resident terms: the padded r stack and the
# per-tile surface boxes of one group.  Slice C's plan (24 tiles) holds
# 3.40 GB of them and peaked 4.79 GB above its operands in float32; the
# coarse grid's 704-tile plan runs in groups of 23 under this budget and
# peaked 37.6 GB.  The rest of the 80 GB card is left for the canvases,
# one tile batch's spectra and products and stage 2's (tiles, 66, L)
# values.
MEM_BUDGET_BYTES = 32e9
# Tiles per stage-1 step: slice C's evaluation took 101.8-148.5 ms at
# batch 1 / 2 / 4 / 8 over three runs, with no trend; 1 holds the least.
TILE_BATCH = 1
# Stage-1 throughput: plane elements (tiles x planes x my x mx) per second
# through the forward transforms, the products and the inverse; slice C's
# 3.07e9 elements took 66.3 ms (4.63e10/s).
_EST_STAGE1_ELEMS_PER_S = 4.6e10
_MAX_STAGE1_SECONDS = 15.0
# K2's cost per lag (lag_search_mode="pallas"): 310.85 ms for 14641 lags at
# 2048^2 (2.12e-5 s).  The hybrid screen's alternative as it stands (blind
# to the grid, as in the JAX package); the card's cost model of "auto"
# (``vs_k2``) scales it by the grid's pixels (:func:`_est_k2_seconds`).
_EST_PALLAS_S_PER_LAG = 2.1e-5
_EST_K2_GRID_PIXELS = 2048 * 2048
# What tile-FFT's select spends around stage 1 (the gate, the bounds, the
# field build, stage 2): slice C's select took 109.1 ms, stage 1 66.2 ms;
# 96 ms around stage 1 in a run on a busier host.
_EST_SELECT_OVERHEAD_S = 0.043


def _plane_counts(order: int) -> tuple[int, int]:
    """(n_surf, n_rfields): per-tile surface planes emitted by stage 1 and
    padded r field planes."""
    nt = _tap_count(order) ** 2
    npairs = nt * (nt + 1) // 2
    return 3 + 2 * nt + npairs, 1 + nt + npairs


def _hbm_group_plan(order, by, bx, Htot, Wtot, itemsize, batch, budget):
    """Working-set planner shared by the evaluator's guard and the hybrid
    picker's screen.

    The resident terms are the padded r stack (n_rf, Htot, Wtot) and the
    per-tile surface boxes (group, n_surf, by, bx).  ``group`` is the
    largest number of tiles whose boxes fit in ``budget`` beside the r
    stack, rounded down to a multiple of ``batch``.  Returns ``(group,
    rpad_bytes, box_bytes_per_tile)``: ``group < batch`` means even one
    step cannot fit (the caller declines)."""
    n_surf, n_rf = _plane_counts(order)
    bt = n_surf * by * bx * itemsize
    rpad_bytes = n_rf * Htot * Wtot * itemsize
    group = int((budget - rpad_bytes) // max(bt, 1))
    group -= group % max(batch, 1)
    return group, rpad_bytes, bt


def _clamped_batch(tile_batch, n_tiles, mesh=None):
    """Tiles per stage-1 step: ``tile_batch`` (default :data:`TILE_BATCH`)
    clamped to the tiles one device scans (all of them, or its share of a
    ``mesh``: a wider batch would only pad)."""
    n = len(mesh) if mesh is not None else 1
    return max(1, min(int(TILE_BATCH if tile_batch is None else tile_batch),
                      -(-n_tiles // n)))


def _est_stage1_seconds(n_tiles: int, n_planes: int, my: int, mx: int):
    """Estimated stage-1 time: plane elements at
    :data:`_EST_STAGE1_ELEMS_PER_S`."""
    return n_tiles * n_planes * my * mx / _EST_STAGE1_ELEMS_PER_S


def _est_k2_seconds(n_lags: int, h: int, w: int):
    """Estimated time of K2 on ``n_lags`` lags of an h x w grid:
    :data:`_EST_PALLAS_S_PER_LAG` scaled by the grid's pixels."""
    return n_lags * _EST_PALLAS_S_PER_LAG * (h * w / _EST_K2_GRID_PIXELS)


def k2_is_cheaper(n_lags, h, w):
    """True when K2 on ``n_lags`` lags is estimated to cost no more than
    what tile-FFT spends around its transforms: tile-FFT cannot win."""
    return _est_k2_seconds(n_lags, h, w) <= _EST_SELECT_OVERHEAD_S


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def _tap_count(order: int) -> int:
    return 1 if order == 0 else 3


def _quad_eval(coeffs, u, v):
    """The (L, 6, 2) quadratic displacement maps at points (u, v): (L, P, 2).

    coeffs columns: [x, y, 1, x^2, y^2, x*y] -> (dx, dy).  numpy inputs
    contract with ``einsum``; tensors term by term (no matmul)."""
    if isinstance(coeffs, torch.Tensor):
        basis = (u, v, torch.ones_like(u), u * u, v * v, u * v)
        out = coeffs[:, 0, None, :] * basis[0][None, :, None]
        for k in range(1, 6):
            out = out + coeffs[:, k, None, :] * basis[k][None, :, None]
        return out
    basis = np.stack([u, v, np.ones_like(u), u * u, v * v, u * v], axis=0)
    return np.einsum("lck,cp->lpk", coeffs, basis)


# ---------------------------------------------------------------------------
# tile bounds (host numpy; JAX engine/pallas_quad.py:188-255)
# ---------------------------------------------------------------------------

def _tile_bounds(coeffs, h, w, n_ty, n_tx, th, tw):
    """(dev_x, dev_y, g_bound): the max over lags of
    :func:`_tile_bounds_per_lag` and :func:`_shift_bound`."""
    dev_l = _tile_bounds_per_lag(coeffs, h, w, n_ty, n_tx, th=th, tw=tw)
    dev_x = float(np.max(dev_l[:, 0])) if dev_l.size else 0.0
    dev_y = float(np.max(dev_l[:, 1])) if dev_l.size else 0.0
    g_bound = _shift_bound(coeffs, h, w, n_ty, n_tx, th=th, tw=tw)
    return dev_x, dev_y, g_bound


def _tile_bounds_per_lag(coeffs, h, w, n_ty, n_tx, th, tw):
    """Per-lag within-tile deviation bound (L, 2) in (x, y) order: the
    field's gradient at the four corner tile centres times the half tile,
    plus the pure-quadratic term."""
    L = coeffs.shape[0]
    u0 = 0.5 * (0 + min(tw - 1, w - 1))
    u1 = 0.5 * ((n_tx - 1) * tw + min(n_tx * tw - 1, w - 1))
    v0 = 0.5 * (0 + min(th - 1, h - 1))
    v1 = 0.5 * ((n_ty - 1) * th + min(n_ty * th - 1, h - 1))
    uu, vv = np.meshgrid([u0, u1], [v0, v1], indexing="ij")
    uu, vv = uu.ravel(), vv.ravel()                           # (4,)
    ck = np.ascontiguousarray(coeffs.transpose(0, 2, 1)).reshape(L * 2, 6)

    one = np.ones_like(uu)
    zero = 0 * uu
    basis_gu = np.stack([one, zero, zero, 2.0 * uu, zero, vv])
    basis_gv = np.stack([zero, one, zero, zero, 2.0 * vv, uu])
    hx_m, hy_m = 0.5 * (tw - 1), 0.5 * (th - 1)
    gu = np.abs((ck @ basis_gu).reshape(L, 2, -1))
    gv = np.abs((ck @ basis_gv).reshape(L, 2, -1))
    quad = (np.abs(coeffs[:, 3, :, None]) * (hx_m * hx_m)
            + np.abs(coeffs[:, 4, :, None]) * (hy_m * hy_m)
            + np.abs(coeffs[:, 5, :, None]) * (hx_m * hy_m))
    dev = gu * hx_m + gv * hy_m + quad                        # (L, 2, 4)
    return dev.max(axis=2)                                    # (L, 2) x/y


def _shift_bound(coeffs, h, w, n_ty, n_tx, th, tw):
    """Conservative bound on max |tile-centre shift| over all lags and
    tiles: the bilinear part maxed over the four corner tile centres plus
    the pure-quadratic worst case over the whole centre rectangle."""
    L = coeffs.shape[0]
    u0 = 0.5 * (0 + min(tw - 1, w - 1))
    u1 = 0.5 * ((n_tx - 1) * tw + min(n_tx * tw - 1, w - 1))
    v0 = 0.5 * (0 + min(th - 1, h - 1))
    v1 = 0.5 * ((n_ty - 1) * th + min(n_ty * th - 1, h - 1))
    uu, vv = np.meshgrid([u0, u1], [v0, v1], indexing="ij")
    uu, vv = uu.ravel(), vv.ravel()                           # (4,)
    ck = np.ascontiguousarray(coeffs.transpose(0, 2, 1)).reshape(L * 2, 6)
    one = np.ones_like(uu)
    zero = 0 * uu
    basis_bil = np.stack([uu, vv, one, zero, zero, zero])
    bil = np.abs((ck @ basis_bil))                            # (L*2, 4)
    umax, vmax = max(abs(u0), abs(u1)), max(abs(v0), abs(v1))
    quad_res = (np.abs(coeffs[:, 3, :]) * umax * umax
                + np.abs(coeffs[:, 4, :]) * vmax * vmax
                + np.abs(coeffs[:, 5, :]) * umax * vmax)
    return int(np.ceil(np.max(bil) + np.max(quad_res) + 0.5)) \
        if bil.size else 0


# ---------------------------------------------------------------------------
# gates and tile-shape pickers (host)
# ---------------------------------------------------------------------------

def _tile_offset_bounds(coeffs_d, th, tw, n_ty, n_tx):
    """Per-tile [min, max] of the rounded tile-centre offsets over all lags,
    on the device in the coefficients' dtype (the readout's own
    ``floor(c + 0.5)``; the +-1 slack covers rounding between the two).
    Returns two (n_tiles, 2) int64 numpy arrays in (x, y) order."""
    dt = coeffs_d.dtype
    t = torch.arange(n_ty * n_tx, device=coeffs_d.device)
    u = ((t % n_tx) * tw).to(dt) + (tw - 1) / 2.0
    v = ((t // n_tx) * th).to(dt) + (th - 1) / 2.0
    o = torch.floor(_quad_eval(coeffs_d, u, v) + 0.5)     # (L, n_tiles, 2)
    return ((o.amin(dim=0) - 1).to(torch.int64).cpu().numpy(),
            (o.amax(dim=0) + 1).to(torch.int64).cpu().numpy())


def _per_tile_offset_bounds(coeffs, th, tw, n_ty, n_tx):
    """Host float64 form of :func:`_tile_offset_bounds`, one (L, 2)
    temporary per tile."""
    n_tiles = n_ty * n_tx
    o_min_t = np.empty((n_tiles, 2), dtype=np.int64)
    o_max_t = np.empty((n_tiles, 2), dtype=np.int64)
    for t in range(n_tiles):
        u = (t % n_tx) * tw + (tw - 1) / 2.0
        v = (t // n_tx) * th + (th - 1) / 2.0
        c = _quad_eval(coeffs, np.array([u]), np.array([v]))[:, 0, :]  # (L,2)
        o = np.floor(c + 0.5)
        o_min_t[t] = o.min(axis=0) - 1
        o_max_t[t] = o.max(axis=0) + 1
    return o_min_t, o_max_t  # each (n_tiles, 2) in (x, y) order


def pick_tile_size(coeffs, h, w, scale_det_per_grid, tol_det=TOL_DET_PX,
                   tile_sizes=_TILE_SIZES, max_tiles=_MAX_TILES):
    """Largest SQUARE tile size whose within-tile displacement deviation,
    in detector pixels, meets ``tol_det``.  Returns (T, dev_det) or None."""
    for T in tile_sizes:
        n_ty = -(-h // T)
        n_tx = -(-w // T)
        if n_ty * n_tx > max_tiles:
            continue
        dev_x, dev_y, _ = _tile_bounds(coeffs, h, w, n_ty, n_tx, th=T, tw=T)
        dev_det = max(dev_x, dev_y) * scale_det_per_grid
        if dev_det <= tol_det:
            return T, dev_det
    return None


def pick_tile_shape(coeffs, h, w, scale_det_per_grid, tol_det=TOL_DET_PX,
                    tile_sizes=_TILE_SIZES, max_tiles=_MAX_TILES):
    """Cheapest RECTANGULAR tile shape meeting the deviation gate.

    Cost model: n_tiles x round128(th + span_y) x round128(tw + span_x),
    the offset span estimated once from the image-centre offsets.
    Candidates are screened on a lag subsample (its max is a lower bound,
    so a subsample failure is sound) and the survivors checked on every lag
    in cost order.  Returns ((th, tw), dev_det) or None."""
    uc = np.array([(w - 1) / 2.0])
    vc = np.array([(h - 1) / 2.0])
    c = _quad_eval(coeffs, uc, vc)[:, 0, :]                     # (L, 2)
    span_x, span_y = (np.ceil(c.max(axis=0)) - np.floor(c.min(axis=0)) + 3)

    L = coeffs.shape[0]
    sub = coeffs[:: max(1, L // 256)] if L > 512 else coeffs

    cands = []
    for th in tile_sizes:
        n_ty = -(-h // th)
        for tw in tile_sizes:
            n_tx = -(-w // tw)
            if n_ty * n_tx > max_tiles:
                continue
            dev_x, dev_y, _ = _tile_bounds(sub, h, w, n_ty, n_tx, th=th,
                                           tw=tw)
            if max(dev_x, dev_y) * scale_det_per_grid > tol_det:
                continue  # sound: the full-lag max can only be larger
            cost = (n_ty * n_tx * _round128(th + span_y + 2 * dev_y)
                    * _round128(tw + span_x + 2 * dev_x))
            cands.append((cost, th, tw, n_ty, n_tx))

    for _cost, th, tw, n_ty, n_tx in sorted(cands):
        dev_x, dev_y, _g = _tile_bounds(coeffs, h, w, n_ty, n_tx, th=th,
                                        tw=tw)
        dev_det = max(dev_x, dev_y) * scale_det_per_grid
        if dev_det <= tol_det:
            return (th, tw), dev_det
    return None


def pick_tile_shape_hybrid(coeffs, h, w, scale_det_per_grid,
                           tol_det=TOL_DET_PX, tile_sizes=_TILE_SIZES,
                           max_tiles=_MAX_TILES, min_pass_frac=0.5,
                           order_hint=2, compute_dtype="float32",
                           tile_batch=None, mem_budget_bytes=None,
                           vs_k2=False, mesh=None):
    """Per-lag gate for the hybrid Carrington path.

    Called when :func:`pick_tile_shape` rejected the FULL lag set: the
    within-tile deviation grows about linearly with the lag magnitude, so
    the inner lags usually pass.  Finds the tile shape admitting the most
    lags (cost as the tiebreak among near-best shapes) so the engine scores
    the passing lags on tile-FFT surfaces and the rest on K2.

    Returns ``((th, tw), pass_mask)`` with ``pass_mask`` an exact (L,)
    bool, or None when fewer than ``min_pass_frac`` of the lags pass for
    every shape, or when no leading shape passes the working-set screen
    (the evaluator's guard) and the stage-1 screen (its estimated
    transforms must cost less than K2 on the passing lags, at least 0.25
    s; with ``vs_k2`` the card's cost model of :func:`plan_tiles`
    instead).  With a ``mesh`` of several devices the screen clamps the
    batch to a device's share of the tiles, as the evaluator does."""
    L = coeffs.shape[0]
    if L == 0:
        return None
    idx_sub = np.arange(L)[:: max(1, L // 256)] if L > 512 else np.arange(L)
    sub = coeffs[idx_sub]

    cands = []
    for th in tile_sizes:
        n_ty = -(-h // th)
        for tw in tile_sizes:
            n_tx = -(-w // tw)
            if n_ty * n_tx > max_tiles:
                continue
            dev_l = _tile_bounds_per_lag(sub, h, w, n_ty, n_tx, th=th,
                                         tw=tw)
            ok = (dev_l.max(axis=1) * scale_det_per_grid) <= tol_det
            frac = float(ok.mean())
            if frac < min_pass_frac:
                continue
            # cost proxy: tile count x tile area (the lag-driven offset
            # span is shape-independent and drops out of the ranking)
            cost = n_ty * n_tx * _round128(th) * _round128(tw)
            cands.append((-frac, cost, th, tw, n_ty, n_tx))

    if not cands:
        return None
    cands.sort()
    best_frac = -cands[0][0]
    # among shapes within 2% of the best subsample pass rate, cheapest
    # first; the final mask is exact (every lag)
    leaders = [c for c in cands if -c[0] >= best_frac - 0.02]
    leaders.sort(key=lambda c: c[1])
    budget = MEM_BUDGET_BYTES if mem_budget_bytes is None \
        else mem_budget_bytes
    item = resolve_dtype(compute_dtype).itemsize
    for _nf, _cost, th, tw, n_ty, n_tx in leaders[:4]:
        dev_l = _tile_bounds_per_lag(coeffs, h, w, n_ty, n_tx, th=th, tw=tw)
        mask = (dev_l.max(axis=1) * scale_det_per_grid) <= tol_det
        if float(mask.mean()) < min_pass_frac:
            continue
        # working-set screen (the evaluator's guard): the per-tile box
        # span across the passing lags is near-identical for every tile,
        # so five representative tile centres bound it
        cm = coeffs[mask]
        uu = np.array([0.5 * (tw - 1), (n_tx - 0.5) * tw - 0.5,
                       0.5 * (tw - 1), (n_tx - 0.5) * tw - 0.5,
                       0.5 * n_tx * tw])
        vv = np.array([0.5 * (th - 1), 0.5 * (th - 1),
                       (n_ty - 0.5) * th - 0.5, (n_ty - 0.5) * th - 0.5,
                       0.5 * n_ty * th])
        o = np.floor(_quad_eval(cm, uu, vv) + 0.5)       # (Lm, 5, 2)
        span = (o.max(axis=0) - o.min(axis=0)).max(axis=0)  # (2,) x/y
        bx_e, by_e = int(span[0]) + 3, int(span[1]) + 3
        batch = _clamped_batch(tile_batch, n_ty * n_tx, mesh)
        group, rpad_bytes, bt = _hbm_group_plan(
            order_hint, by_e, bx_e,
            n_ty * th + by_e - 1, n_tx * tw + bx_e - 1, item, batch, budget)
        if group < batch:
            logger.info(
                "hybrid tile-FFT screen: shape (%d, %d) minimal working "
                "set %.1f GB (r stack %.1f GB + %d x %.0f MB boxes) > "
                "budget, skipping", th, tw,
                (rpad_bytes + batch * bt) / 1e9, rpad_bytes / 1e9, batch,
                bt / 1e6)
            continue
        # stage-1 screen against the alternative: K2 on the passing lags
        # (the 0.25 s floor keeps small-canvas hybrids viable)
        n_surf, n_rf = _plane_counts(order_hint)
        est = _est_stage1_seconds(
            n_ty * n_tx, n_surf + n_rf + 3,
            _round128(th + by_e - 1), _round128(tw + bx_e - 1))
        n_pass = int(mask.sum())
        if vs_k2:
            est += _EST_SELECT_OVERHEAD_S
            alt = _est_k2_seconds(n_pass, h, w)
        else:
            alt = max(0.25, n_pass * _EST_PALLAS_S_PER_LAG)
        if est > alt:
            logger.info(
                "hybrid tile-FFT screen: shape (%d, %d) est stage-1 "
                "%.2f s > per-lag kernel alternative ~%.2f s for %d "
                "passing lags, skipping", th, tw, est, alt, n_pass)
            continue
        return (th, tw), mask
    return None


# ---------------------------------------------------------------------------
# device programs
# ---------------------------------------------------------------------------

def _pair_indices(nt: int):
    """Upper-triangle (i, j) pairs and their multiplicity (1 diag, 2 off)."""
    ii, jj, mult = [], [], []
    for i in range(nt):
        for j in range(i, nt):
            ii.append(i)
            jj.append(j)
            mult.append(1.0 if i == j else 2.0)
    return np.array(ii), np.array(jj), np.array(mult)


def _shift2(x, ty, tx, fill):
    """``x`` shifted by (-ty, -tx) with ``fill`` where it wrapped."""
    out = torch.roll(x, (-ty, -tx), dims=(0, 1))
    h, w = x.shape
    if ty > 0:
        out[h - ty:, :] = fill
    elif ty < 0:
        out[:-ty, :] = fill
    if tx > 0:
        out[:, w - tx:] = fill
    elif tx < 0:
        out[:, :-tx] = fill
    return out


def _build_fields(warped, ref, order, score, hp, wp):
    """Global g fields (reference side) and r fields (canvas side), padded
    with empty (masked-out) borders to the tile-multiple frame (hp, wp).

    Pearson: g = [M, M a, M a^2]; residus: g = [F, F a'/sqrt a, F a'^2/a,
    F/sqrt a, F a'/a, F/a]; r = [A] + [A s_t] * nt + [A s_t s_u] (t <= u)
    for both.  Global mean-centring (exact for Pearson; the residue
    identity holds for any constant shift ``cshift``)."""
    h, w = ref.shape
    pad = (0, wp - w, 0, hp - h)
    refp = F.pad(ref, pad, value=float("nan"))
    wrpp = F.pad(warped, pad, value=float("nan"))
    dt = refp.dtype

    taps = [0] if order == 0 else [-1, 0, 1]
    nt = len(taps) ** 2

    def mean(v, m):
        n = torch.clamp(m.sum(), min=1).to(dt)
        return torch.where(m, v, 0.0).sum() / n

    if score == "pearson":
        mask_ref = torch.isfinite(refp)
        a = torch.where(mask_ref, refp - mean(refp, mask_ref), 0.0)
        mf = mask_ref.to(dt)
        g_list = [mf, mf * a, mf * a * a]
    else:  # residus
        Fm = torch.isfinite(refp) & (refp > 0)
        a = torch.where(Fm, refp, 1.0)
        Ff = Fm.to(dt)
        cshift = mean(a, Fm)
        ap = torch.where(Fm, a - cshift, 0.0)
        sqa = torch.sqrt(a)
        g_list = [Ff, Ff * ap / sqa, Ff * ap * ap / a, Ff / sqa,
                  Ff * ap / a, Ff / a]

    sfin = torch.isfinite(wrpp)
    if score == "pearson":
        s = torch.where(sfin, wrpp - mean(wrpp, sfin), 0.0)
    else:
        s = torch.where(sfin, wrpp - cshift, 0.0)

    A = torch.ones_like(sfin)
    for ty in taps:
        for tx in taps:
            A = A & _shift2(sfin, ty, tx, fill=False)
    Af = A.to(dt)

    s_t = [_shift2(s, ty, tx, fill=0.0) for ty in taps for tx in taps]
    r_list = [Af] + [Af * st for st in s_t]
    for i in range(nt):
        for j in range(i, nt):
            r_list.append(Af * s_t[i] * s_t[j])
    return torch.stack(g_list), torch.stack(r_list)


def _pad_r(r_stack, o_min, o_max, hp, wp):
    """The shifted r frame: ``r_pad[:, i, j] = r[:, i + o_min_y, j +
    o_min_x]`` (zero outside), sized over the global offset union so every
    tile's slice is in bounds."""
    span_y, span_x = int(o_max[1] - o_min[1]), int(o_max[0] - o_min[0])
    o_min_y, o_min_x = int(o_min[1]), int(o_min[0])
    Htot, Wtot = hp + span_y, wp + span_x
    r_pad = r_stack.new_zeros((r_stack.shape[0], Htot, Wtot))
    sy0, sy1 = max(o_min_y, 0), min(o_min_y + Htot, hp)
    sx0, sx1 = max(o_min_x, 0), min(o_min_x + Wtot, wp)
    if sy1 > sy0 and sx1 > sx0:
        dy0, dx0 = sy0 - o_min_y, sx0 - o_min_x
        r_pad[:, dy0: dy0 + (sy1 - sy0), dx0: dx0 + (sx1 - sx0)] = \
            r_stack[:, sy0:sy1, sx0:sx1]
    return r_pad


class TilePlan(NamedTuple):
    """One evaluation's static shapes: tiles (th, tw) on an (n_ty, n_tx)
    grid, padded frame (hp, wp), transforms (my, mx), offset boxes (by,
    bx), per-tile box anchors ``o_tab`` ((n_tiles, 2) int64, (x, y)), the
    global offset union [o_min, o_max], tiles per stage-1 step ``batch``
    and per group ``group`` (n_tiles when one group holds them all)."""
    th: int
    tw: int
    n_ty: int
    n_tx: int
    hp: int
    wp: int
    my: int
    mx: int
    by: int
    bx: int
    o_tab: np.ndarray
    o_min: np.ndarray
    o_max: np.ndarray
    batch: int
    group: int

    @property
    def n_tiles(self):
        return self.n_ty * self.n_tx


def _tile_spectra(g_stack, r_pad, plan, ids):
    """Stage 1, forward: the real 2-D transforms, size (my, mx), of the g
    tiles ``g[:, y0:y0+th, x0:x0+tw]`` and of the r slices that start at
    the tile origin plus its box anchor, for the tiles ``ids``; returns
    (B, nG, my, mx//2+1) and (B, nR, my, mx//2+1) complex tensors."""
    th, tw, by, bx = plan.th, plan.tw, plan.by, plan.bx
    g_t, r_t = [], []
    for t in ids:
        y0 = (t // plan.n_tx) * th
        x0 = (t % plan.n_tx) * tw
        ry = y0 + int(plan.o_tab[t, 1] - plan.o_min[1])
        rx = x0 + int(plan.o_tab[t, 0] - plan.o_min[0])
        g_t.append(g_stack[:, y0:y0 + th, x0:x0 + tw])
        r_t.append(r_pad[:, ry:ry + th + by - 1, rx:rx + tw + bx - 1])
    s = (plan.my, plan.mx)
    return (torch.fft.rfft2(torch.stack(g_t), s=s),
            torch.fft.rfft2(torch.stack(r_t), s=s))


def _products(G, R, order, score):
    """Stage 1, products: conj(G) R for the 66 (or 18 at order 0) surface
    planes, (B, n_surf, my, K) complex, in the layout of
    ``fast_corr._build_surfaces``."""
    nt = _tap_count(order) ** 2
    npairs = nt * (nt + 1) // 2
    gsel = ((0, 1, 2, 0, 1, 0) if score == "pearson"
            else (0, 1, 2, 3, 4, 5))
    rsl = ((0, 1), (0, 1), (0, 1), (1, 1 + nt), (1, 1 + nt),
           (1 + nt, 1 + nt + npairs))
    return torch.cat([torch.conj(G[:, g:g + 1]) * R[:, r0:r1]
                      for g, (r0, r1) in zip(gsel, rsl)], dim=1)


def _inverse(P, my, mx, by, bx):
    """Stage 1, inverse: the circular correlations at offsets [0, by) x
    [0, bx), ``irfft2`` of the half spectra cropped to the box."""
    return torch.fft.irfft2(P, s=(my, mx))[..., :by, :bx]


def _tiles_surfaces(g_stack, r_pad, plan, ids, order, score):
    """Stage 1 over the tiles ``ids``, ``plan.batch`` tiles a step: the
    (len(ids), n_surf, by, bx) surface boxes."""
    n_surf, _ = _plane_counts(order)
    S = g_stack.new_empty((len(ids), n_surf, plan.by, plan.bx))
    for b0 in range(0, len(ids), plan.batch):
        b_ids = ids[b0:b0 + plan.batch]
        G, R = _tile_spectra(g_stack, r_pad, plan, b_ids)
        S[b0:b0 + len(b_ids)] = _inverse(_products(G, R, order, score),
                                         plan.my, plan.mx, plan.by, plan.bx)
    return S


def _weights_1d(frac, order):
    if order == 0:
        return torch.ones(frac.shape + (1,), dtype=frac.dtype,
                          device=frac.device)
    return torch.stack([
        0.5 * (0.5 - frac) ** 2,
        0.75 - frac * frac,
        0.5 * (0.5 + frac) ** 2,
    ], dim=-1)


def _pair_tensors(order, dtype, device):
    """:func:`_pair_indices` of the order's taps as tensors on ``device``."""
    pi, pj, pmult = _pair_indices(_tap_count(order) ** 2)
    return (torch.as_tensor(pi, device=device),
            torch.as_tensor(pj, device=device),
            torch.as_tensor(pmult, dtype=dtype, device=device))


def _combine_lags(S, coeffs_d, o_tab_d, ids_d, order, plan, pairs=None):
    """Stage 2: per-lag readout and fractional-tap weighting over the tiles
    ``ids_d`` whose boxes are ``S``; the lag axis stays last: values (Tn,
    n_surf, L), weights (Tn, nt, L).  ``pairs``: :func:`_pair_tensors` on
    S's device, made here when None.  Returns (L, 6) sums."""
    nt = _tap_count(order) ** 2
    L = coeffs_d.shape[0]
    Tn, n_surf, by, bx = S.shape
    dt, dev = S.dtype, S.device
    pi_d, pj_d, pmult_d = pairs or _pair_tensors(order, dt, dev)

    u = ((ids_d % plan.n_tx) * plan.tw).to(dt) + (plan.tw - 1) / 2.0
    v = ((ids_d // plan.n_tx) * plan.th).to(dt) + (plan.th - 1) / 2.0
    c = _quad_eval(coeffs_d, u, v)                              # (L, Tn, 2)
    o = torch.floor(c + 0.5)
    frac = c - o
    oi = o.to(torch.int64)
    anchors = o_tab_d[ids_d]                                    # (Tn, 2)
    iy = oi[..., 1] - anchors[None, :, 1]                       # (L, Tn)
    ix = oi[..., 0] - anchors[None, :, 0]
    inb = (iy >= 0) & (iy <= by - 1) & (ix >= 0) & (ix <= bx - 1)
    idx = iy.clamp(0, by - 1) * bx + ix.clamp(0, bx - 1)

    flat = S.reshape(Tn, n_surf, by * bx)
    vals = torch.gather(flat, 2, idx.T[:, None, :].expand(Tn, n_surf, L))
    vals = vals * inb.T[:, None, :].to(dt)                      # (Tn, 66, L)

    wx = _weights_1d(frac[..., 0], order)                       # (L, Tn, nta)
    wy = _weights_1d(frac[..., 1], order)
    w2t = (wy[..., :, None] * wx[..., None, :]).reshape(L, Tn, nt) \
        .permute(1, 2, 0)                                       # (Tn, nt, L)
    pair_w = w2t[:, pi_d, :] * w2t[:, pj_d, :] * pmult_d[None, :, None]
    return torch.stack([
        vals[:, 0, :].sum(dim=0),
        vals[:, 1, :].sum(dim=0),
        vals[:, 2, :].sum(dim=0),
        (w2t * vals[:, 3: 3 + nt, :]).sum(dim=(0, 1)),
        (w2t * vals[:, 3 + nt: 3 + 2 * nt, :]).sum(dim=(0, 1)),
        (pair_w * vals[:, 3 + 2 * nt:, :]).sum(dim=(0, 1)),
    ], dim=-1)                                                  # (L, 6)


def _tiles_sum(g_stack, r_pad, coeffs_d, plan, order, score, devices):
    """Stages 1 and 2 over every tile, ``plan.group`` tiles at a time with
    an (L, 6) running sum per shard (only one group's boxes are ever
    resident on a device), the tile axis split over ``devices``; the
    shards' sums are added on the first device.  ``g_stack``, ``r_pad``
    and ``coeffs_d`` are replicated, every constant placed before the first
    launch."""
    ranges = mesh_mod.split(plan.n_tiles, devices)
    g_r, r_r, c_r = (mesh_mod.replicate(t, devices)
                     for t in (g_stack, r_pad, coeffs_d))
    o_tab = mesh_mod.replicate(torch.as_tensor(plan.o_tab), devices)
    pairs = {dev: _pair_tensors(order, g_stack.dtype, dev)
             for dev in set(devices)}
    ids_d = [torch.arange(a, b, device=dev)
             for (a, b), dev in zip(ranges, devices)]
    acc = [None] * len(devices)
    for k, g0, g1 in mesh_mod.round_robin(ranges, plan.group):
        S = _tiles_surfaces(g_r[k], r_r[k], plan, list(range(g0, g1)), order,
                            score)
        a = ranges[k][0]
        comp = _combine_lags(S, c_r[k], o_tab[k], ids_d[k][g0 - a:g1 - a],
                             order, plan, pairs[devices[k]])
        del S  # freed before the device's next group is allocated
        acc[k] = comp if acc[k] is None else acc[k] + comp
    parts = [a.to(devices[0]) for a in acc if a is not None]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def plan_tiles(coeffs, *, order, h, w, scale_det_per_grid=1.0,
               tol_det=TOL_DET_PX, compute_dtype="float32", tile_size=None,
               tile_batch=None, mem_budget_bytes=None, vs_k2=False,
               device, mesh=None):
    """The gate and the host prep of :func:`evaluate_select_tile_fft`:
    a :class:`TilePlan`, or None when the gate or a guard declines.  The
    stage-1 guard is the JAX package's ceiling
    (:data:`_MAX_STAGE1_SECONDS`), or with ``vs_k2`` the card's cost
    model: the plan's stage-1 estimate plus :data:`_EST_SELECT_OVERHEAD_S`
    must stay under K2's estimate for the same lags.  The working set is
    planned per device (each holds its own r stack and one group of
    boxes); with a ``mesh`` of several devices the batch is clamped to a
    device's share of the tiles."""
    dev = resolve_device(device)
    dt = resolve_dtype(compute_dtype)
    coeffs = np.asarray(coeffs, dtype=np.float64)
    L = coeffs.shape[0]
    if tile_size is None:
        with stage("carr_tilefft_gate_s"):
            pick = pick_tile_shape(coeffs, h, w, scale_det_per_grid, tol_det)
        if pick is None:
            return None
        (th, tw), _dev = pick
    elif np.ndim(tile_size) == 0:
        th = tw = int(tile_size)
    else:
        th, tw = (int(tile_size[0]), int(tile_size[1]))
    n_ty = -(-h // th)
    n_tx = -(-w // tw)
    hp, wp = n_ty * th, n_tx * tw

    # per-tile offset boxes: each tile's exact rounded-offset range, one
    # common size (by, bx) = the largest per-tile span, anchored at each
    # tile's own minimum; the global union [o_min, o_max] sizes the r frame
    with stage("carr_tilefft_hostprep_s"):
        o_min_t, o_max_t = _tile_offset_bounds(
            torch.as_tensor(coeffs, dtype=dt, device=dev), th, tw, n_ty,
            n_tx)
    o_min = o_min_t.min(axis=0)
    o_max = o_max_t.max(axis=0)
    span_t = (o_max_t - o_min_t).max(axis=0)        # (2,) in (x, y)
    bx, by = int(span_t[0]) + 1, int(span_t[1]) + 1
    # pull anchors back so every (by, bx) box stays inside the global frame
    o_min_t = np.minimum(o_min_t, o_max - np.array([bx - 1, by - 1]))
    my = _round128(th + by - 1)
    mx = _round128(tw + bx - 1)
    if int((o_max - o_min).max()) > 2 * max(hp, wp):
        return None  # offsets far beyond the image extent: not worth it

    n_tiles = n_ty * n_tx
    batch = _clamped_batch(tile_batch, n_tiles, mesh)
    budget = MEM_BUDGET_BYTES if mem_budget_bytes is None \
        else mem_budget_bytes
    n_surf, n_rf = _plane_counts(order)
    group, rpad_bytes, bt = _hbm_group_plan(
        order, by, bx, hp + int(o_max[1] - o_min[1]),
        wp + int(o_max[0] - o_min[0]), dt.itemsize, batch, budget)
    if group < batch:
        logger.info(
            "tile-FFT declined: minimal working set %.1f GB (r stack "
            "%.1f GB + %d x %.0f MB boxes) > %.1f GB budget",
            (rpad_bytes + batch * bt) / 1e9, rpad_bytes / 1e9, batch,
            bt / 1e6, budget / 1e9)
        return None
    est_s = _est_stage1_seconds(n_tiles, n_surf + n_rf + 3, my, mx)
    limit = _MAX_STAGE1_SECONDS
    if vs_k2:
        limit = _est_k2_seconds(L, h, w) - _EST_SELECT_OVERHEAD_S
    if est_s > limit:
        logger.info(
            "tile-FFT declined: est stage-1 transform time %.3f s > %.3f s "
            "(%d tiles, %dx%d transforms)", est_s, limit, n_tiles, my, mx)
        return None
    return TilePlan(th, tw, n_ty, n_tx, hp, wp, my, mx, by, bx, o_min_t,
                    o_min, o_max, batch, min(group, n_tiles))


def scores_from_sums(S, method):
    """(L, 6) float64 sums -> (L,) Pearson r or masked residue std."""
    n = S[:, 0]
    with np.errstate(invalid="ignore", divide="ignore"):
        if method == "correlation":
            Sa, Saa, Sb, Sab, Sbb = S[:, 1], S[:, 2], S[:, 3], S[:, 4], S[:, 5]
            num = Sab - Sa * Sb / n
            den = np.sqrt((Saa - Sa * Sa / n) * (Sbb - Sb * Sb / n))
            return num / den
        Ssqa, Sa_, Sbosq, Sb_, Sb2oa = (S[:, 1], S[:, 2], S[:, 3], S[:, 4],
                                        S[:, 5])
        Sd = Ssqa - Sbosq
        Sdd = Sa_ - 2.0 * Sb_ + Sb2oa
        mean = Sd / n
        var = Sdd / n - mean * mean
        return np.sqrt(np.maximum(var, 0.0))


def evaluate_select_tile_fft(coeffs, warped, ref_img, *, order, h, w,
                             method="correlation", scale_det_per_grid=1.0,
                             tol_det=TOL_DET_PX, compute_dtype="float32",
                             tile_size=None, mesh=None, tile_batch=None,
                             mem_budget_bytes=None, vs_k2=False, device):
    """Score ``L`` quadratic-displacement lags via tile-local FFT surfaces.

    Same inputs and semantics as ``quad_score.evaluate_select_quad``;
    returns (L,) float64 scores, or None when a precondition fails (order
    other than 0 or 2, another method, within-tile deviation above
    ``tol_det`` detector pixels, a working set above ``mem_budget_bytes``
    (default :data:`MEM_BUDGET_BYTES`) or an estimated stage-1 time above
    the guard of :func:`plan_tiles`; ``vs_k2`` holds the plan to K2's
    estimated time).  ``scale_det_per_grid`` converts grid pixels to
    detector pixels (1.0 when unknown: conservative).

    ``tile_size``: an int for square tiles, (th, tw), or None to pick the
    cheapest rectangle meeting the gate (:func:`pick_tile_shape`).
    ``tile_batch``: tiles per stage-1 step (default :data:`TILE_BATCH`).
    ``mesh``: a sequence of devices; the tile axis is split over them
    (:func:`_tiles_sum`).
    """
    if method not in ("correlation", "residus_masked") or order not in (0, 2):
        return None
    coeffs = np.asarray(coeffs, dtype=np.float64)
    if coeffs.shape[0] == 0:
        return np.zeros(0)
    dev = resolve_device(device)
    dt = resolve_dtype(compute_dtype)
    devices = mesh_mod.resolve_mesh(mesh)
    plan = plan_tiles(coeffs, order=order, h=h, w=w,
                      scale_det_per_grid=scale_det_per_grid, tol_det=tol_det,
                      compute_dtype=dt, tile_size=tile_size,
                      tile_batch=tile_batch,
                      mem_budget_bytes=mem_budget_bytes, vs_k2=vs_k2,
                      device=dev, mesh=devices)
    if plan is None:
        return None
    logger.info("tile-FFT plan: tiles (%d, %d), %d x %d = %d, transforms "
                "(%d, %d), boxes (%d, %d), %d group(s), batch %d",
                plan.th, plan.tw, plan.n_ty, plan.n_tx, plan.n_tiles,
                plan.my, plan.mx, plan.by, plan.bx,
                -(-plan.n_tiles // plan.group), plan.batch)
    if devices is not None:
        logger.info("tile-FFT mesh: %d tiles over %d shard(s)",
                    plan.n_tiles, len(devices))

    score = "pearson" if method == "correlation" else "residus"
    with stage("carr_tilefft_eval_s"):
        g_stack, r_stack = _build_fields(
            to_tensor(warped, device=dev, dtype=dt),
            to_tensor(ref_img, device=dev, dtype=dt), order, score,
            plan.hp, plan.wp)
        r_pad = _pad_r(r_stack, plan.o_min, plan.o_max, plan.hp, plan.wp)
        del r_stack
        sums = _tiles_sum(g_stack, r_pad,
                          torch.as_tensor(coeffs, dtype=dt, device=dev),
                          plan, order, score, devices or (dev,))
        S = sums.to(torch.float64).cpu().numpy()  # (L, 6)
    return scores_from_sums(S, method)
