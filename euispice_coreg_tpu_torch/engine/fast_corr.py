"""FFT correlation-surface fast path for CRVAL-only lag grids (torch/cuFFT).

Counterpart of ``euispice_coreg_tpu/engine/fast_corr.py``.  When only
CRVAL1/CRVAL2 are lagged, the per-lag resampling map is the identity plus a
per-lag constant pixel displacement ``c_l`` (checked at probe points; the
engine falls back to the general path when the curvature bound fails).
With ``c_l = dint + dfrac``, B-spline sampling becomes a fixed tap stencil
with per-lag constant weights:

    s_l(p) = sum_t w_t(dfrac) small[p + dint + t]

and every sum in the masked Pearson r factorizes over cross-correlation
surfaces evaluated at the integer offsets ``dint``:

    n(d)   = XC(M, A)            Sb(d)  = sum_t   w_t      XC(M,  A.small_t)
    Sa(d)  = XC(M.a, A)          Sab(d) = sum_t   w_t      XC(M.a, A.small_t)
    Saa(d) = XC(M.a^2, A)        Sbb(d) = sum_t,u w_t w_u  XC(M,  A.small_t.small_u)

with ``M`` the finite mask of the reference, ``A`` the tap-validity mask of
the small image and ``small_t`` the small image shifted by tap ``t``.  The
surfaces come from zero-padded real 2-D FFTs (``torch.fft``, cuFFT on the
card); the inverse transforms run in chunks of 8 and are read at the lag
offsets.  The six combined sums and r are finished on the host in float64.

Numerics: both images are globally mean-centred before building the fields
(masked Pearson is exactly invariant under constant shifts).  Boundary
semantics: tap validity requires all taps inside the image (no mirror
extension), which differs from the general engine only on the 1-2 px source
border, at the 1e-5 level of the correlation values.

Not carried over from the JAX package: the matmul-DFT of
``ops/precise_fft.py`` and its backend rule (the TPU's FFT is imprecise; see
PERF.md for the card's float32/float64 measurement), the box-restricted
inverse and fused readout (``_box_inverse``/``_readout_contract``), the memo
caches and mesh sharding.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import wcs
from ..utils import obs
from ..utils.torchcfg import (check_single_device_mesh, resolve_device,
                               resolve_dtype, to_tensor)
from . import lag_search

MAX_DISPLACEMENT_SPREAD_PX = 0.05  # fall back if curvature exceeds this


def _fft_size(n: int) -> int:
    """Next 256-multiple (the JAX package's transform size, kept so that
    both packages build the same surfaces)."""
    return ((n + 255) // 256) * 256


def displacement_per_lag(base: dict, lags_deg: np.ndarray, lon, lat,
                         kind: str, grid: dict | None = None):
    """Per-lag pixel displacement c_l at the probe points, host float64.

    ``base`` is the WCS the crval lags perturb.  With ``grid`` (the
    comparison grid's own WCS) the displacements are conjugated into
    grid-pixel space, the sampling offsets into an image already warped
    through ``base`` (block path): c = W2P_grid(P2W_base(W2P_{base+d}(w))) - p.
    With ``grid=None`` (base == grid WCS) this is c = W2P_{base+d}(w) - p.

    Returns (c, spread): c (L, 2) at the grid center; spread = max over probe
    points and lags of |c(probe) - c(center)| (constancy check).
    """
    cs, spreads = displacement_per_lag_multi([base], lags_deg, lon, lat, kind,
                                             grid=grid)
    return cs[0], float(spreads[0])


def displacement_per_lag_multi(combos_params, lags_deg, lon, lat, kind: str,
                               grid: dict | None = None):
    """:func:`displacement_per_lag` for C WCS param dicts sharing one lag
    set, as one vectorised host float64 chain on (C, L, probes) arrays.
    Returns ``(cs, spreads)`` with ``cs`` (C, L, 2) and ``spreads`` (C,)."""
    pl, pb, px0, py0 = lag_search.probe_values(lon, lat)
    lags_deg = np.asarray(lags_deg, dtype=np.float64)
    keys = set().union(*[set(p) for p in combos_params])
    p_base = {k: np.array([np.float64(cp[k]) for cp in combos_params])[
        :, None, None] for k in keys}
    p = dict(p_base)
    p["crval1"] = p_base["crval1"] + lags_deg[None, :, 0, None]
    p["crval2"] = p_base["crval2"] + lags_deg[None, :, 1, None]
    bx, by = wcs.world_to_pixel(p, pl[None, None, :], pb[None, None, :],
                                kind=kind, xp=np)
    if grid is not None:
        # back to world through the unlagged combo WCS, then into grid pixels
        grid64 = {k: np.float64(v) for k, v in grid.items()}
        lon2, lat2 = wcs.pixel_to_world(p_base, bx, by, kind=kind, xp=np)
        bx, by = wcs.world_to_pixel(grid64, lon2, lat2, kind=kind, xp=np)
    cs = np.stack([bx - px0[None, None, :], by - py0[None, None, :]],
                  axis=-1)                                   # (C, L, 5, 2)
    center = cs[:, :, 0, :]
    if cs.size:
        spreads = np.max(np.abs(cs - center[:, :, None, :]), axis=(1, 2, 3))
    else:
        spreads = np.zeros(len(combos_params))
    return center, spreads


def fast_path_applicable(l3, l4, l5, order: int) -> bool:
    """Static preconditions: crval-only grid, even spline order."""
    return (
        len(l3) == 1 and len(l4) == 1 and len(l5) == 1
        and float(l3[0]) == 0.0 and float(l4[0]) == 0.0 and float(l5[0]) == 0.0
        and order in (0, 2)
    )


def _tap_offsets(order: int):
    if order == 0:
        return [0]
    return [-1, 0, 1]  # order 2


def _shift2(x, ty, tx, fill):
    """x shifted so that out[q] = x[q + (ty, tx)], constant fill."""
    out = torch.roll(x, (-ty, -tx), dims=(0, 1))
    h, w = x.shape
    if ty > 0:
        out[h - ty:, :] = fill
    elif ty < 0:
        out[: -ty, :] = fill
    if tx > 0:
        out[:, w - tx:] = fill
    elif tx < 0:
        out[:, : -tx] = fill
    return out


def _build_surfaces(small, ref, order, m, score="pearson"):
    """Frequency-domain cross-correlation products, shape (n_pairs, m, m//2+1)
    (callers apply the inverse FFT, chunked).

    ``score="pearson"`` layout (order 2, taps T = 3 offsets/axis, nt = 9,
    npair = 45):
      [0]                 XC(M,   A)
      [1]                 XC(M a, A)
      [2]                 XC(M a2,A)
      [3 : 3+nt]          XC(M,   A small_t)
      [3+nt : 3+2nt]      XC(M a, A small_t)
      [3+2nt : 3+2nt+np]  XC(M,   A small_t small_u), (t<=u upper triangle)

    ``score="residus"`` factorizes the masked residue std of
    d = (a - b)/sqrt(a), centred by c = the masked mean of a (exact: d is
    unchanged by subtracting c from both a and b).  With
    F = [a finite & a > 0], a' = a - c, b' = b - c:
      [0]                 XC(F,           A)      n
      [1]                 XC(F a'/sqrt a, A)
      [2]                 XC(F a'^2/a,    A)
      [3 : 3+nt]          XC(F/sqrt a,    A small'_t)   (b'/sqrt a terms)
      [3+nt : 3+2nt]      XC(F a'/a,      A small'_t)   (a'b'/a terms)
      [3+2nt : 3+2nt+np]  XC(F/a,         A small'_t small'_u)
    """
    taps = _tap_offsets(order)
    nt = len(taps) ** 2

    if score == "pearson":
        mask_ref = torch.isfinite(ref)
        # global centering for conditioning (exact: Pearson shift-invariance)
        amean = torch.where(mask_ref, ref, 0.0).sum() / torch.clamp(
            mask_ref.sum(), min=1)
        a = torch.where(mask_ref, ref - amean, 0.0)
        mf = mask_ref.to(ref.dtype)
        g_list = [mf, mf * a, mf * a * a]
        center_small = True
    else:  # residus
        F = torch.isfinite(ref) & (ref > 0)
        a = torch.where(F, ref, 1.0)  # safe denominator under the mask
        Ff = F.to(ref.dtype)
        cshift = (Ff * a).sum() / torch.clamp(Ff.sum(), min=1)
        ap = torch.where(F, a - cshift, 0.0)
        sqa = torch.sqrt(a)
        g_list = [Ff, Ff * ap / sqa, Ff * ap * ap / a, Ff / sqa,
                  Ff * ap / a, Ff / a]
        center_small = False

    sfin = torch.isfinite(small)
    s0 = torch.where(sfin, small, 0.0)
    if center_small:
        smean = s0.sum() / torch.clamp(sfin.sum(), min=1)
        s = torch.where(sfin, small - smean, 0.0)
    else:
        s = torch.where(sfin, small - cshift, 0.0)

    # tap-validity mask A: all stencil taps finite and inside the image
    A = torch.ones_like(sfin)
    for ty in taps:
        for tx in taps:
            A = A & _shift2(sfin, ty, tx, fill=False)
    Af = A.to(ref.dtype)

    s_t = [_shift2(s, ty, tx, fill=0.0) for ty in taps for tx in taps]
    r_fields = [Af] + [Af * st for st in s_t]
    for i in range(nt):
        for j in range(i, nt):
            r_fields.append(Af * s_t[i] * s_t[j])

    G = torch.fft.rfft2(torch.stack(g_list), s=(m, m))
    R = torch.fft.rfft2(torch.stack(r_fields), s=(m, m))
    del r_fields, s_t

    npairs = nt * (nt + 1) // 2
    if score == "pearson":
        parts = [
            torch.conj(G[0:1]) * R[0:1],            # n
            torch.conj(G[1:2]) * R[0:1],            # Sa
            torch.conj(G[2:3]) * R[0:1],            # Saa
            torch.conj(G[0:1]) * R[1:1 + nt],       # Sb terms
            torch.conj(G[1:2]) * R[1:1 + nt],       # Sab terms
            torch.conj(G[0:1]) * R[1 + nt:1 + nt + npairs],  # Sbb terms
        ]
    else:
        parts = [
            torch.conj(G[0:1]) * R[0:1],            # n
            torch.conj(G[1:2]) * R[0:1],            # sum F a'/sqrt(a)
            torch.conj(G[2:3]) * R[0:1],            # sum F a'^2/a
            torch.conj(G[3:4]) * R[1:1 + nt],       # b'/sqrt(a) terms
            torch.conj(G[4:5]) * R[1:1 + nt],       # a'b'/a terms
            torch.conj(G[5:6]) * R[1 + nt:1 + nt + npairs],  # b'^2/a terms
        ]
    return torch.cat(parts)


def _surfaces_at(small, ref, iy, ix, order, m, score="pearson"):
    """Surface values at the per-lag integer offsets: (n_surf, L).

    The inverse FFTs run in chunks of 8 so the full (n_surf, m, m) surface
    stack never materializes at once."""
    prods = _build_surfaces(small, ref, order, m, score=score)
    vals = []
    for k in range(0, prods.shape[0], 8):
        surf = torch.fft.irfft2(prods[k:k + 8], s=(m, m))
        vals.append(surf[:, iy, ix])
    return torch.cat(vals)


def evaluate_crval_grid_fast(
    small_img,
    ref_img,
    lon,
    lat,
    base_params: dict,
    lag_crval1_deg,
    lag_crval2_deg,
    *,
    order: int = 2,
    kind: str = "tan",
    device,
    compute_dtype="float32",
    method: str = "correlation",
):
    """Scores (masked Pearson or residue) for a crval1 x crval2 lag grid.

    Returns (n1, n2) float64 array, or None if the constant-displacement
    bound is violated (caller falls back to the general engine).
    """
    l1 = np.asarray(lag_crval1_deg, dtype=np.float64)
    l2 = np.asarray(lag_crval2_deg, dtype=np.float64)
    g1, g2 = np.meshgrid(l1, l2, indexing="ij")
    lags = np.stack([g1.ravel(), g2.ravel()], axis=-1)

    with obs.stage("fast_hostprep_s"):
        c, spread = displacement_per_lag(base_params, lags, lon, lat, kind)
    r = evaluate_from_displacements(
        small_img, ref_img, c, spread, order=order, device=device,
        compute_dtype=compute_dtype, method=method,
    )
    if r is None:
        return None
    return r.reshape(len(l1), len(l2))


def evaluate_from_displacements(small_img, ref_img, c, spread, *,
                                order: int = 2, device,
                                compute_dtype="float32",
                                method: str = "correlation"):
    """Scores for a list of constant pixel displacements ``c`` ((L, 2), x/y
    order) of the moving image relative to the comparison grid.

    ``method``: ``"correlation"`` (masked Pearson) or ``"residus_masked"``
    (masked residue std).  Raw ``"residus"`` is not factorizable faithfully
    (its NaN propagation needs every grid pixel valid) and always takes the
    exact per-lag engine.

    Returns the (L,) score vector, or None when the spread bound or the
    frame-size precondition fails.
    """
    if method not in ("correlation", "residus_masked"):
        return None
    score = "pearson" if method == "correlation" else "residus"
    if spread > MAX_DISPLACEMENT_SPREAD_PX:
        return None

    c = np.asarray(c, dtype=np.float64)
    # stencil base convention must match the resampler: k = floor(c + 0.5)
    dint = np.floor(c + 0.5).astype(np.int64)
    dfrac = c - dint  # in [-0.5, 0.5)

    h, w = np.shape(small_img)
    if np.max(np.abs(dint)) + 2 >= min(h, w) // 4:
        return None  # shifts too large relative to the frame

    m = _fft_size(max(h, w) + int(np.max(np.abs(dint))) + 4)
    dev = resolve_device(device)
    dt = resolve_dtype(compute_dtype)
    small_d = to_tensor(small_img, device=dev, dtype=dt)
    ref_d = to_tensor(ref_img, device=dev, dtype=dt)
    iy = torch.as_tensor(np.mod(dint[:, 1], m), device=dev)
    ix = torch.as_tensor(np.mod(dint[:, 0], m), device=dev)
    with obs.stage("fast_surfaces_s"):
        # The surfaces (fields, FFTs, products, inverse FFTs) are built in
        # float64 whatever the operands' compute dtype: on an H100, float32
        # cuFFT surfaces kept the headline pair's argmax but shrank its top-2
        # margin below the float64 build's (PERF.md).
        S = _surfaces_at(small_d.to(torch.float64),
                         ref_d.to(torch.float64), iy, ix, order, m,
                         score=score)
        S = S.to(torch.float64).cpu().numpy()
    with obs.stage("fast_combine_s"):
        return _combine_scores(S, dfrac, order, score)


def _scores_from_sums(T, score: str):
    """Host float64 finisher: the six combined sums (..., 6, L) -> scores
    (..., L).  The only cancellation-sensitive arithmetic of the combine."""
    n = T[..., 0, :]
    with np.errstate(invalid="ignore", divide="ignore"):
        if score == "pearson":
            Sa, Saa, Sb, Sab, Sbb = (T[..., 1, :], T[..., 2, :], T[..., 3, :],
                                     T[..., 4, :], T[..., 5, :])
            num = Sab - Sa * Sb / n
            den = np.sqrt((Saa - Sa * Sa / n) * (Sbb - Sb * Sb / n))
            return num / den
        Ssqa, Sa_, Sbosq, Sb_, Sb2oa = (T[..., 1, :], T[..., 2, :],
                                        T[..., 3, :], T[..., 4, :],
                                        T[..., 5, :])
        Sd = Ssqa - Sbosq
        Sdd = Sa_ - 2.0 * Sb_ + Sb2oa
        mean = Sd / n
        var = Sdd / n - mean * mean
        return np.sqrt(np.maximum(var, 0.0))


def _combine_scores(S, dfrac, order: int, score: str):
    """Combine surface values ``S`` (..., n_surf, L) with per-lag fractional
    displacements ``dfrac`` (..., L, 2) into scores (..., L), host float64.

    The tap weights are the same B-spline weights as
    ``core/resample._taps_and_weights`` (frac in [-0.5, 0.5), stencil base
    floor(q + frac + 0.5) == q)."""
    taps = _tap_offsets(order)
    nt = len(taps) ** 2
    npairs = nt * (nt + 1) // 2

    def weights_1d(frac):
        t = np.asarray(frac, dtype=np.float64)
        if order == 0:
            return np.ones(t.shape + (1,))
        return np.stack([
            0.5 * (0.5 - t) ** 2,
            0.75 - t * t,
            0.5 * (0.5 + t) ** 2,
        ], axis=-1)

    wx = weights_1d(dfrac[..., 0])  # (..., L, ntap)
    wy = weights_1d(dfrac[..., 1])
    w2 = (wy[..., :, None] * wx[..., None, :]).reshape(
        dfrac.shape[:-1] + (nt,))  # (..., L, nt)

    pair_w = np.zeros(dfrac.shape[:-1] + (npairs,))
    k = 0
    for i in range(nt):
        for j in range(i, nt):
            pair_w[..., k] = w2[..., i] * w2[..., j] * (1.0 if i == j else 2.0)
            k += 1

    C1 = np.einsum("...lt,...tl->...l", w2, S[..., 3: 3 + nt, :])
    C2 = np.einsum("...lt,...tl->...l", w2, S[..., 3 + nt: 3 + 2 * nt, :])
    C3 = np.einsum("...lp,...pl->...l", pair_w,
                   S[..., 3 + 2 * nt: 3 + 2 * nt + npairs, :])
    T = np.stack([S[..., 0, :], S[..., 1, :], S[..., 2, :], C1, C2, C3],
                 axis=-2)
    return _scores_from_sums(T, score)


def pearson_integer_shifts(fixed_img, moving_img, dxs, dys, *, device):
    """Masked Pearson r between ``fixed`` and ``moving`` shifted by every
    integer offset (dx, dy): r[i, j] = pearson(fixed(p), moving(p + (dx_i, dy_j))).

    The pxlshift sliding-window correlation for the whole offset grid from
    order-0 FFT correlation surfaces (layout ``[n, Sa, Saa, Sb, Sab, Sbb]``),
    from the images in float64.  Both images must share a shape; NaNs define
    the masks.  Returns (len(dxs), len(dys)) float64.
    """
    dxs = np.asarray(dxs, dtype=np.int64)
    dys = np.asarray(dys, dtype=np.int64)
    h, w = np.shape(fixed_img)
    m = _fft_size(max(h, w)
                  + int(max(np.max(np.abs(dxs)), np.max(np.abs(dys)))) + 2)
    dev = resolve_device(device)
    gx, gy = np.meshgrid(dxs, dys, indexing="ij")
    iy = torch.as_tensor(np.mod(gy.ravel(), m), device=dev)
    ix = torch.as_tensor(np.mod(gx.ravel(), m), device=dev)
    moving = to_tensor(moving_img, device=dev, dtype=torch.float64)
    fixed = to_tensor(fixed_img, device=dev, dtype=torch.float64)
    S = _surfaces_at(moving, fixed, iy, ix, 0, m).cpu().numpy()
    n, Sa, Saa, Sb, Sab, Sbb = S
    with np.errstate(invalid="ignore", divide="ignore"):
        num = Sab - Sa * Sb / n
        den = np.sqrt((Saa - Sa * Sa / n) * (Sbb - Sb * Sb / n))
        r = num / den
    return r.reshape(len(dxs), len(dys))


def evaluate_movie_from_displacements(smalls, refs, cs, *, order: int = 2,
                                      device, compute_dtype="float32",
                                      mesh=None,
                                      method: str = "correlation"):
    """Scores for F constant-displacement pair searches evaluated together.

    Args:
      smalls: (F, h, w) moving images (one per frame), numpy or a tensor
        (a tensor on ``device`` is used in place, never copied through the
        host; an ``expand``-ed view is fine).
      refs:   (F, h, w) comparison canvases, numpy or a tensor.
      cs:     (F, L, 2) per-frame constant pixel displacements (x/y order).
      mesh: ``None`` or one device; more raises ``NotImplementedError``.

    Frames run one after another on ``device``, each through
    :func:`evaluate_from_displacements` (float64 surfaces, full chunked
    inverse).  Returns the (F, L) float64 score array, or None when a
    precondition fails for the stack or any frame (method, shapes, shifts
    of a quarter frame or more).
    """
    check_single_device_mesh(mesh)
    cs = np.asarray(cs, dtype=np.float64)
    if cs.ndim != 3 or cs.shape[-1] != 2:
        return None
    shape = tuple(np.shape(smalls))
    if shape != tuple(np.shape(refs)) or len(shape) != 3 \
            or shape[0] != cs.shape[0] or shape[0] == 0:
        return None
    out = []
    for f in range(shape[0]):
        # one frame at a time: a tensor stack (or an expand-ed view) is
        # indexed in place, never made contiguous or copied whole
        r = evaluate_from_displacements(
            smalls[f], refs[f], cs[f], 0.0, order=order, device=device,
            compute_dtype=compute_dtype, method=method)
        if r is None:
            return None
        out.append(r)
    return np.stack(out)
