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
inverse and fused readout (``_box_inverse``/``_readout_contract``) and the
memo caches.

Sharding (``mesh=``, a sequence of devices, :mod:`..utils.mesh`): one pair's
surface planes are split over the devices, each building the fields from
replicated images and running the transforms, products, inverses and
readout of its own planes (the JAX ``surfaces_at_sharded``); a movie's frame
axis is split over them, each device running its frames in sequence (the
JAX ``_movie_eval_fn``).  The host finishes every score in float64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import wcs
from ..utils import mesh as mesh_mod
from ..utils import obs
from ..utils.torchcfg import resolve_device, resolve_dtype, to_tensor
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


def _plane_runs(order, score):
    """The product planes of :func:`_build_surfaces` in runs of one g field
    against consecutive r fields: ``(g index, first r index, count)``."""
    nt = len(_tap_offsets(order)) ** 2
    npairs = nt * (nt + 1) // 2
    g = (0, 1, 2, 0, 1, 0) if score == "pearson" else (0, 1, 2, 3, 4, 5)
    r = ((0, 1), (0, 1), (0, 1), (1, nt), (1, nt), (1 + nt, npairs))
    return [(gi, r0, n) for gi, (r0, n) in zip(g, r)]


def _n_surfaces(order, score="pearson"):
    """Number of product planes (surfaces) of one pair."""
    return sum(n for _g, _r0, n in _plane_runs(order, score))


def _fields(small, ref, order, score):
    """The g fields (reference side) and r fields (image side) of
    :func:`_build_surfaces`, as two lists of (h, w) tensors."""
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
    return g_list, r_fields


def _build_surfaces(small, ref, order, m, score="pearson", planes=None):
    """Frequency-domain cross-correlation products, shape (n_planes, m,
    m//2+1) (callers apply the inverse FFT, chunked): all of them, or the
    product planes ``planes = (start, stop)`` only (a shard's share: only
    the g and r fields those planes read are transformed).

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
    g_list, r_fields = _fields(small, ref, order, score)
    a, b = (0, _n_surfaces(order, score)) if planes is None else planes
    runs, p = [], 0  # (g, first r, last r + 1) of the planes in [a, b)
    for gi, r0, n in _plane_runs(order, score):
        lo, hi = max(a, p), min(b, p + n)
        if lo < hi:
            runs.append((gi, r0 + lo - p, r0 + hi - p))
        p += n
    need_g = sorted({gi for gi, _s, _e in runs})
    need_r = sorted({i for _g, s0, e0 in runs for i in range(s0, e0)})
    G = torch.fft.rfft2(torch.stack([g_list[i] for i in need_g]), s=(m, m))
    R = torch.fft.rfft2(torch.stack([r_fields[i] for i in need_r]),
                        s=(m, m))
    del g_list, r_fields
    gpos = {gi: k for k, gi in enumerate(need_g)}
    rpos = {ri: k for k, ri in enumerate(need_r)}
    return torch.cat([
        torch.conj(G[gpos[gi]:gpos[gi] + 1]) * R[rpos[s0]:rpos[s0] + e0 - s0]
        for gi, s0, e0 in runs])


def _surfaces_at(small, ref, iy, ix, order, m, score="pearson", planes=None):
    """Surface values at the per-lag integer offsets: (n_planes, L), of
    every product plane or of ``planes = (start, stop)``.

    The inverse FFTs run in chunks of 8 so the full (n_surf, m, m) surface
    stack never materializes at once."""
    prods = _build_surfaces(small, ref, order, m, score=score, planes=planes)
    vals = []
    for k in range(0, prods.shape[0], 8):
        surf = torch.fft.irfft2(prods[k:k + 8], s=(m, m))
        vals.append(surf[:, iy, ix])
    return torch.cat(vals)


def _surfaces_sharded(small, ref, iy, ix, order, m, score, devices):
    """:func:`_surfaces_at` of one pair with the surface planes split over
    ``devices`` (images and offsets replicated, each device reading out its
    own planes): the (n_surf, L) values as a float64 CPU tensor."""
    ranges = mesh_mod.split(_n_surfaces(order, score), devices)
    smalls = mesh_mod.replicate(small, devices)
    refs = mesh_mod.replicate(ref, devices)
    iys = mesh_mod.replicate(iy, devices)
    ixs = mesh_mod.replicate(ix, devices)
    parts = {}
    for k, (a, b) in enumerate(ranges):
        if b > a:
            parts[a] = _surfaces_at(smalls[k], refs[k], iys[k], ixs[k], order,
                                    m, score=score, planes=(a, b))
    return mesh_mod.gather(parts).to(torch.float64)


def _frames_surfaces(frames, order, score, devices, dtype):
    """Surface values of F pairs with the frame axis split over
    ``devices``: ``frames`` is a list of ``(small, ref, iy, ix, m)`` (arrays
    or tensors; an operand shared by several frames, the same object, is
    placed once per device).  The images are placed in ``dtype`` and
    surfaced in float64, as :func:`evaluate_from_displacements` does.
    Every operand is placed before the first launch, each device runs its
    frames in sequence, the shards taken in turn; returns the F (n_surf, L)
    float64 CPU tensors."""
    ranges = mesh_mod.split(len(frames), devices)
    placed, ops = {}, []
    for k, (a, b) in enumerate(ranges):
        for f in range(a, b):
            row = []
            for x, dt in zip(frames[f][:4],
                             (dtype, dtype, torch.int64, torch.int64)):
                key = (id(x), devices[k])
                if key not in placed:
                    placed[key] = to_tensor(x, device=devices[k], dtype=dt)
                row.append(placed[key])
            ops.append(row)
    parts = {}
    for _k, f, _e in mesh_mod.round_robin(ranges, 1):
        small, ref, iy, ix = ops[f]
        parts[f] = _surfaces_at(small.to(torch.float64),
                                ref.to(torch.float64), iy, ix, order,
                                frames[f][4], score=score)
    return [parts[f].to(torch.float64).cpu() for f in range(len(frames))]


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
    mesh=None,
):
    """Scores (masked Pearson or residue) for a crval1 x crval2 lag grid.

    Returns (n1, n2) float64 array, or None if the constant-displacement
    bound is violated (caller falls back to the general engine).  ``mesh``:
    see :func:`evaluate_from_displacements`.
    """
    l1 = np.asarray(lag_crval1_deg, dtype=np.float64)
    l2 = np.asarray(lag_crval2_deg, dtype=np.float64)
    g1, g2 = np.meshgrid(l1, l2, indexing="ij")
    lags = np.stack([g1.ravel(), g2.ravel()], axis=-1)

    with obs.stage("fast_hostprep_s"):
        c, spread = displacement_per_lag(base_params, lags, lon, lat, kind)
    r = evaluate_from_displacements(
        small_img, ref_img, c, spread, order=order, device=device,
        compute_dtype=compute_dtype, method=method, mesh=mesh,
    )
    if r is None:
        return None
    return r.reshape(len(l1), len(l2))


def _offsets_plan(c, h, w):
    """Integer and fractional parts of the displacements ``c`` ((L, 2)) and
    the transform size m for an h x w pair, or None when a shift reaches a
    quarter of the frame."""
    c = np.asarray(c, dtype=np.float64)
    # stencil base convention must match the resampler: k = floor(c + 0.5)
    dint = np.floor(c + 0.5).astype(np.int64)
    dfrac = c - dint  # in [-0.5, 0.5)
    if np.max(np.abs(dint)) + 2 >= min(h, w) // 4:
        return None  # shifts too large relative to the frame
    return dint, dfrac, _fft_size(max(h, w) + int(np.max(np.abs(dint))) + 4)


def evaluate_from_displacements(small_img, ref_img, c, spread, *,
                                order: int = 2, device,
                                compute_dtype="float32",
                                method: str = "correlation", mesh=None):
    """Scores for a list of constant pixel displacements ``c`` ((L, 2), x/y
    order) of the moving image relative to the comparison grid.

    ``method``: ``"correlation"`` (masked Pearson) or ``"residus_masked"``
    (masked residue std).  Raw ``"residus"`` is not factorizable faithfully
    (its NaN propagation needs every grid pixel valid) and always takes the
    exact per-lag engine.

    ``mesh``: a sequence of devices; the surface planes are split over
    them (:func:`_surfaces_sharded`).

    Returns the (L,) score vector, or None when the spread bound or the
    frame-size precondition fails.
    """
    if method not in ("correlation", "residus_masked"):
        return None
    score = "pearson" if method == "correlation" else "residus"
    if spread > MAX_DISPLACEMENT_SPREAD_PX:
        return None

    h, w = np.shape(small_img)
    plan = _offsets_plan(c, h, w)
    if plan is None:
        return None
    dint, dfrac, m = plan
    dev = resolve_device(device)
    dt = resolve_dtype(compute_dtype)
    devices = mesh_mod.resolve_mesh(mesh) or (dev,)
    small_d = to_tensor(small_img, device=dev, dtype=dt)
    ref_d = to_tensor(ref_img, device=dev, dtype=dt)
    iy = torch.as_tensor(np.mod(dint[:, 1], m), device=dev)
    ix = torch.as_tensor(np.mod(dint[:, 0], m), device=dev)
    with obs.stage("fast_surfaces_s"):
        # The surfaces (fields, FFTs, products, inverse FFTs) are built in
        # float64 whatever the operands' compute dtype: on an H100, float32
        # cuFFT surfaces kept the headline pair's argmax but shrank its top-2
        # margin below the float64 build's (PERF.md).
        S = _surfaces_sharded(small_d.to(torch.float64),
                              ref_d.to(torch.float64), iy, ix, order, m,
                              score, devices).numpy()
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
    return pearson_integer_shifts_frames([fixed_img], moving_img, dxs, dys,
                                         device=device)[0]


def pearson_integer_shifts_frames(fixed_imgs, moving_img, dxs, dys, *,
                                  device, mesh=None):
    """:func:`pearson_integer_shifts` of F fixed images against one moving
    image, the frames of one movie evaluation: the frame axis is split over
    ``mesh`` (a sequence of devices; None: ``device`` alone), the moving
    image placed once per device.  Returns (F, len(dxs), len(dys))
    float64."""
    dxs = np.asarray(dxs, dtype=np.int64)
    dys = np.asarray(dys, dtype=np.int64)
    h, w = np.shape(moving_img)
    m = _fft_size(max(h, w)
                  + int(max(np.max(np.abs(dxs)), np.max(np.abs(dys)))) + 2)
    gx, gy = np.meshgrid(dxs, dys, indexing="ij")
    iy, ix = np.mod(gy.ravel(), m), np.mod(gx.ravel(), m)
    devices = mesh_mod.resolve_mesh(mesh) or (resolve_device(device),)
    frames = [(moving_img, fixed, iy, ix, m) for fixed in fixed_imgs]
    out = []
    for S in _frames_surfaces(frames, 0, "pearson", devices, torch.float64):
        n, Sa, Saa, Sb, Sab, Sbb = S.numpy()
        with np.errstate(invalid="ignore", divide="ignore"):
            num = Sab - Sa * Sb / n
            den = np.sqrt((Saa - Sa * Sa / n) * (Sbb - Sb * Sb / n))
        out.append((num / den).reshape(len(dxs), len(dys)))
    return np.stack(out)


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
      mesh: a sequence of devices (None: ``device`` alone); the frame axis
        is split over them in contiguous ranges, each device running its
        frames one after another (the JAX ``shard_map`` over frames).

    Each frame computes what :func:`evaluate_from_displacements` computes
    for it (float64 surfaces, full chunked inverse).  Returns the (F, L)
    float64 score array, or None when a precondition fails for the stack or
    any frame (method, shapes, shifts of a quarter frame or more), checked
    on the host before any device work.
    """
    if method not in ("correlation", "residus_masked"):
        return None
    score = "pearson" if method == "correlation" else "residus"
    cs = np.asarray(cs, dtype=np.float64)
    if cs.ndim != 3 or cs.shape[-1] != 2:
        return None
    shape = tuple(np.shape(smalls))
    if shape != tuple(np.shape(refs)) or len(shape) != 3 \
            or shape[0] != cs.shape[0] or shape[0] == 0:
        return None
    plans = [_offsets_plan(c, shape[1], shape[2]) for c in cs]
    if any(p is None for p in plans):
        return None
    dt = resolve_dtype(compute_dtype)
    devices = mesh_mod.resolve_mesh(mesh) or (resolve_device(device),)
    # one frame at a time: a tensor stack (or an expand-ed view) is indexed
    # in place, never made contiguous or copied whole
    frames = [(smalls[f], refs[f], np.mod(dint[:, 1], m),
               np.mod(dint[:, 0], m), m)
              for f, (dint, _dfrac, m) in enumerate(plans)]
    S = _frames_surfaces(frames, order, score, devices, dt)
    return np.stack([_combine_scores(s.numpy(), dfrac, order, score)
                     for s, (_dint, dfrac, _m) in zip(S, plans)])
