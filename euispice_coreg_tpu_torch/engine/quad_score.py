"""K2: fused per-lag quadratic-displacement warp + Pearson/residue sums
(Hopper kernel + host).

Counterpart of ``euispice_coreg_tpu/engine/pallas_quad.py`` and of the
residue helpers of ``engine/pallas_common.py``.  The Carrington select path
(``engine/carrington._carrington_select``) fits each lag's displacement on
the pre-warped Carrington grid with a quadratic map in the grid indices,
``(L, 6, 2)`` coefficients for ``[x, y, 1, x^2, y^2, x*y] -> (dx, dy)``.
Per lag the pre-warped image is sampled at ``(j + dx, i + dy)`` and scored
against the reference on the same grid; the kernel returns the raw sums per
lag and the host finishes the score in float64.

* :func:`quad_score_sums` is the kernel's wrapper: on a CUDA tensor it
  launches ``csrc/quad_score.cu`` (built at first use, engine/_build.py) or
  raises; on a CPU tensor it runs :func:`quad_score_sums_reference`, the
  plain torch version built on ``core.resample.sample_image``.  Any other
  device raises.
* :func:`evaluate_select_quad` is the host wrapper (the counterpart of
  ``evaluate_select_carr_pallas``): coefficient table, centring, canvas,
  launch and finish.

The semantics are exactly ``sample_image``'s on the quadratic field (mirror
taps, NaN fill), so the TPU kernel's per-tile shifts, select windows and
its ``max_m`` decline have no counterpart: every lag is scored.
"""
from __future__ import annotations

import ctypes
import logging

import numpy as np
import torch
import torch.nn.functional as F

from ..core import resample
from ..utils import mesh as mesh_mod
from ..utils.obs import stage
from ..utils.torchcfg import resolve_device, resolve_dtype, to_tensor
from . import _build
from .warp_score import (MAX_LAGS, PAD, build_tiles, launch_geometry,
                         pearson_from_sums)

# kernel launches made by quad_score_sums (CUDA tensors only)
LAUNCHES = 0

METHODS = {"correlation": 0, "residus_masked": 1}
N_SUMS = {"correlation": 6, "residus_masked": 3}


def coeff_table(coeffs) -> np.ndarray:
    """(L, 6, 2) quadratic maps -> (L, 12) float64 rows: the six dx
    coefficients, then the six dy coefficients."""
    cf = np.asarray(coeffs, dtype=np.float64)
    return np.concatenate([cf[:, :, 0], cf[:, :, 1]], axis=1)


def residus_from_sums(sums):
    """(L, >=3) raw sums [n, Sd, Sdd] -> (L,) masked residue std, float64
    on host."""
    sums = np.asarray(sums, dtype=np.float64)
    n, Sd, Sdd = (sums[:, k] for k in range(3))
    with np.errstate(invalid="ignore", divide="ignore"):
        mean = Sd / n
        var = Sdd / n - mean * mean
        return np.sqrt(np.maximum(var, 0.0))


def quad_canvases(warped, ref, *, method):
    """The kernel's operands from the pre-warped image and the reference
    (the counterpart of ``pallas_quad._build_canvases``): for correlation
    both are centred on their NaN-mean (exact for Pearson, and it keeps the
    float32 sums well conditioned); residues take the raw values.  Returns
    (canvas, ref): the image mirror-padded by :data:`PAD` px and the
    reference, both contiguous."""
    if method == "correlation":
        ref = ref - torch.nanmean(ref.double()).to(ref.dtype)
        warped = warped - torch.nanmean(warped.double()).to(warped.dtype)
    canvas = F.pad(warped[None, None], (PAD,) * 4, mode="reflect")[0, 0]
    return canvas.contiguous(), ref.contiguous()


def quad_fields(table, h, w):
    """Sampling coordinates (x, y), each (B, h, w), of the lags of ``table``
    ((B, 12), the canvas dtype): the polynomial in the kernel's float
    operation order."""
    dt, dev = table.dtype, table.device
    jj = torch.arange(w, dtype=dt, device=dev).expand(h, w)
    ii = torch.arange(h, dtype=dt, device=dev)[:, None].expand(h, w)
    c = table[:, :, None, None]
    dx = (c[:, 0] * jj + c[:, 1] * ii + c[:, 2] + c[:, 3] * jj * jj
          + c[:, 4] * ii * ii + c[:, 5] * jj * ii)
    dy = (c[:, 6] * jj + c[:, 7] * ii + c[:, 8] + c[:, 9] * jj * jj
          + c[:, 10] * ii * ii + c[:, 11] * jj * ii)
    return jj + dx, ii + dy


def quad_score_sums_reference(canvas, ref, table, *, pad, order, method):
    """Plain torch version of the kernel: (L, 6) float64 Pearson sums
    [n, Sa, Saa, Sb, Sbb, Sab] or (L, 3) residue sums [n, Sd, Sdd], 8 lags
    at a time.  The canvas interior is the image; ``sample_image`` mirrors
    its taps itself."""
    h, w = ref.shape
    image = canvas[pad:pad + h, pad:pad + w]
    finite_a = torch.isfinite(ref)
    out = []
    for s in range(0, table.shape[0], 8):
        x, y = quad_fields(table[s:s + 8], h, w)
        b = resample.sample_image(image, x, y, order=order)
        if method == "correlation":
            mask = finite_a & torch.isfinite(b)
            am = torch.where(mask, ref, 0.0).double()
            bm = torch.where(mask, b, 0.0).double()
            sums = [mask.sum((-2, -1)).double(), am.sum((-2, -1)),
                    (am * am).sum((-2, -1)), bm.sum((-2, -1)),
                    (bm * bm).sum((-2, -1)), (am * bm).sum((-2, -1))]
        else:
            d = (ref - b) / torch.sqrt(ref)
            mask = torch.isfinite(d)
            dm = torch.where(mask, d, 0.0).double()
            sums = [mask.sum((-2, -1)).double(), dm.sum((-2, -1)),
                    (dm * dm).sum((-2, -1))]
        out.append(torch.stack(sums, dim=-1))
    return torch.cat(out)


def _check_operands(canvas, ref, table, pad, order, method):
    dev, dt = canvas.device, canvas.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"quad_score takes float32 or float64, got {dt}")
    h, w = ref.shape
    for name, t, shape in (("canvas", canvas, (h + 2 * pad, w + 2 * pad)),
                           ("ref", ref, (h, w))):
        if t.device != dev or t.dtype != dt:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, expected "
                            f"{dt} on {dev}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {shape}, got "
                             f"{tuple(t.shape)}")
    if (table.device != dev or table.dtype != dt or table.ndim != 2
            or table.shape[1] != 12 or not table.is_contiguous()):
        raise ValueError("table: expected a contiguous (L, 12) tensor of the "
                         "canvas dtype and device")
    if not 1 <= table.shape[0] <= MAX_LAGS:
        raise ValueError(f"table: 1..{MAX_LAGS} lags per launch, got "
                         f"{table.shape[0]}")
    if order not in (0, 1, 2) or method not in METHODS or not 1 <= pad:
        raise ValueError(f"unsupported order={order} method={method} "
                         f"pad={pad}")
    if min(h, w) < 2 or pad > min(h, w) - 1:
        raise ValueError(f"image {h}x{w} too small for a {pad}-px mirror pad")


def quad_score_sums(canvas, ref, table, *, pad, order, method):
    """Raw sums per lag, float64: (L, 6) for ``method="correlation"``,
    (L, 3) for ``"residus_masked"``.

    ``canvas`` is the pre-warped image mirror-padded by ``pad`` px and
    ``ref`` the reference on the same grid (both centred for correlation,
    :func:`quad_canvases`); ``table`` holds the per-lag coefficients
    (:func:`coeff_table`) in the canvas dtype.  CUDA tensors launch the
    kernel; CPU tensors run the plain version.
    """
    _check_operands(canvas, ref, table, pad, order, method)
    if canvas.device.type == "cuda":
        return _launch(canvas, ref, table, pad=pad, order=order,
                       method=method)
    if canvas.device.type == "cpu":
        return quad_score_sums_reference(canvas, ref, table, pad=pad,
                                         order=order, method=method)
    raise RuntimeError(f"quad_score: no kernel for device {canvas.device}")


def _kernel_fn(lib, dtype):
    fn = lib.quad_score_sums_f32 if dtype == torch.float32 \
        else lib.quad_score_sums_f64
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(canvas, ref, table, *, pad, order, method):
    global LAUNCHES
    lib = _build.load("quad_score")
    fn = _kernel_fn(lib, canvas.dtype)
    h, w = ref.shape
    n_lags = table.shape[0]
    n_sums = N_SUMS[method]
    _, n_groups = launch_geometry(h, w, n_lags,
                                  build_tiles(lib, "quad_score"))
    dev = canvas.device
    partial = torch.empty((n_lags, n_groups, n_sums), dtype=torch.float64,
                          device=dev)
    out = torch.empty((n_lags, n_sums), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(canvas.data_ptr(), ref.data_ptr(), table.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), h, w, pad, n_lags,
                 n_groups, order, METHODS[method], stream)
    if err != 0:
        raise RuntimeError(f"quad_score kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


def evaluate_select_quad(coeffs, warped, ref_img, *, order,
                         method="correlation", device,
                         compute_dtype="float32", mesh=None):
    """Score ``L`` quadratic-displacement lags against ``ref_img``.

    ``coeffs``: (L, 6, 2) float64 maps ``[x, y, 1, x^2, y^2, x*y] ->
    (dx, dy)`` in grid pixels (the ``_carrington_select`` fit); ``warped``
    the (h, w) pre-warped image, ``ref_img`` the reference on the same grid
    (arrays or tensors).  Returns (L,) float64 Pearson r or residue std, or
    None for what the kernel does not compute (another method or order, an
    image under 3 px a side, a reference of another shape).

    ``mesh``: a sequence of devices (:mod:`..utils.mesh`); the lag axis is
    split over them, the canvases replicated to each device, every shard
    launched before the first is read back (the counterpart of the JAX
    evaluator's ``shard_map`` over lags).
    """
    if method not in METHODS or order not in (0, 1, 2):
        return None
    with stage("k2_s", card=True, level=logging.INFO):
        return _evaluate_k2(coeffs, warped, ref_img, order=order,
                            method=method, device=device,
                            compute_dtype=compute_dtype, mesh=mesh)


def _evaluate_k2(coeffs, warped, ref_img, *, order, method, device,
                 compute_dtype, mesh):
    """:func:`evaluate_select_quad` once its method and order apply."""
    dev = resolve_device(device)
    dt = resolve_dtype(compute_dtype)
    devices = mesh_mod.resolve_mesh(mesh) or (dev,)
    warped_t = to_tensor(warped, device=dev, dtype=dt)
    ref_t = to_tensor(ref_img, device=dev, dtype=dt)
    h, w = warped_t.shape
    if ref_t.shape != warped_t.shape or min(h, w) <= PAD:
        return None
    canvas, ref_c = quad_canvases(warped_t, ref_t, method=method)
    table = coeff_table(coeffs)
    ranges = mesh_mod.split(table.shape[0], devices)
    canvases = mesh_mod.replicate(canvas, devices)
    refs = mesh_mod.replicate(ref_c, devices)
    # every upload before the first launch (a host-to-device copy waits for
    # its device's queue)
    tables = [torch.as_tensor(table[a:b], dtype=dt, device=d)
              for (a, b), d in zip(ranges, devices)]
    parts = {}
    for k, s, e in mesh_mod.round_robin(ranges, MAX_LAGS):
        a = ranges[k][0]
        parts[s] = quad_score_sums(canvases[k], refs[k],
                                   tables[k][s - a:e - a], pad=PAD,
                                   order=order, method=method)
    sums = mesh_mod.gather(parts).numpy()
    if method == "correlation":
        return pearson_from_sums(sums)
    return residus_from_sums(sums)
