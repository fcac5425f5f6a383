"""Roofline arithmetic of the port's two hand-written kernels.

Copied from ``chip_smoke.py`` (``PEAK_F32``, ``PEAK_F64``, ``PEAK_BYTES``,
``OPS`` and ``kernel_bound``, lines 236-273) at commit 6bb729c, and frozen
here so that the yardstick does not move with the program.  The peaks are
NVIDIA's H100 SXM data sheet at 700 W, dense rates: 67 TFLOP/s float32 and
34 TFLOP/s float64 outside the tensor cores (a fused multiply-add counts
two operations), HBM3 at 3.35 TB/s.  The operation counts were taken from
``csrc/warp_score.cu`` and ``csrc/quad_score.cu`` at that commit (a
division, a sine or a cosine counts one): ``pixel`` float32 once per pixel
whose reference value is finite (K1 TAN: lon and lat to radians, their sine
and cosine); ``lag`` float32 per such pixel and lag (K2: the quadratic
field 26, x and y 2, the range test 4; K1 TAN: the projection 17, the
inverse CDELT/PC step 14, the range test 4); ``sum_f32`` and ``sum_f64``
per pixel-lag that is summed (the order-2 taps 22, the 9-tap sample 27, the
finiteness test 1; float64 Sa, Saa, Sb and Sbb, Sab as multiply-adds).

Bytes count each operand once and the sums once: K1 reads a float32 canvas
of the small image mirror-padded by ``PAD`` pixels, the reference, the
comparison grid's lon and lat, and a lag table of ``K1_PARAMS`` float32 per
lag; K2 reads the padded canvas, the reference and ``K2_COEFFS`` float32 per
lag; both write six float64 sums per lag (``warp_score.PAD``, ``kParams``
and ``kCoeffs`` at that commit).
"""
from __future__ import annotations

PEAK_F32 = 67e12
PEAK_F64 = 34e12
PEAK_BYTES = 3.35e12
PEAK_SOURCE = "NVIDIA H100 SXM data sheet, 700 W"

OPS = {"K2": {"pixel": 0, "lag": 32, "sum_f32": 50, "sum_f64": 7},
       "K1 tan": {"pixel": 4, "lag": 35, "sum_f32": 50, "sum_f64": 7},
       "K1 car": {"pixel": 0, "lag": 20, "sum_f32": 50, "sum_f64": 7}}

PAD = 2
K1_PARAMS = 10
K2_COEFFS = 12
F32, F64, SUMS = 4, 8, 6


def kernel_bound(kernel, n_ref, n_lags, n_summed, nbytes):
    """(bound_ms, bound_by) of one launch: the larger of its operations over
    the float32 or float64 peak and its bytes over the memory rate."""
    ops = OPS[kernel]
    f32 = n_ref * (ops["pixel"] + n_lags * ops["lag"]) \
        + n_summed * ops["sum_f32"]
    t_ops = max(f32 / PEAK_F32, n_summed * ops["sum_f64"] / PEAK_F64)
    t_bytes = nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def launch_bytes(kernel, h, w, n_lags):
    """Bytes one launch over an h x w grid and ``n_lags`` lags moves."""
    canvas = (h + 2 * PAD) * (w + 2 * PAD) * F32
    grids = (3 if kernel.startswith("K1") else 1) * h * w * F32
    table = n_lags * (K1_PARAMS if kernel.startswith("K1") else K2_COEFFS) \
        * F32
    return canvas + grids + table + n_lags * SUMS * F64


def share_percent(kernel, counts, kernel_ms):
    """A launch's share of its bound, in %, from ``counts`` (``h``, ``w``,
    ``n_ref``, ``n_lags``, ``n_summed``) and its measured milliseconds."""
    bound, _ = kernel_bound(kernel, counts["n_ref"], counts["n_lags"],
                            counts["n_summed"],
                            launch_bytes(kernel, counts["h"], counts["w"],
                                         counts["n_lags"]))
    return 100.0 * bound / kernel_ms
