// K2 for Hopper: fused per-lag quadratic-displacement warp + masked
// Pearson / residue partial sums.
//
// Replaces euispice_coreg_tpu/engine/pallas_quad.py::_make_kernel (:39), the
// Pallas TPU kernel of the Carrington select path.  Each lag is a quadratic
// displacement field over the grid indices, 12 coefficients
//   dx = c0 j + c1 i + c2 + c3 j^2 + c4 i^2 + c5 j i      (c6..c11: dy)
// fitted by engine/carrington._carrington_select.  For each lag and each
// pixel (i, j) of the Carrington grid the kernel evaluates the field in the
// operation order of the torch version, x = j + dx, y = i + dy, masks NaN
// and out-of-range coordinates as core/resample.sample_image does, samples
// the pre-warped image (2-px mirror-padded canvas) with the order-0/1/2
// B-spline taps and accumulates in float64
//   method 0, correlation:    [n, Sa, Saa, Sb, Sbb, Sab] over pixels where
//                             ref and the sample are both finite (canvas and
//                             ref mean-centred by the host);
//   method 1, residus_masked: [n, Sd, Sdd], d = (a - s) / sqrt(a), over
//                             pixels where d is finite (no centring).
// The host finishes r or the residue std in float64
// (engine/quad_score.py).
//
// Layout: the lag-tile skeleton of sampling.cuh.  A block scores the
// kLagTile (4) lags of its lag tile, coefficients in shared memory, over
// every G-th 32 x 8 pixel tile.  Per pixel, once for those lags: the ref
// load and its test (finite; for residues also positive, since d is NaN or
// infinite otherwise), sqrt(ref), (float)i and (float)j from 32-bit tile
// coordinates, and the float64 ref terms.  Per lag: the field and the range
// test (`coords`); then, unless no pixel of the warp lands inside the image
// for any lag of the tile, 1/4/9 taps gathered straight from the canvas and
// the predicated sums (`score`, no branch).  Every lag is computed,
// whatever its displacement: no per-tile shifts, select windows, residual
// bound (max_m) or DMA margins, and no lag is declined.
//
// What bounds it (tools/time_lag_tiles.py and chip_smoke.py, PERF.md;
// NVIDIA H100 80GB HBM3, 700.00 W, 132 SMs, highest SM clock 1980 MHz):
// not memory, and not the float32 arithmetic alone.  At 2048^2 x 14641
// lags the kernel takes ~313 ms (one lag per block, as first ported:
// 401 ms) against an operations bound of ~74 ms (82 float32 operations a
// pixel-lag at the 67 TFLOP/s FMA peak), share ~0.24; its ~35 MB of canvas
// and ref would take 0.01 ms at the HBM rate.  The main loop's SASS
// (float32, order 2) issues 134 instructions a pixel-lag: 75 float32 adds
// and multiplies (no FMA, so that each rounds as the torch version's does),
// 32 integer, compare and select, 12 loads, 6 conversions, 5 float64.  At
// one instruction per scheduler and clock that stream needs ~244 ms, so
// the kernel runs at ~0.78 of its issue ceiling, and every pipe's own
// ceiling (float32 ~137 ms, loads ~89 ms) lies under it; a static count,
// not a counter reading (ncu does not run on the card's machine).
// -fmad=true ran 10% faster but moved residue sums by 6e-4 of their size,
// beyond the 1e-5 contract.  LT = 4 with three resident blocks (80
// registers, no spills) was the fastest of LT = 1-8 and two to four
// blocks.
//
// Numerics: the arithmetic repeats the torch version operation by
// operation (the field as (c3 j) j, not c3 (j j)); built with -fmad=false
// so that no multiply-add is contracted.  Hoisting a lag-independent value
// computes it once from the same operands, so each pixel-lag's sample is
// the torch version's bit for bit; only the float64 sums' order differs.
//
// Built by engine/_build.py with nvcc for sm_90a into a shared library with
// a plain C interface (bound with ctypes).  Launches go to the caller's
// stream; nothing here allocates or synchronises.

#include <cuda_runtime.h>

#include "sampling.cuh"

namespace {

constexpr int kLagTile = 4;  // lags per block (measured, PERF.md)
constexpr int kCoeffs = 12;

template <typename T>
struct QuadPixel {
  T a, ii, jj, root_a;  // ref, row, column, sqrt(ref) (residues)
  double ad, aa;        // ref and ref^2 in float64 (correlation)
};

template <typename T, int ORDER, int METHOD, int LT>
__global__ void __launch_bounds__(eui::kThreads, eui::kMinBlocks)
quad_score_kernel(const T* __restrict__ canvas, const T* __restrict__ ref,
                  const T* __restrict__ coeffs, double* __restrict__ partial,
                  int h, int w, int pad, int n_lags) {
  constexpr int kSums = METHOD == 0 ? 6 : 3;
  __shared__ T cf[LT][kCoeffs];
  eui::load_lag_rows<T, LT, kCoeffs>(coeffs, n_lags, cf);
  const int cw = w + 2 * pad;
  const T xmax = T(w - 1);
  const T ymax = T(h - 1);

  auto pixel = [&](int i, int j, QuadPixel<T>& p) -> bool {
    p.a = ref[static_cast<size_t>(i) * w + j];
    if (METHOD == 0) {
      if (!isfinite(p.a)) return false;
      p.ad = static_cast<double>(p.a);
      p.aa = p.ad * p.ad;
    } else {
      // d = (a - s) / sqrt(a) is NaN or infinite unless 0 < a < inf
      if (!(p.a > T(0) && isfinite(p.a))) return false;
      p.root_a = eui::sqrt_t(p.a);
    }
    p.ii = T(i);
    p.jj = T(j);
    return true;
  };

  auto coords = [&](const QuadPixel<T>& p, int l, T& x, T& y) -> bool {
    const T* c = cf[l];
    const T jj = p.jj;
    const T ii = p.ii;
    const T dx = c[0] * jj + c[1] * ii + c[2] + c[3] * jj * jj +
                 c[4] * ii * ii + c[5] * jj * ii;
    const T dy = c[6] * jj + c[7] * ii + c[8] + c[9] * jj * jj +
                 c[10] * ii * ii + c[11] * jj * ii;
    x = jj + dx;
    y = ii + dy;
    return eui::inside_image(x, y, xmax, ymax);
  };

  auto score = [&](const QuadPixel<T>& p, int, T x, T y, bool inside, int& n,
                   double (&s)[kSums - 1]) {
    if constexpr (METHOD == 0) {
      eui::add_pearson<T, ORDER>(canvas, cw, pad, x, y, inside, p.ad, p.aa, n,
                                 s);
    } else {
      // as add_pearson: no branch, the sums predicated
      const T b = eui::sample_padded<T, ORDER>(canvas, cw, pad,
                                               inside ? x : T(0),
                                               inside ? y : T(0));
      const T d = (p.a - b) / p.root_a;
      if (inside & isfinite(d)) {
        const double dd = static_cast<double>(d);
        ++n;
        s[0] += dd;
        s[1] = fma(dd, dd, s[1]);
      }
    }
  };

  eui::lag_tile_loop<LT, kSums, T, QuadPixel<T>>(h, w, n_lags, pixel, coords,
                                                  score, partial);
}

template <typename T, int ORDER, int METHOD>
cudaError_t launch_main(const T* canvas, const T* ref, const T* coeffs,
                        double* partial, double* out, int h, int w, int pad,
                        int n_lags, int n_groups, cudaStream_t stream) {
  constexpr int kSums = METHOD == 0 ? 6 : 3;
  quad_score_kernel<T, ORDER, METHOD, kLagTile>
      <<<eui::lag_tile_grid<kLagTile>(n_lags, n_groups),
         dim3(eui::kTileX, eui::kTileY), 0, stream>>>(canvas, ref, coeffs,
                                                      partial, h, w, pad,
                                                      n_lags);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return eui::launch_reduce<kSums>(partial, out, n_lags, n_groups, stream);
}

template <typename T>
int quad_score_sums(const T* canvas, const T* ref, const T* coeffs,
                    double* partial, double* out, int h, int w, int pad,
                    int n_lags, int n_groups, int order, int method,
                    void* stream_ptr) {
  if (!eui::valid_launch(h, w, pad, n_lags, n_groups) || order < 0 ||
      order > 2 || method < 0 || method > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaSuccess;
#define EUI_LAUNCH(O, M)                                                  \
  err = launch_main<T, O, M>(canvas, ref, coeffs, partial, out, h, w, pad, \
                             n_lags, n_groups, stream)
  if (method == 0) {
    if (order == 0) EUI_LAUNCH(0, 0);
    else if (order == 1) EUI_LAUNCH(1, 0);
    else EUI_LAUNCH(2, 0);
  } else {
    if (order == 0) EUI_LAUNCH(0, 1);
    else if (order == 1) EUI_LAUNCH(1, 1);
    else EUI_LAUNCH(2, 1);
  }
#undef EUI_LAUNCH
  return static_cast<int>(err);
}

}  // namespace

// [lags per block, pixel tile rows, pixel tile columns]: the host sizes the
// grid and the partial buffer with them (engine/warp_score.launch_geometry)
extern "C" void quad_score_tiles(int* out) {
  eui::report_tiles<kLagTile>(out);
}

extern "C" int quad_score_sums_f32(const float* canvas, const float* ref,
                                   const float* coeffs, double* partial,
                                   double* out, int h, int w, int pad,
                                   int n_lags, int n_groups, int order,
                                   int method, void* stream) {
  return quad_score_sums<float>(canvas, ref, coeffs, partial, out, h, w, pad,
                                n_lags, n_groups, order, method, stream);
}

extern "C" int quad_score_sums_f64(const double* canvas, const double* ref,
                                   const double* coeffs, double* partial,
                                   double* out, int h, int w, int pad,
                                   int n_lags, int n_groups, int order,
                                   int method, void* stream) {
  return quad_score_sums<double>(canvas, ref, coeffs, partial, out, h, w, pad,
                                 n_lags, n_groups, order, method, stream);
}
