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
// Layout: grid = (n_blocks, n_lags); blockIdx.y is the lag, blockIdx.x
// strides over pixel chunks.  Each block reads its lag's 12 coefficients;
// each thread gathers its 1/4/9 taps straight from the canvas.  A gather is
// cheap here, so the TPU kernel's per-tile integer shifts, select windows,
// residual bound (max_m) and DMA margins have no counterpart: every lag is
// computed, whatever its displacement.  Reduction: sampling.cuh, two stages,
// deterministic, no atomics.
//
// What should bound it: per pixel and lag one gather of up to 9 taps from
// the canvas plus one ref load, i.e. L2/DRAM traffic and issue slots (no
// transcendental functions).  The ref loads do not depend on the lag and are
// repeated for every lag; handling several lags per block, so that one ref
// load serves them all, is later work (as for K1).  No trace has measured
// which of these limits it.
//
// Numerics: the arithmetic repeats the torch version operation by
// operation; build with -fmad=false so that no multiply-add is contracted.
//
// Built by engine/_build.py with nvcc for sm_90a into a shared library with
// a plain C interface (bound with ctypes).  Launches go to the caller's
// stream; nothing here allocates or synchronises.

#include <cuda_runtime.h>

#include "sampling.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCoeffs = 12;

template <typename T, int ORDER, int METHOD>
__global__ void __launch_bounds__(kThreads)
quad_score_kernel(const T* __restrict__ canvas, const T* __restrict__ ref,
                  const T* __restrict__ coeffs, double* __restrict__ partial,
                  int h, int w, int pad) {
  constexpr int kSums = METHOD == 0 ? 6 : 3;
  const int lag = blockIdx.y;
  const T* c = coeffs + static_cast<size_t>(lag) * kCoeffs;
  const T c0 = c[0], c1 = c[1], c2 = c[2], c3 = c[3], c4 = c[4], c5 = c[5];
  const T c6 = c[6], c7 = c[7], c8 = c[8], c9 = c[9], c10 = c[10], c11 = c[11];
  const int cw = w + 2 * pad;
  const T xmax = T(w - 1);
  const T ymax = T(h - 1);
  const long long npix = static_cast<long long>(h) * w;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;

  double acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < npix; p += stride) {
    const T a = ref[p];
    if (METHOD == 0 && !isfinite(a)) continue;
    const int i = static_cast<int>(p / w);
    const int j = static_cast<int>(p - static_cast<long long>(i) * w);
    const T jj = T(j);
    const T ii = T(i);
    const T dx = c0 * jj + c1 * ii + c2 + c3 * jj * jj + c4 * ii * ii + c5 * jj * ii;
    const T dy = c6 * jj + c7 * ii + c8 + c9 * jj * jj + c10 * ii * ii + c11 * jj * ii;
    const T x = jj + dx;
    const T y = ii + dy;
    // NaN fails every comparison, so NaN coordinates are rejected too
    if (!(x >= T(0) && x <= xmax && y >= T(0) && y <= ymax)) continue;
    const T b = eui::sample_padded<T, ORDER>(canvas, cw, pad, x, y);
    if constexpr (METHOD == 0) {
      if (!isfinite(b)) continue;
      const double ad = static_cast<double>(a);
      const double bd = static_cast<double>(b);
      acc[0] += 1.0;
      acc[1] += ad;
      acc[2] += ad * ad;
      acc[3] += bd;
      acc[4] += bd * bd;
      acc[5] += ad * bd;
    } else {
      const T d = (a - b) / eui::sqrt_t(a);
      if (!isfinite(d)) continue;
      const double dd = static_cast<double>(d);
      acc[0] += 1.0;
      acc[1] += dd;
      acc[2] += dd * dd;
    }
  }

  eui::store_block_sums<kSums, kThreads>(
      acc, partial + (static_cast<size_t>(lag) * gridDim.x + blockIdx.x) * kSums);
}

template <typename T, int ORDER, int METHOD>
cudaError_t launch_main(const T* canvas, const T* ref, const T* coeffs,
                        double* partial, double* out, int h, int w, int pad,
                        int n_lags, int n_blocks, cudaStream_t stream) {
  constexpr int kSums = METHOD == 0 ? 6 : 3;
  const dim3 grid(n_blocks, n_lags);
  quad_score_kernel<T, ORDER, METHOD><<<grid, kThreads, 0, stream>>>(
      canvas, ref, coeffs, partial, h, w, pad);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return eui::launch_reduce<kSums>(partial, out, n_lags, n_blocks, kThreads,
                                   stream);
}

template <typename T>
int quad_score_sums(const T* canvas, const T* ref, const T* coeffs,
                    double* partial, double* out, int h, int w, int pad,
                    int n_lags, int n_blocks, int order, int method,
                    void* stream_ptr) {
  if (h < 1 || w < 1 || pad < 1 || n_lags < 1 || n_lags > 65535 ||
      n_blocks < 1 || order < 0 || order > 2 || method < 0 || method > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaSuccess;
#define EUI_LAUNCH(O, M)                                                  \
  err = launch_main<T, O, M>(canvas, ref, coeffs, partial, out, h, w, pad, \
                             n_lags, n_blocks, stream)
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

extern "C" int quad_score_sums_f32(const float* canvas, const float* ref,
                                   const float* coeffs, double* partial,
                                   double* out, int h, int w, int pad,
                                   int n_lags, int n_blocks, int order,
                                   int method, void* stream) {
  return quad_score_sums<float>(canvas, ref, coeffs, partial, out, h, w, pad,
                                n_lags, n_blocks, order, method, stream);
}

extern "C" int quad_score_sums_f64(const double* canvas, const double* ref,
                                   const double* coeffs, double* partial,
                                   double* out, int h, int w, int pad,
                                   int n_lags, int n_blocks, int order,
                                   int method, void* stream) {
  return quad_score_sums<double>(canvas, ref, coeffs, partial, out, h, w, pad,
                                 n_lags, n_blocks, order, method, stream);
}
