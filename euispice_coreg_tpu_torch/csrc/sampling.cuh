// Device code shared by the port's kernels (warp_score.cu, quad_score.cu).
//
// * taps / sample_padded: order-0/1/2 B-spline sampling with the tap base
//   and weights of core/resample._taps_and_weights, gathered from a canvas
//   that holds the image mirror-padded by `pad` px (mirror taps at the edge,
//   as core/resample.sample_image does; the caller has already rejected
//   out-of-range and NaN coordinates).  The taps are summed in
//   sample_image's order (rows outer, columns inner, from zero).
// * store_block_sums / reduce_partials: the deterministic two-stage float64
//   reduction, with no atomics.  Each block reduces its threads' sums with
//   warp shuffles and shared memory and writes one row of a
//   (n_lags, n_blocks, NS) scratch buffer; reduce_partials sums the blocks
//   of each lag in index order into (n_lags, NS).
//
// Header-only.  engine/_build.py hashes every csrc/*.cuh into each library's
// build key, so a change here rebuilds both kernels.

#pragma once

#include <cuda_runtime.h>

namespace eui {

__device__ __forceinline__ float floor_t(float v) { return floorf(v); }
__device__ __forceinline__ double floor_t(double v) { return floor(v); }
__device__ __forceinline__ float sqrt_t(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_t(double v) { return sqrt(v); }

// tap base and weights, core/resample._taps_and_weights
template <typename T, int ORDER>
__device__ __forceinline__ int taps(T c, T* wt) {
  if (ORDER == 0) {
    wt[0] = T(1);
    return static_cast<int>(floor_t(c + T(0.5)));
  }
  if (ORDER == 1) {
    const T k = floor_t(c);
    const T t = c - k;
    wt[0] = T(1) - t;
    wt[1] = t;
    return static_cast<int>(k);
  }
  const T k = floor_t(c + T(0.5));
  const T t = c - k;
  const T hm = T(0.5) - t;
  const T hp = T(0.5) + t;
  wt[0] = T(0.5) * (hm * hm);
  wt[1] = T(0.75) - t * t;
  wt[2] = T(0.5) * (hp * hp);
  return static_cast<int>(k) - 1;
}

// sample at (x, y) in [0, w-1] x [0, h-1] from the mirror-padded canvas of
// row length cw
template <typename T, int ORDER>
__device__ __forceinline__ T sample_padded(const T* __restrict__ canvas,
                                           int cw, int pad, T x, T y) {
  constexpr int kTaps = ORDER + 1;
  T wx[kTaps], wy[kTaps];
  const int kx = taps<T, ORDER>(x, wx) + pad;
  const int ky = taps<T, ORDER>(y, wy) + pad;
  T b = T(0);
#pragma unroll
  for (int iy = 0; iy < kTaps; ++iy) {
    const T* row = canvas + static_cast<size_t>(ky + iy) * cw + kx;
#pragma unroll
    for (int ix = 0; ix < kTaps; ++ix) b = b + (wy[iy] * wx[ix]) * row[ix];
  }
  return b;
}

// block-wide sum of each thread's NS accumulators; thread k < NS writes
// sum k to partial_row[k].  Every thread of the block must call it.
template <int NS, int THREADS>
__device__ __forceinline__ void store_block_sums(const double (&acc)[NS],
                                                 double* __restrict__ partial_row) {
  __shared__ double shared[THREADS / 32][NS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    double v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) shared[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < NS) {
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) s += shared[i][threadIdx.x];
    partial_row[threadIdx.x] = s;
  }
}

// (n_lags, n_blocks, NS) -> (n_lags, NS), blocks summed in index order
template <int NS>
__global__ void reduce_partials(const double* __restrict__ partial,
                                double* __restrict__ out, int n_lags,
                                int n_blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lags * NS) return;
  const int lag = i / NS;
  const int k = i - lag * NS;
  const double* src = partial + static_cast<size_t>(lag) * n_blocks * NS + k;
  double s = 0.0;
  for (int b = 0; b < n_blocks; ++b) s += src[static_cast<size_t>(b) * NS];
  out[i] = s;
}

template <int NS>
cudaError_t launch_reduce(const double* partial, double* out, int n_lags,
                          int n_blocks, int threads, cudaStream_t stream) {
  const int n_out = n_lags * NS;
  reduce_partials<NS><<<(n_out + threads - 1) / threads, threads, 0, stream>>>(
      partial, out, n_lags, n_blocks);
  return cudaGetLastError();
}

}  // namespace eui
