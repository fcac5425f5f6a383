// Device code shared by the port's kernels (warp_score.cu, quad_score.cu).
//
// * taps / sample_padded: order-0/1/2 B-spline sampling with the tap base
//   and weights of core/resample._taps_and_weights, gathered from a canvas
//   that holds the image mirror-padded by `pad` px (mirror taps at the edge,
//   as core/resample.sample_image does; the caller passes in-range
//   coordinates).  The taps are summed in sample_image's order (rows outer,
//   columns inner, from zero).
// * inside_image / add_pearson: the range test and the Pearson scoring of
//   one pixel-lag, branch-free: a pixel-lag outside the image samples
//   (0, 0) and its sums are predicated off.
// * lag_tile_loop: the skeleton of both kernels.  A block of
//   kTileX x kTileY = 32 x 8 threads owns the LT consecutive lags of lag
//   tile blockIdx.x and the pixel tiles g, g + G, g + 2G, ... of the grid
//   (g = blockIdx.y of G = gridDim.y groups; a pixel tile is 8 rows x 32
//   columns, so a warp is one row segment and its tap gathers stay within
//   a few cache lines).  Per pixel a thread loads the lag-independent
//   operands once (`pixel`), maps the pixel through its LT lags (`coords`),
//   and scores them (`score`), keeping LT counts and LT x (NS - 1) float64
//   sums in registers.  The lag bodies have no branch, so the compiler
//   interleaves the tile's lags; a warp none of whose pixels lands inside
//   the image for any of the lags skips the scoring.  The lag tile is the
//   fastest grid index, so the blocks resident at one time walk the same
//   pixel tiles for different lags, and the lag-independent operands come
//   from L2.  The host bounds G (engine/warp_score.launch_geometry, from
//   the tiles each library reports), which bounds the grid and the partial
//   buffer at any lag count.
// * load_lag_rows: a lag tile's table rows into shared memory.  The rows
//   past the last lag repeat the last lag (the ragged last tile computes
//   them and stores nothing for them).
// * store_lag_sums / reduce_partials: the deterministic two-stage float64
//   reduction, with no atomics.  Each block reduces its threads' sums with
//   warp shuffles and shared memory (warps in index order) and writes, for
//   each of its lags, one row of an (n_lags, G, NS) scratch buffer;
//   reduce_partials sums the G rows of each lag in index order into
//   (n_lags, NS).  Two launches give bit-identical sums.
//
// Header-only.  engine/_build.py hashes every csrc/*.cuh into each library's
// build key, so a change here rebuilds both kernels.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace eui {

constexpr int kTileX = 32;  // pixel tile columns: a warp
constexpr int kTileY = 8;   // pixel tile rows: the warps of a block
constexpr int kThreads = kTileX * kTileY;
// resident blocks per SM to reserve registers for (__launch_bounds__):
// three cap a thread at 80 registers; K2 ran fastest with three of two to
// four, K1 as fast as with four (PERF.md)
constexpr int kMinBlocks = 3;

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
    for (int ix = 0; ix < kTaps; ++ix) b = b + (wy[iy] * wx[ix]) * __ldg(row + ix);
  }
  return b;
}

__device__ __forceinline__ int thread_index() {
  return threadIdx.y * kTileX + threadIdx.x;
}

// rows[l] = table row of lag min(blockIdx.x * LT + l, n_lags - 1); every
// thread of the block must call it (it synchronises)
template <typename T, int LT, int K>
__device__ __forceinline__ void load_lag_rows(const T* __restrict__ table,
                                              int n_lags, T (&rows)[LT][K]) {
  static_assert(LT * K <= kThreads, "one thread per table entry");
  const int tid = thread_index();
  if (tid < LT * K) {
    const int l = tid / K;
    const int lag = min(static_cast<int>(blockIdx.x) * LT + l, n_lags - 1);
    rows[l][tid - l * K] = table[static_cast<size_t>(lag) * K + (tid - l * K)];
  }
  __syncthreads();
}

// block-wide sums of each thread's counts and sums; for lag l of the tile
// (if it exists) writes [count, sums...] to partial row (lag, blockIdx.y).
// Every thread of the block must call it.
template <int LT, int NS>
__device__ __forceinline__ void store_lag_sums(const int (&cnt)[LT],
                                               const double (&acc)[LT][NS - 1],
                                               int n_lags,
                                               double* __restrict__ partial) {
  __shared__ double shared[kTileY][LT * NS];
  const int tid = thread_index();
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int l = 0; l < LT; ++l) {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      double v = k == 0 ? static_cast<double>(cnt[l]) : acc[l][k - 1];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) shared[warp][l * NS + k] = v;
    }
  }
  __syncthreads();
  if (tid < LT * NS) {
    const int l = tid / NS;
    const int lag = static_cast<int>(blockIdx.x) * LT + l;
    if (lag < n_lags) {
      double s = 0.0;
#pragma unroll
      for (int i = 0; i < kTileY; ++i) s += shared[i][tid];
      partial[(static_cast<size_t>(lag) * gridDim.y + blockIdx.y) * NS +
              (tid - l * NS)] = s;
    }
  }
}

// NaN fails every comparison, so NaN coordinates are outside too
template <typename T>
__device__ __forceinline__ bool inside_image(T x, T y, T xmax, T ymax) {
  return (x >= T(0)) & (x <= xmax) & (y >= T(0)) & (y <= ymax);
}

// Samples at (x, y) if `inside`, else at (0, 0), and adds to one lag's
// Pearson count and sums [Sa, Saa, Sb, Sbb, Sab] where inside and the
// sample is finite.  No branch (the sums are predicated), so the compiler
// interleaves a tile's lags.
template <typename T, int ORDER>
__device__ __forceinline__ void add_pearson(const T* __restrict__ canvas,
                                            int cw, int pad, T x, T y,
                                            bool inside, double ad, double aa,
                                            int& n, double (&s)[5]) {
  const T b = sample_padded<T, ORDER>(canvas, cw, pad, inside ? x : T(0),
                                      inside ? y : T(0));
  if (inside & isfinite(b)) {  // predicated, no branch
    const double bd = static_cast<double>(b);
    ++n;
    s[0] += ad;
    s[1] += aa;
    s[2] += bd;
    s[3] = fma(bd, bd, s[3]);
    s[4] = fma(ad, bd, s[4]);
  }
}

// The skeleton (see the header note).  `pixel(i, j, px)` loads pixel
// (i, j)'s lag-independent operands into px and returns false where the
// pixel scores for no lag; `coords(px, l, x, y)` maps it through lag l of
// the tile and returns whether (x, y) lies inside the image; `score(px, l,
// x, y, inside, cnt, sums)` samples there and adds to lag l's count and
// sums (zeros where not inside).  A warp none of whose pixels lands inside
// the image for any lag of the tile skips the sampling (one vote), so lags
// shifted far off the grid cost only their coordinates.
template <int LT, int NS, typename T, typename Px, typename PixelFn,
          typename CoordFn, typename ScoreFn>
__device__ __forceinline__ void lag_tile_loop(int h, int w, int n_lags,
                                              PixelFn&& pixel,
                                              CoordFn&& coords,
                                              ScoreFn&& score,
                                              double* __restrict__ partial) {
  const int tiles_x = (w + kTileX - 1) / kTileX;
  const int n_tiles = tiles_x * ((h + kTileY - 1) / kTileY);
  int cnt[LT];
  double acc[LT][NS - 1];
#pragma unroll
  for (int l = 0; l < LT; ++l) {
    cnt[l] = 0;
#pragma unroll
    for (int k = 0; k < NS - 1; ++k) acc[l][k] = 0.0;
  }
  for (int t = blockIdx.y; t < n_tiles; t += gridDim.y) {
    const int tr = t / tiles_x;
    const int i = tr * kTileY + static_cast<int>(threadIdx.y);
    const int j = (t - tr * tiles_x) * kTileX + static_cast<int>(threadIdx.x);
    Px px{};  // zeros: coords runs on every pixel, valid or not
    const bool valid = i < h && j < w && pixel(i, j, px);
    T x[LT], y[LT];
    bool inside[LT];
    bool any = false;
#pragma unroll
    for (int l = 0; l < LT; ++l) {
      inside[l] = valid & coords(px, l, x[l], y[l]);
      any |= inside[l];
    }
    if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
    for (int l = 0; l < LT; ++l)
      score(px, l, x[l], y[l], inside[l], cnt[l], acc[l]);
  }
  store_lag_sums<LT, NS>(cnt, acc, n_lags, partial);
}

// (n_lags, n_groups, NS) -> (n_lags, NS), groups summed in index order
template <int NS>
__global__ void reduce_partials(const double* __restrict__ partial,
                                double* __restrict__ out, int n_lags,
                                int n_groups) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lags * NS) return;
  const int lag = i / NS;
  const int k = i - lag * NS;
  const double* src = partial + static_cast<size_t>(lag) * n_groups * NS + k;
  double s = 0.0;
  for (int g = 0; g < n_groups; ++g) s += src[static_cast<size_t>(g) * NS];
  out[i] = s;
}

// the main kernel's grid, then the reduction, on `stream`
template <int NS>
cudaError_t launch_reduce(const double* partial, double* out, int n_lags,
                          int n_groups, cudaStream_t stream) {
  const int n_out = n_lags * NS;
  reduce_partials<NS><<<(n_out + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(partial, out, n_lags, n_groups);
  return cudaGetLastError();
}

// checks shared by the two kernels' C entry points
inline bool valid_launch(int h, int w, int pad, int n_lags, int n_groups) {
  return h >= 1 && w >= 1 && pad >= 1 && n_lags >= 1 && n_lags <= 65535 &&
         n_groups >= 1 && n_groups <= 65535;
}

template <int LT>
dim3 lag_tile_grid(int n_lags, int n_groups) {
  return dim3((n_lags + LT - 1) / LT, n_groups);
}

// the launch geometry a library reports to the host: lags per block, pixel
// tile rows, pixel tile columns
template <int LT>
void report_tiles(int* out) {
  out[0] = LT;
  out[1] = kTileY;
  out[2] = kTileX;
}

}  // namespace eui
