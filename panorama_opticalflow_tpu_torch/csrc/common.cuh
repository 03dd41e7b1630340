// Helpers shared by the pixflow kernels.
//
// Every kernel here is built with -fmad=false: the plain PyTorch versions
// run one eager op per multiply and per add, so keeping each product and
// each sum separately rounded (and the reference's summation order) makes
// a kernel agree with its plain version to the last bit on most pixels.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace pano {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// np.pad's 'reflect' (reflect-101) source index of i in [0, n), n >= 2:
// folded until it lies inside, which also covers pads wider than the plane
__device__ __forceinline__ int reflect101(int i, int n) {
  while (i < 0 || i >= n) i = i < 0 ? -i : 2 * (n - 1) - i;
  return i;
}

// max(0, 1 - |t|): the bilinear hat weight
__device__ __forceinline__ float hat(float t) {
  return fmaxf(0.f, 1.f - fabsf(t));
}

__device__ __forceinline__ float sgn(float t) {
  return (float)((t > 0.f) - (t < 0.f));
}

// d/dt hat(t): -sign(t) inside the support
__device__ __forceinline__ float dhat(float t) {
  return fabsf(t) < 1.f ? -sgn(t) : 0.f;
}

// A hat pass with its exact-zero taps left out: max(0, 1 - |d - t|) is not
// zero at t = floor(d) and floor(d) + 1 only, so 0 + w0 * v0 + w1 * v1 with
// every product and sum rounded on its own has the bits of the dense sum
// over all taps in ascending order.  dhat is zero at the same taps.
__device__ __forceinline__ float tap2(float w0, float v0, float w1, float v1) {
  return (0.f + w0 * v0) + w1 * v1;
}

__device__ __forceinline__ float2 tap2(float w0, float2 v0, float w1,
                                       float2 v1) {
  return make_float2(tap2(w0, v0.x, w1, v1.x), tap2(w0, v0.y, w1, v1.y));
}

__device__ __forceinline__ void cswap(float& a, float& b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

// The 5x5 median (13th smallest of 25) by exchanges on registers.  The
// TPU kernel sorts all 25 values with a 32-way network because it sorts
// whole planes at once; a thread here needs only the median, and
// neighbouring windows hold the same columns.  So a thread owns MEDIAN_RUN
// horizontally adjacent outputs and shares the work between their
// windows: it sorts each of the MEDIAN_RUN + 4 columns once, merges each
// aligned pair of adjacent columns once into a sorted ten, and selects each
// median from the two merged pairs and the one single column that make up
// its window.  The three networks are in median25_net.inc.  Any exact
// selection returns the same bits: a median only picks one of its inputs.
// Every index is static after unrolling, so the values stay in registers,
// and the compiler drops the half of an exchange whose result is not read.
// What bounds it: min and max run at half the rate of a float32 add on
// this card, and nothing fuses them.
constexpr int MEDIAN_RUN = 8;

__device__ __forceinline__ void sort_column(float (&v)[5]) {
#define PANO_COLSWAP(i, j) cswap(v[i], v[j]);
#include "median25_net.inc"
}

// two sorted columns into one ascending run of ten
__device__ __forceinline__ void merge_pair(const float (&a)[5],
                                           const float (&b)[5],
                                           float (&v)[10]) {
#pragma unroll
  for (int r = 0; r < 5; ++r) v[r] = a[r], v[5 + r] = b[r];
#define PANO_PAIRSWAP(i, j) cswap(v[i], v[j]);
#include "median25_net.inc"
}

// median of the window made of two merged pairs and one sorted column
__device__ __forceinline__ float median_of_parts(const float (&p)[10],
                                                 const float (&q)[10],
                                                 const float (&c)[5]) {
  float v[25], m;
#pragma unroll
  for (int r = 0; r < 10; ++r) v[r] = p[r], v[10 + r] = q[r];
#pragma unroll
  for (int r = 0; r < 5; ++r) v[20 + r] = c[r];
#define PANO_CSWAP(i, j) cswap(v[i], v[j]);
#define PANO_MEDIAN_AT(w) m = v[w];
#include "median25_net.inc"
  return m;
}

// Medians of the MEDIAN_RUN horizontally adjacent 5x5 windows whose first
// top-left corner is at src (shared memory, 16-byte aligned, row stride ld
// a multiple of 4), to out[0 .. MEDIAN_RUN): 16-byte loads bring the
// 5 x (MEDIAN_RUN + 4) values.  Window m spans columns m .. m + 4; the
// pairs are columns (0, 1), (2, 3), ...: an even window is two pairs and
// its last column, an odd one its first column and two pairs.
__device__ __forceinline__ void median5_run(const float* src, int ld,
                                            float (&out)[MEDIAN_RUN]) {
  constexpr int NC = MEDIAN_RUN + 4;
  static_assert(MEDIAN_RUN % 4 == 0, "whole float4 loads, whole pairs");
  float cols[NC][5];
#pragma unroll
  for (int r = 0; r < 5; ++r)
#pragma unroll
    for (int c = 0; c < NC; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(src + r * ld + c);
      cols[c][r] = a.x, cols[c + 1][r] = a.y, cols[c + 2][r] = a.z,
      cols[c + 3][r] = a.w;
    }
#pragma unroll
  for (int c = 0; c < NC; ++c) sort_column(cols[c]);
  float pairs[NC / 2][10];
#pragma unroll
  for (int k = 0; k < NC / 2; ++k)
    merge_pair(cols[2 * k], cols[2 * k + 1], pairs[k]);
#pragma unroll
  for (int m = 0; m < MEDIAN_RUN; ++m) {
    const int k = (m + 1) / 2;  // the window's first whole pair
    out[m] = median_of_parts(pairs[k], pairs[k + 1],
                             cols[m % 2 ? m : m + 4]);
  }
}

// Starts the copy of rows x cols values of the plane src (h x w) into
// shared memory (row stride cols), from the window whose corner is at
// (y_first, x_first): the edge-replicated input, indices clamped to the
// plane where the window reaches beyond it.  The copies are asynchronous
// (no register in between), so a thread has all of its loads in flight at
// once; lanes run along a row.  The caller commits (__pipeline_commit),
// waits (__pipeline_wait_prior) and synchronises.
__device__ __forceinline__ void stage_clamped_async(float* dst,
                                                    const float* src, int h,
                                                    int w, int y_first,
                                                    int x_first, int rows,
                                                    int cols) {
  const int n = rows * cols;
  if (y_first >= 0 && y_first + rows <= h && x_first >= 0 &&
      x_first + cols <= w) {  // a window inside the plane: nothing to clamp
    const float* corner = src + (size_t)y_first * w + x_first;
    for (int k = threadIdx.x; k < n; k += blockDim.x)
      __pipeline_memcpy_async(dst + k, corner + (k / cols) * w + k % cols,
                              sizeof(float));
    return;
  }
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int yy = clampi(y_first + k / cols, 0, h - 1);
    const int xx = clampi(x_first + k % cols, 0, w - 1);
    __pipeline_memcpy_async(dst + k, src + (size_t)yy * w + xx, sizeof(float));
  }
}

// the same with a row stride known at compile time
template <int COLS>
__device__ __forceinline__ void stage_clamped_async(float* dst,
                                                    const float* src, int h,
                                                    int w, int y_first,
                                                    int x_first, int rows) {
  stage_clamped_async(dst, src, h, w, y_first, x_first, rows, COLS);
}

// 1-D Gaussian taps passed by value (kernel parameter space); a loop
// unrolled over a static tap count reads them as constant operands.  At
// most MAX_TAPS taps: more than any blur whose window fits a block's
// shared memory.
constexpr int MAX_TAPS = 80;

struct Taps {
  float v[MAX_TAPS];
  int n;
};

inline Taps make_taps(const float* host, int n) {
  Taps t{};
  for (int i = 0; i < n && i < MAX_TAPS; ++i) t.v[i] = host[i];
  t.n = n;
  return t;
}

}  // namespace pano
