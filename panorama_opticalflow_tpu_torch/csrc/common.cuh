// Helpers shared by the pixflow kernels.
//
// Every kernel here is built with -fmad=false: the plain PyTorch versions
// run one eager op per multiply and per add, so keeping each product and
// each sum separately rounded (and the reference's summation order) makes
// a kernel agree with its plain version to the last bit on most pixels.
#pragma once

#include <cuda_runtime.h>

namespace pano {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
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

// 13th smallest of v[0..24] (the 5x5 median): a fully unrolled 32-way
// bitonic sort in registers, v[25..31] padded with +inf by the caller.
// Any correct selection network gives the exact median.
__device__ __forceinline__ float median25(float (&v)[32]) {
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
#pragma unroll
    for (int j = k; j >= 1; j >>= 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int ixj = i ^ j;
        if (ixj > i) {
          if ((i & (k << 1)) == 0)
            cswap(v[i], v[ixj]);
          else
            cswap(v[ixj], v[i]);
        }
      }
    }
  }
  return v[12];
}

// median of the 5x5 window whose top-left corner is at src (row stride ld)
__device__ __forceinline__ float median5x5(const float* src, int ld) {
  float v[32];
#pragma unroll
  for (int dy = 0; dy < 5; ++dy)
#pragma unroll
    for (int dx = 0; dx < 5; ++dx) v[dy * 5 + dx] = src[dy * ld + dx];
#pragma unroll
  for (int t = 25; t < 32; ++t) v[t] = __int_as_float(0x7f800000);
  return median25(v);
}

// 1-D Gaussian taps passed by value (kernel parameter space)
struct Taps {
  float v[32];
  int n;
};

inline Taps make_taps(const float* host, int n) {
  Taps t{};
  for (int i = 0; i < n && i < 32; ++i) t.v[i] = host[i];
  t.n = n;
  return t;
}

}  // namespace pano
