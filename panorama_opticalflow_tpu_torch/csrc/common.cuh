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
