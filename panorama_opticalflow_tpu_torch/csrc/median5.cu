// 5x5 median filter, cv::medianBlur with BORDER_REPLICATE, on (P, H, W)
// float32 planes.
//
// Replaces the Pallas kernel median5_pallas (_median5_impl, body
// _median5_kernel) in panorama_opticalflow_tpu/ops/pallas/kernels.py: the
// per-phase median of multi-phase pyramid levels (relax_phases > 1) and of
// levels with fuse_level_blurs=False.
//
// Contract (= ops.image.median5, bit for bit: a median only selects one of
// its inputs): out[p, y, x] is the 13th smallest of the 25 values
// x[p, clamp(y + dy), clamp(x + dx)], dy, dx in [-2, 2].
//
// Bound on the H100: arithmetic.  Each output reads one value and writes
// one (8 bytes), but selects from 25 with a 32-input sorting network (240
// compare-exchanges).  Design: one block per (32, 128) output tile and
// plane; the tile's window plus a 2-px halo is read once into shared
// memory (19 KB) with clamped indices at the plane edge, and each thread
// sorts one window at a time in registers.  The Pallas kernel's (8, 128)
// alignment slack has no counterpart here.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int MTH = 32;
constexpr int MTW = 128;
constexpr int THREADS = 256;
constexpr int XH = MTH + 4, XW = MTW + 4;

__global__ void __launch_bounds__(THREADS)
median5_kernel(const float* __restrict__ x, float* __restrict__ out, int h,
               int w) {
  __shared__ float xs[XH * XW];
  const int x0 = blockIdx.x * MTW, y0 = blockIdx.y * MTH;
  const size_t plane = (size_t)blockIdx.z * h * w;
  const float* src = x + plane;

  for (int k = threadIdx.x; k < XH * XW; k += blockDim.x) {
    const int yy = pano::clampi(y0 - 2 + k / XW, 0, h - 1);
    const int xx = pano::clampi(x0 - 2 + k % XW, 0, w - 1);
    xs[k] = src[(size_t)yy * w + xx];
  }
  __syncthreads();

  float* dst = out + plane;
  for (int k = threadIdx.x; k < MTH * MTW; k += blockDim.x) {
    const int yq = k / MTW, xq = k % MTW;
    const int y = y0 + yq, xx = x0 + xq;
    if (y >= h || xx >= w) continue;
    dst[(size_t)y * w + xx] = pano::median5x5(xs + yq * XW + xq, XW);
  }
}

}  // namespace

extern "C" int pano_median5(const float* x, float* out, int planes, int h,
                            int w, void* stream) {
  if (planes < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((w + MTW - 1) / MTW, (h + MTH - 1) / MTH, planes);
  median5_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, out, h, w);
  return (int)cudaGetLastError();
}
