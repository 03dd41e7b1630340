// Fused 5x5 median + low-alpha flow diffusion:
//   out = c * gauss_k(med5(x)) + (1 - c) * med5(x)
//
// Replaces the Pallas kernel median5_diffuse_pallas (_median5_diffuse_impl,
// body _median5_diffuse_kernel) in
// panorama_opticalflow_tpu/ops/pallas/kernels.py: the per-level median
// filter and diffusion of every fused pyramid level.
//
// Contract: x is (2B, H, W) flow planes, c is (B, H, W) and planes 2b and
// 2b+1 share c[b].  The median is cv::medianBlur 5x5 with
// BORDER_REPLICATE; the median field is evaluated on the tile plus the
// blur margin from the edge-replicated input (so at the canvas border the
// blur sees medians of clamped windows, as in the reference kernel), then
// blurred separably, x first, taps in order.
//
// Bound on the H100: arithmetic, not bytes.  Each output reads one input
// value and one coefficient and writes one value (12 bytes), but the
// median costs a 32-input sorting network (240 compare-exchanges) on
// (32 + 14) x (64 + 14) positions per 32 x 64 tile.  Design: one block per
// (tile, plane); the input window and the median field live in shared
// memory (31 KB, so several blocks share an SM), each thread sorts one
// window in registers (a fully unrolled bitonic network; any correct
// selection network gives the exact median), and the blur runs from
// shared memory with the x pass reusing the input window's storage.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int MTH = 32;
constexpr int MTW = 64;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
median5_diffuse_kernel(const float* __restrict__ x, const float* __restrict__ cf,
                       float* __restrict__ out, int h, int w, pano::Taps taps) {
  extern __shared__ float smem[];
  const int gr = taps.n / 2;
  const int xh = MTH + 2 * gr + 4, xw = MTW + 2 * gr + 4;  // input window
  const int mh = MTH + 2 * gr, mw = MTW + 2 * gr;          // median field
  float* xs = smem;             // xh x xw, later the mh x MTW x-pass
  float* med = smem + xh * xw;  // mh x mw

  const int x0 = blockIdx.x * MTW, y0 = blockIdx.y * MTH;
  const int p = blockIdx.z;
  const float* src = x + (size_t)p * h * w;

  for (int k = threadIdx.x; k < xh * xw; k += blockDim.x) {
    const int yy = pano::clampi(y0 - gr - 2 + k / xw, 0, h - 1);
    const int xx = pano::clampi(x0 - gr - 2 + k % xw, 0, w - 1);
    xs[k] = src[(size_t)yy * w + xx];
  }
  __syncthreads();

  for (int k = threadIdx.x; k < mh * mw; k += blockDim.x) {
    const int r = k / mw, q = k % mw;
    med[k] = pano::median5x5(xs + r * xw + q, xw);
  }
  __syncthreads();

  float* accx = xs;  // mh x MTW
  for (int k = threadIdx.x; k < mh * MTW; k += blockDim.x) {
    const int r = k / MTW, q = k % MTW;
    const float* row = med + r * mw + q;
    float acc = 0.f;
    for (int t = 0; t < taps.n; ++t) acc = acc + taps.v[t] * row[t];
    accx[k] = acc;
  }
  __syncthreads();

  const float* coef = cf + (size_t)(p / 2) * h * w;
  float* dst = out + (size_t)p * h * w;
  for (int k = threadIdx.x; k < MTH * MTW; k += blockDim.x) {
    const int yq = k / MTW, xq = k % MTW;
    const int y = y0 + yq, xx = x0 + xq;
    if (y >= h || xx >= w) continue;
    const float* col = accx + yq * MTW + xq;
    float blur = 0.f;
    for (int t = 0; t < taps.n; ++t) blur = blur + taps.v[t] * col[t * MTW];
    const float m = med[(yq + gr) * mw + xq + gr];
    const float cv = coef[(size_t)y * w + xx];
    dst[(size_t)y * w + xx] = cv * blur + (1.f - cv) * m;
  }
}

}  // namespace

extern "C" int pano_median5_diffuse(const float* x, const float* c, float* out,
                                    int planes, int h, int w,
                                    const float* taps_host, int ksize,
                                    void* stream) {
  if (ksize < 1 || ksize > 31 || ksize % 2 == 0 || planes % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const int gr = ksize / 2;
  const size_t smem = (size_t)((MTH + 2 * gr + 4) * (MTW + 2 * gr + 4) +
                               (MTH + 2 * gr) * (MTW + 2 * gr)) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      median5_diffuse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + MTW - 1) / MTW, (h + MTH - 1) / MTH, planes);
  median5_diffuse_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, c, out, h, w, pano::make_taps(taps_host, ksize));
  return (int)cudaGetLastError();
}
