// Flow-guided warp W(x) = img(x + flow(x)), bilinear, clamp-to-edge.
//
// Replaces the Pallas kernel warp_tiled_pallas / _warp_tiled_impl in
// panorama_opticalflow_tpu/ops/pallas/kernels.py (the per-phase gradient
// recentring of every fast pyramid level).
//
// Contract (= ops.relax_fast.warp_by_flow_tiled): per (64, 128) tile the
// integer offset (ox, oy) = clip(rint(mean flow), +-96) is computed by the
// wrapper with torch ops, as the reference does outside its kernel.  The
// residual flow - offset, clamped to +-(8 - 1e-3), is applied as two
// separable 17-tap hat passes: x over the 81 window rows (residual
// edge-extended by rows), then y.  Taps are summed from -8 to 8.
//
// Bound on the H100: device-memory bytes.  Each output value costs two
// flow reads and one image read plus a 17x17 window amortised over the
// tile; the arithmetic (2 x 17 multiply-adds per output) is far below the
// FLOP roofline.  Design: one block per (tile, plane); the tile's window,
// fetched once at the tile offset with clamped indices (the reference's
// double edge padding), lives in shared memory with the x-pass result
// (88 KB of dynamic shared memory), so every image value is read from
// device memory about once.  Images and flows stay in their (B, H, W, C)
// interleaved layout, so no transpose round trip is needed.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TH = 64;
constexpr int TW = 128;
constexpr int MARGIN = 8;
constexpr int BH = TH + 2 * MARGIN + 1;
constexpr int BW = TW + 2 * MARGIN + 1;
constexpr int THREADS = 256;
constexpr size_t SMEM = (size_t)(BH * BW + BH * TW) * sizeof(float);

__global__ void __launch_bounds__(THREADS)
warp_tiled_kernel(const float* __restrict__ img, const float* __restrict__ flow,
                  const int* __restrict__ off, float* __restrict__ out,
                  int c, int h, int w, int ty, int tx, float lim) {
  extern __shared__ float smem[];
  float* win = smem;             // BH x BW image window
  float* accx = smem + BH * BW;  // BH x TW x-pass result

  const int j = blockIdx.x, i = blockIdx.y;
  const int b = blockIdx.z / c, ch = blockIdx.z % c;
  const int* o = off + ((b * ty + i) * tx + j) * 2;
  const int ox = o[0], oy = o[1];
  const float* src = img + (size_t)b * h * w * c;
  const float* fl = flow + (size_t)b * h * w * 2;
  const int wy0 = i * TH + oy - MARGIN, wx0 = j * TW + ox - MARGIN;

  for (int k = threadIdx.x; k < BH * BW; k += blockDim.x) {
    const int yy = pano::clampi(wy0 + k / BW, 0, h - 1);
    const int xx = pano::clampi(wx0 + k % BW, 0, w - 1);
    win[k] = src[((size_t)yy * w + xx) * c + ch];
  }
  __syncthreads();

  for (int k = threadIdx.x; k < BH * TW; k += blockDim.x) {
    const int r = k / TW, xq = k % TW;
    // residual rows are edge-extended over the window rows
    const int gy = min(i * TH + pano::clampi(r - MARGIN, 0, TH - 1), h - 1);
    const int gx = min(j * TW + xq, w - 1);
    const float rx =
        pano::clampf(fl[((size_t)gy * w + gx) * 2] - (float)ox, -lim, lim);
    const float* row = win + r * BW + xq + MARGIN;
    float acc = 0.f;
#pragma unroll
    for (int t = -MARGIN; t <= MARGIN; ++t)
      acc = acc + pano::hat(rx - (float)t) * row[t];
    accx[k] = acc;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < TH * TW; k += blockDim.x) {
    const int yq = k / TW, xq = k % TW;
    const int y = i * TH + yq, x = j * TW + xq;
    const int gy = min(y, h - 1), gx = min(x, w - 1);
    const float ry =
        pano::clampf(fl[((size_t)gy * w + gx) * 2 + 1] - (float)oy, -lim, lim);
    const float* col = accx + (yq + MARGIN) * TW + xq;
    float acc = 0.f;
#pragma unroll
    for (int t = -MARGIN; t <= MARGIN; ++t)
      acc = acc + pano::hat(ry - (float)t) * col[t * TW];
    if (y < h && x < w) out[((size_t)(b * h + y) * w + x) * c + ch] = acc;
  }
}

}  // namespace

extern "C" int pano_warp_tiled(const float* img, const float* flow,
                               const int* off, float* out, int nb, int c,
                               int h, int w, int tile_h, int tile_w,
                               int margin, float lim, void* stream) {
  if (tile_h != TH || tile_w != TW || margin != MARGIN)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      warp_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const int ty = (h + TH - 1) / TH, tx = (w + TW - 1) / TW;
  dim3 grid(tx, ty, nb * c);
  warp_tiled_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      img, flow, off, out, c, h, w, ty, tx, lim);
  return (int)cudaGetLastError();
}
