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
// separable 17-tap hat passes: x over the 81 window rows (each row with its
// own residual, edge-extended by rows beyond the tile), then y.  Taps are
// summed from -8 to 8.
//
// Bound on the H100: device-memory bytes (image and flow read once, the
// output written once: 24 bytes an output pixel at two channels against a
// few dozen operations).  The reference sums all 17 taps of a pass because
// a TPU cannot gather; a hat weight max(0, 1 - |r - t|) is an exact zero at
// every tap but floor(r) and floor(r) + 1, and a data-dependent read from
// shared memory costs what a fixed one does.  Design:
//   * two-tap gather: an output takes its two y taps and, at each of those
//     window rows, that row's own clamped x residual with its two x taps:
//     four window reads instead of 34, no x-pass buffer, one barrier.  The
//     x sums are formed first, taps ascending from 0, then the y sum, so
//     the result has the bits of the dense sums (the skipped products are
//     exact zeros);
//   * both channels in one block: at two channels the interleaved image
//     and output move as float2, so no half of a sector is thrown away,
//     and the flow is read by one block, not one a channel (its y
//     component for the pixel, its x component at the two tap rows, which
//     the neighbouring rows' reads keep in L1).  Other channel counts, or
//     pointers off an 8-byte boundary, take the same kernel one channel a
//     block;
//   * a block of 512 threads covers 32 of the tile's 64 rows: its 48 x 144
//     float2 window is 54 KB of dynamic shared memory, so four blocks fill
//     an SM's 64 warps and their loads overlap each other's arithmetic
//     (256 threads a block took a fifth longer, a 64-row block as long).
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TH = 64;
constexpr int TW = 128;
constexpr int MARGIN = 8;
constexpr int SUB = 32;  // output rows of one block
// the clamp keeps floor(r) in [-MARGIN, MARGIN - 1], so the taps of a block
// stay inside SUB + 2 * MARGIN window rows and TW + 2 * MARGIN columns
constexpr int BH = SUB + 2 * MARGIN;
constexpr int BW = TW + 2 * MARGIN;
constexpr int THREADS = 512;

template <int NC>
struct Px;
template <>
struct Px<1> {
  using type = float;
};
template <>
struct Px<2> {
  using type = float2;
};

// NC channels a block, starting at channel (blockIdx.z % groups) * NC
template <int NC>
__global__ void __launch_bounds__(THREADS)
warp_tiled_kernel(const float* __restrict__ img, const float* __restrict__ flow,
                  const int* __restrict__ off, float* __restrict__ out, int c,
                  int h, int w, int ty, int tx, float lim) {
  using V = typename Px<NC>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* win = reinterpret_cast<V*>(smem_raw);  // BH x BW image window

  constexpr int SUBS = TH / SUB;
  const int groups = c / NC;
  const int j = blockIdx.x, i = blockIdx.y / SUBS;
  const int tq0 = (blockIdx.y % SUBS) * SUB;  // first tile row of the block
  if (i * TH + tq0 >= h) return;  // the ragged last tile's empty half
  const int b = blockIdx.z / groups, ch = (blockIdx.z % groups) * NC;
  const int* o = off + ((b * ty + i) * tx + j) * 2;
  const int ox = o[0], oy = o[1];
  const float* src = img + (size_t)b * h * w * c + ch;
  const float* fl = flow + (size_t)b * h * w * 2;
  float* dst = out + (size_t)b * h * w * c + ch;
  const int wy0 = i * TH + tq0 + oy - MARGIN, wx0 = j * TW + ox - MARGIN;

  // the window at the tile offset, indices clamped to the image (the
  // reference's double edge padding)
  for (int k = threadIdx.x; k < BH * BW; k += THREADS) {
    const int yy = pano::clampi(wy0 + k / BW, 0, h - 1);
    const int xx = pano::clampi(wx0 + k % BW, 0, w - 1);
    win[k] = *reinterpret_cast<const V*>(src + ((size_t)yy * w + xx) * c);
  }
  __syncthreads();

  for (int k = threadIdx.x; k < SUB * TW; k += THREADS) {
    const int yq = k / TW, xq = k % TW;
    const int y = i * TH + tq0 + yq, x = j * TW + xq;
    if (y >= h || x >= w) continue;
    const float ry = pano::clampf(
        fl[((size_t)y * w + x) * 2 + 1] - (float)oy, -lim, lim);
    const float fy = floorf(ry);
    const int jy = (int)fy;
    V xs[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      // the x residual of this window row: the tile's rows, edge-extended
      const int tr = pano::clampi(tq0 + yq + jy + t, 0, TH - 1);
      const int gy = min(i * TH + tr, h - 1);
      const float rx = pano::clampf(
          fl[((size_t)gy * w + x) * 2] - (float)ox, -lim, lim);
      const float fx = floorf(rx);
      const V* p = win + (yq + MARGIN + jy + t) * BW + xq + MARGIN + (int)fx;
      xs[t] = pano::tap2(pano::hat(rx - fx), p[0],
                         pano::hat(rx - (fx + 1.f)), p[1]);
    }
    *reinterpret_cast<V*>(dst + ((size_t)y * w + x) * c) = pano::tap2(
        pano::hat(ry - fy), xs[0], pano::hat(ry - (fy + 1.f)), xs[1]);
  }
}

template <int NC>
int launch(const float* img, const float* flow, const int* off, float* out,
           int nb, int c, int h, int w, float lim, cudaStream_t stream) {
  constexpr size_t smem = (size_t)BH * BW * NC * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      warp_tiled_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  // four blocks an SM need the largest shared-memory carve-out
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(warp_tiled_kernel<NC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int ty = (h + TH - 1) / TH, tx = (w + TW - 1) / TW;
  dim3 grid(tx, ty * (TH / SUB), nb * (c / NC));
  warp_tiled_kernel<NC><<<grid, THREADS, smem, stream>>>(
      img, flow, off, out, c, h, w, ty, tx, lim);
  return (int)cudaGetLastError();
}

bool aligned8(const void* p) { return (uintptr_t)p % 8 == 0; }

}  // namespace

extern "C" int pano_warp_tiled(const float* img, const float* flow,
                               const int* off, float* out, int nb, int c,
                               int h, int w, int tile_h, int tile_w,
                               int margin, float lim, void* stream) {
  if (tile_h != TH || tile_w != TW || margin != MARGIN || c < 1 ||
      !(lim < (float)MARGIN))
    return (int)cudaErrorInvalidValue;
  if (c == 2 && aligned8(img) && aligned8(out))
    return launch<2>(img, flow, off, out, nb, c, h, w, lim,
                     (cudaStream_t)stream);
  return launch<1>(img, flow, off, out, nb, c, h, w, lim,
                   (cudaStream_t)stream);
}
