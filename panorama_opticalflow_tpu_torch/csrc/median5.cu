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
// Bound on the H100: arithmetic, not bytes.  An output reads one value
// and writes one (8 bytes), but selecting the 13th of 25 takes about a
// hundred exchanges, each a min and a max that nothing fuses.  (The Pallas
// kernel sorts all 25 with a 32-way network, 240 exchanges, because the
// TPU sorts whole planes at once; that network is not carried over.)
// Design: one block per (32, 128) output tile and plane.  The tile's
// window with its 2-px halo is staged into shared memory by asynchronous
// copies (19 KB, indices clamped at the plane edge), so a thread has all
// its loads in flight at once; the blocks that share a multiprocessor
// cover each other's wait.  A thread owns runs of eight adjacent outputs:
// 16-byte shared loads bring the 5 x 12 values of their windows, each
// column is sorted once, each aligned pair of columns merged once, and
// each median selected from two merged pairs and one column
// (pano::median5_run in common.cuh, the networks of median25_net.inc): 53
// exchanges an output where a window alone takes 101.  The medians leave
// as 16-byte stores where the plane's rows allow it.
#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int MTH = 32;
constexpr int MTW = 128;
constexpr int THREADS = 256;
constexpr int RUNS = MTW / pano::MEDIAN_RUN;  // runs of outputs a tile row
constexpr int XH = MTH + 4, XW = MTW + 4;
static_assert(MTW % pano::MEDIAN_RUN == 0, "whole runs a tile row");

// VEC: every row of the planes starts on a 16-byte boundary
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
median5_kernel(const float* __restrict__ x, float* __restrict__ out, int h,
               int w) {
  __shared__ __align__(16) float xs[XH * XW];
  const int x0 = blockIdx.x * MTW, y0 = blockIdx.y * MTH;
  const size_t plane = (size_t)blockIdx.z * h * w;
  const int th = min(MTH, h - y0);

  pano::stage_clamped_async<XW>(xs, x + plane, h, w, y0 - 2, x0 - 2, th + 4);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  float* dst = out + plane;
  for (int k = threadIdx.x; k < th * RUNS; k += blockDim.x) {
    const int yq = k / RUNS, xq = k % RUNS * pano::MEDIAN_RUN;
    const int xx = x0 + xq;
    if (xx >= w) continue;
    float m[pano::MEDIAN_RUN];
    pano::median5_run(xs + yq * XW + xq, XW, m);
    float* o = dst + (size_t)(y0 + yq) * w + xx;
    if (VEC) {
#pragma unroll
      for (int i = 0; i < pano::MEDIAN_RUN; i += 4)
        if (xx + i < w)
          *reinterpret_cast<float4*>(o + i) =
              make_float4(m[i], m[i + 1], m[i + 2], m[i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < pano::MEDIAN_RUN; ++i)
        if (xx + i < w) o[i] = m[i];
    }
  }
}

}  // namespace

extern "C" int pano_median5(const float* x, float* out, int planes, int h,
                            int w, void* stream) {
  if (planes < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((w + MTW - 1) / MTW, (h + MTH - 1) / MTH, planes);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto kernel = vec ? median5_kernel<true> : median5_kernel<false>;
  kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, out, h, w);
  return (int)cudaGetLastError();
}
