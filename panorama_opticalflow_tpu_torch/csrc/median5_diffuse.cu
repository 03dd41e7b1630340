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
// Bound on the H100: arithmetic, not bytes.  An output reads one input
// value and one coefficient and writes one value (12 bytes), but its
// median takes about a hundred exchanges (a min and a max each, nothing
// fuses) and the median field is also needed on the blur margin around a
// tile.  (The Pallas kernel sorts all 25 values with a 32-way network, 240
// exchanges, because the TPU sorts whole planes; that is not carried over.)
// Design: one block per (64, 128) output tile and plane, so the margin's
// medians cost 1.35x the tile's (a (32, 64) tile: 1.75x).  The input
// window is staged into shared memory by asynchronous copies, so a thread
// has all its loads in flight at once; window and median field take 93 KB
// at 15 taps, and the two blocks that share a multiprocessor cover each
// other's wait.  A thread owns runs of adjacent positions in each of the
// three passes: the medians in runs of eight that share sorted columns and
// merged column pairs (pano::median5_run in common.cuh, the networks of
// median25_net.inc: 53 exchanges a median where a window alone takes
// 101), the x blur reads its 4 + 14 medians with 16-byte loads, the y blur
// and the blend write 16 bytes.  The tap count is a template parameter, so
// both blurs unroll and read the taps as constant operands; the sums keep
// the plain version's order (x first, taps ascending, every product and
// sum rounded alone).  The x pass reuses the input window's storage.  A
// tile at the plane's lower or right edge computes only the rows and runs
// it needs.
//
// The small levels (below pallas_min_pixels) blur with the image's own
// borders instead: median5_diffuse_small_kernel is bit for bit im.median5
// then the plain low-alpha diffusion (ops.kernels.
// small_median5_diffuse_plain), with no JAX counterpart.  The median field
// is the same (edge-replicated windows); the blur reads it at reflect-101
// coordinates of the plane, the y pass first (ops.image.gaussian_blur), and
// out = c * blur + (1 - c) * med with c = 1 - a0 * a1 given.  A reflected
// coordinate of a tile's pixel lies inside the tile's median field, so the
// block computes the same field; its passes are scalar (a small level is
// a few blocks, bound by their latency).
#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int MTH = 64;
constexpr int MTW = 128;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 2;         // by shared memory
constexpr int MRUN = pano::MEDIAN_RUN;  // medians a thread and step
constexpr int RUN = 4;                   // blur outputs a thread and step

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// shared-memory geometry for a blur of ks taps (radius ks / 2)
struct Geo {
  int gr, mh, mld, xh, xld;
  __host__ __device__ constexpr explicit Geo(int ks)
      : gr(ks / 2),
        mh(MTH + 2 * (ks / 2)),                      // median field rows
        mld(round_up(MTW + 2 * (ks / 2), MRUN)),     // its row stride
        xh(MTH + 2 * (ks / 2) + 4),                  // input window
        xld(round_up(MTW + 2 * (ks / 2), MRUN) + 4) {}
  __host__ __device__ constexpr size_t smem() const {
    return (size_t)(xh * xld + mh * mld) * sizeof(float);
  }
};

// The median field of a tile whose corner is at (y0, x0): mh rows of
// mruns runs from (y0 - gr, x0 - gr) on, each median of the edge-replicated
// input, into med (row stride mld); xs stages the input window.  Ends in a
// barrier.
__device__ __forceinline__ void median_field(const Geo& G, const float* x,
                                             int h, int w, int y0, int x0,
                                             int mh, int mruns, float* xs,
                                             float* med) {
  pano::stage_clamped_async(xs, x, h, w, y0 - G.gr - 2, x0 - G.gr - 2,
                            mh + 4, G.xld);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int k = threadIdx.x; k < mh * mruns; k += blockDim.x) {
    const int r = k / mruns, q = (k - r * mruns) * MRUN;
    float m[MRUN];
    pano::median5_run(xs + r * G.xld + q, G.xld, m);
#pragma unroll
    for (int i = 0; i < MRUN; i += 4)
      *reinterpret_cast<float4*>(med + r * G.mld + q + i) =
          make_float4(m[i], m[i + 1], m[i + 2], m[i + 3]);
  }
  __syncthreads();
}

// KS > 0: a kernel built for KS taps, its blurs unrolled; KS == 0: the
// tap count of ``taps`` at run time, the same sums in the same order.
// VEC: every row of the planes starts on a 16-byte boundary.
template <int KS, bool VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
median5_diffuse_kernel(const float* __restrict__ x, const float* __restrict__ cf,
                       float* __restrict__ out, int h, int w, pano::Taps taps) {
  constexpr Geo GC(KS ? KS : 1);
  const Geo G = KS ? GC : Geo(taps.n);
  const int nt = KS ? KS : taps.n;
  const int GR = G.gr;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // xh x xld, later mh x MTW
  float* med = xs + G.xh * G.xld;               // mh x mld

  const int x0 = blockIdx.x * MTW, y0 = blockIdx.y * MTH;
  const int p = blockIdx.z;
  const size_t hw = (size_t)h * w;
  const int th = min(MTH, h - y0), tw = min(MTW, w - x0);
  const int mh = th + 2 * GR;                          // median rows needed
  const int mruns = (tw + 2 * GR + MRUN - 1) / MRUN;  // median runs a row
  const int oruns = (tw + RUN - 1) / RUN;              // output runs a row

  median_field(G, x + p * hw, h, w, y0, x0, mh, mruns, xs, med);

  // x pass: accx[r][q + m] = sum_t taps[t] * med[r][q + m + t]; the
  // columns beyond the medians computed above feed no output
  float* accx = xs;  // mh x MTW
  for (int k = threadIdx.x; k < mh * oruns; k += blockDim.x) {
    const int r = k / oruns, q = (k - r * oruns) * RUN;
    float acc[RUN];
    if (KS) {
      constexpr int LOADS = (RUN + 2 * (KS / 2) + 3) / 4;  // float4 a run
      float v[4 * LOADS];
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(med + r * G.mld + q + 4 * i);
        v[4 * i] = a.x, v[4 * i + 1] = a.y, v[4 * i + 2] = a.z,
              v[4 * i + 3] = a.w;
      }
#pragma unroll
      for (int m = 0; m < RUN; ++m) {
        acc[m] = 0.f;
#pragma unroll
        for (int i = 0; i < KS; ++i) acc[m] = acc[m] + taps.v[i] * v[m + i];
      }
    } else {
      // the outputs of the tile only: a read past the last one could
      // leave the median field
#pragma unroll
      for (int m = 0; m < RUN; ++m) {
        acc[m] = 0.f;
        if (q + m >= tw) continue;
        const float* row = med + r * G.mld + q + m;
        for (int i = 0; i < nt; ++i) acc[m] = acc[m] + taps.v[i] * row[i];
      }
    }
    *reinterpret_cast<float4*>(accx + r * MTW + q) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
  __syncthreads();

  const float* coef = cf + (size_t)(p / 2) * hw;
  float* dst = out + (size_t)p * hw;
  for (int k = threadIdx.x; k < th * oruns; k += blockDim.x) {
    const int yq = k / oruns, q = (k - yq * oruns) * RUN;
    float blur[RUN] = {0.f, 0.f, 0.f, 0.f};
    auto tap = [&](int i) {
      const float4 a =
          *reinterpret_cast<const float4*>(accx + (yq + i) * MTW + q);
      blur[0] = blur[0] + taps.v[i] * a.x;
      blur[1] = blur[1] + taps.v[i] * a.y;
      blur[2] = blur[2] + taps.v[i] * a.z;
      blur[3] = blur[3] + taps.v[i] * a.w;
    };
    if (KS) {
#pragma unroll
      for (int i = 0; i < KS; ++i) tap(i);
    } else {
      for (int i = 0; i < nt; ++i) tap(i);
    }
    const float* mc = med + (yq + GR) * G.mld + q + GR;
    const size_t at = (size_t)(y0 + yq) * w + x0 + q;
    if (VEC) {
      const float4 cv = *reinterpret_cast<const float4*>(coef + at);
      *reinterpret_cast<float4*>(dst + at) =
          make_float4(cv.x * blur[0] + (1.f - cv.x) * mc[0],
                      cv.y * blur[1] + (1.f - cv.y) * mc[1],
                      cv.z * blur[2] + (1.f - cv.z) * mc[2],
                      cv.w * blur[3] + (1.f - cv.w) * mc[3]);
    } else {
#pragma unroll
      for (int m = 0; m < RUN; ++m) {
        if (x0 + q + m >= w) break;
        const float cv = coef[at + m];
        dst[at + m] = cv * blur[m] + (1.f - cv) * mc[m];
      }
    }
  }
}

// The small levels' contract: the same median field, the blur at
// reflect-101 coordinates, the y pass first.  Every sum from +0, taps
// ascending.
template <int KS>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
median5_diffuse_small_kernel(const float* __restrict__ x,
                             const float* __restrict__ cf,
                             float* __restrict__ out, int h, int w,
                             pano::Taps taps) {
  constexpr Geo GC(KS ? KS : 1);
  const Geo G = KS ? GC : Geo(taps.n);
  const int nt = KS ? KS : taps.n;
  const int GR = G.gr;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // xh x xld, later th x mld
  float* med = xs + G.xh * G.xld;               // mh x mld

  const int x0 = blockIdx.x * MTW, y0 = blockIdx.y * MTH;
  const int p = blockIdx.z;
  const size_t hw = (size_t)h * w;
  const int th = min(MTH, h - y0), tw = min(MTW, w - x0);
  const int mh = th + 2 * GR;
  const int mruns = (tw + 2 * GR + MRUN - 1) / MRUN;
  median_field(G, x + p * hw, h, w, y0, x0, mh, mruns, xs, med);

  // y pass: acc[r][fc] over the tile's rows and the field's columns that
  // lie in the plane (field column fc is plane column x0 - GR + fc)
  float* acc = xs;
  const int fc0 = max(0, GR - x0), fc1 = min(tw + 2 * GR, w - x0 + GR);
  const int nc = fc1 - fc0;
  for (int k = threadIdx.x; k < th * nc; k += blockDim.x) {
    const int r = k / nc, fc = fc0 + k % nc;
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < nt; ++i)
      a = a + taps.v[i] *
                  med[(pano::reflect101(y0 + r + i - GR, h) - (y0 - GR)) *
                          G.mld + fc];
    acc[r * G.mld + fc] = a;
  }
  __syncthreads();

  // x pass and the blend
  const float* coef = cf + (size_t)(p / 2) * hw;
  float* dst = out + (size_t)p * hw;
  for (int k = threadIdx.x; k < th * tw; k += blockDim.x) {
    const int yq = k / tw, q = k % tw;
    float blur = 0.f;
#pragma unroll
    for (int i = 0; i < nt; ++i)
      blur = blur + taps.v[i] *
                        acc[yq * G.mld +
                            (pano::reflect101(x0 + q + i - GR, w) -
                             (x0 - GR))];
    const float m = med[(yq + GR) * G.mld + q + GR];
    const size_t at = (size_t)(y0 + yq) * w + x0 + q;
    const float cv = coef[at];
    dst[at] = cv * blur + (1.f - cv) * m;
  }
}

template <int KS>
int launch(const float* x, const float* c, float* out, int planes, int h,
           int w, const pano::Taps& taps, bool vec, cudaStream_t stream) {
  auto kernel = vec ? median5_diffuse_kernel<KS, true>
                    : median5_diffuse_kernel<KS, false>;
  const size_t smem = Geo(KS ? KS : taps.n).smem();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + MTW - 1) / MTW, (h + MTH - 1) / MTH, planes);
  kernel<<<grid, THREADS, smem, stream>>>(x, c, out, h, w, taps);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_small(const float* x, const float* c, float* out, int planes,
                 int h, int w, const pano::Taps& taps, cudaStream_t stream) {
  const size_t smem = Geo(KS ? KS : taps.n).smem();
  cudaError_t err = cudaFuncSetAttribute(
      median5_diffuse_small_kernel<KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + MTW - 1) / MTW, (h + MTH - 1) / MTH, planes);
  median5_diffuse_small_kernel<KS><<<grid, THREADS, smem, stream>>>(
      x, c, out, h, w, taps);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes a block needs for a blur of ksize taps; -1 beyond
// the taps a launch can pass.
extern "C" long long pano_median5_diffuse_smem(int ksize) {
  if (ksize < 1 || ksize > pano::MAX_TAPS) return -1;
  return (long long)Geo(ksize).smem();
}

// Kernels are unrolled for the odd tap counts 3 to 15 (15 is the width of
// every preset); any other ksize up to MAX_TAPS runs the kernel that takes
// its tap count at run time, where its window fits a block's shared memory.
extern "C" int pano_median5_diffuse(const float* x, const float* c, float* out,
                                    int planes, int h, int w,
                                    const float* taps_host, int ksize,
                                    void* stream) {
  if (planes < 2 || planes % 2 != 0 || h < 1 || w < 1 || ksize < 1 ||
      ksize > pano::MAX_TAPS)
    return (int)cudaErrorInvalidValue;
  const pano::Taps taps = pano::make_taps(taps_host, ksize);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (ksize) {
    case 3: return launch<3>(x, c, out, planes, h, w, taps, vec, s);
    case 5: return launch<5>(x, c, out, planes, h, w, taps, vec, s);
    case 7: return launch<7>(x, c, out, planes, h, w, taps, vec, s);
    case 9: return launch<9>(x, c, out, planes, h, w, taps, vec, s);
    case 11: return launch<11>(x, c, out, planes, h, w, taps, vec, s);
    case 13: return launch<13>(x, c, out, planes, h, w, taps, vec, s);
    case 15: return launch<15>(x, c, out, planes, h, w, taps, vec, s);
    default: return launch<0>(x, c, out, planes, h, w, taps, vec, s);
  }
}

// The small levels' variant: unrolled for the presets' 15 taps, any other
// ksize at run time; planes of at least 2 x 2 (reflect-101 needs two).
extern "C" int pano_small_median5_diffuse(const float* x, const float* c,
                                          float* out, int planes, int h,
                                          int w, const float* taps_host,
                                          int ksize, void* stream) {
  if (planes < 2 || planes % 2 != 0 || h < 2 || w < 2 || ksize < 1 ||
      ksize > pano::MAX_TAPS)
    return (int)cudaErrorInvalidValue;
  const pano::Taps taps = pano::make_taps(taps_host, ksize);
  cudaStream_t s = (cudaStream_t)stream;
  return ksize == 15 ? launch_small<15>(x, c, out, planes, h, w, taps, s)
                     : launch_small<0>(x, c, out, planes, h, w, taps, s);
}
