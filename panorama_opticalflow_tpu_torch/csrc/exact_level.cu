// The exact relaxation of one small pyramid level, in one block a direction:
// the blurred-flow target, `phases` x (`iters` Jacobi iterations of the
// exact gather error, then a 5x5 median), then the low-alpha diffusion.
//
// No TPU kernel: the JAX package runs this level (the coarsest, and the
// init-floor twin of the _fast presets) as XLA ops.  On the card the plain
// version (ops.kernels.exact_level_plain, models/pixflow's exact branch) is
// about 26,500 PyTorch kernels a pair, each a few microseconds of fixed cost
// on a plane of a few thousand pixels.
//
// Contract (= ops.kernels.exact_level_plain on CUDA tensors, bit for bit):
//   bf      = gauss_k(flow), reflect-101, rows then columns, sums from +0,
//             taps ascending;
//   phases times: iters times relax_iteration (models/pixflow), then
//             cv::medianBlur 5x5 (BORDER_REPLICATE) of each channel;
//   out     = c * gauss_k(flow) + (1 - c) * flow, c = 1 - a0 * a1.
// relax_iteration: err(f) at the pixel's flow, then the flows of the left,
// upper, right and lower neighbours (a neighbour outside the plane is no
// candidate), each taken only if its error is strictly lower; then, where
// a0 and a1 both exceed the threshold, one descent step from the taken
// flow b: g = (err(b + (eps, 0)) - e_b, err(b + (0, eps)) - e_b) * (1/eps),
// b - step * g; elsewhere the flow stays.  err(c) at (x, y) is
//   sqrt(d0^2 + d1^2) + smooth * sqrt(|bf - c|^2)
//     + (vcoef * |c.y| + hcoef * |c.x|) * (1/w)
// with (d0, d1) = i0 - bilinear(i1g, clamp(x + c.x, 0, w - 2),
// clamp(y + c.y, 0, h - 2)) (ops.warp.bilinear_extend, truncated cell,
// its sum order).  Every product and sum is rounded alone (-fmad=false)
// in the plain ops' order; a division by a Python number is PyTorch's on
// the card, a product with the reciprocal taken in double and rounded to
// float32 (1/w and 1/eps come in as arguments); the square roots are
// IEEE.
//
// Bound on the H100: latency.  A level of a few thousand pixels is 60
// iterations of ~7 error evaluations a pixel, about 0.1 GFLOP a pair, a
// few microseconds of the card's arithmetic; what it takes is the
// iterations' dependent chain: one block holds a direction and each
// iteration ends in a barrier.  Design: one block of 1024 threads a
// direction (grid = B), every plane of the direction in dynamic shared
// memory (i0, i1g, the target and the flow twice, as float2, and the
// update mask: 41 bytes a pixel), loaded once; nothing touches device
// memory again until the diffusion writes the output.  The iterations are
// Jacobi: each reads the flow buffer the previous one wrote and writes the
// other, so one barrier an iteration.  The median is the exchange network
// of median25_net.inc on each pixel's own window (four per level, not worth
// sharing columns); the blurs fold the reflect-101 index in the loop.
// phases, iters, h and w are run-time arguments: one instance serves every
// schedule and level size.  The wrapper gates the size (h * w <=
// EXACT_LEVEL_MAX_PIXELS) and a launch refuses a plane whose planes do not
// fit a block's shared memory.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr size_t SMEM_MAX = 227 * 1024;  // of one block on sm_90

struct Scalars {
  float thr, smooth, vcoef, hcoef, inv_w, eps, inv_eps, step;
  int phases, iters;
};

// shared-memory bytes of a plane of n pixels: five float2 planes and the
// mask
__host__ __device__ constexpr size_t smem_bytes(int n) {
  return 40 * (size_t)n + (size_t)n;
}

// error_function of candidate flow (cx, cy) at pixel (x, y), whose i0 is iv
// and whose target is tv; g holds i1g (both channels), w x h
__device__ __forceinline__ float err(const Scalars& s, const float2* g, int w,
                                     float wmax, float hmax, int x, int y,
                                     float cx, float cy, float2 iv,
                                     float2 tv) {
  const float X = fminf(fmaxf((float)x + cx, 0.f), wmax);
  const float Y = fminf(fmaxf((float)y + cy, 0.f), hmax);
  const int x0 = (int)X, y0 = (int)Y;
  const float xr = X - (float)x0, yr = Y - (float)y0;
  const float2* q = g + y0 * w + x0;
  const float2 f00 = q[0], f10 = q[1], f01 = q[w], f11 = q[w + 1];
  const float gx = ((f00.x + (f10.x - f00.x) * xr) + (f01.x - f00.x) * yr) +
                   ((((f00.x + f11.x) - f10.x) - f01.x) * xr) * yr;
  const float gy = ((f00.y + (f10.y - f00.y) * xr) + (f01.y - f00.y) * yr) +
                   ((((f00.y + f11.y) - f10.y) - f01.y) * xr) * yr;
  const float d0 = iv.x - gx, d1 = iv.y - gy;
  const float data = sqrtf(d0 * d0 + d1 * d1);
  const float fd0 = tv.x - cx, fd1 = tv.y - cy;
  const float sm = sqrtf(fd0 * fd0 + fd1 * fd1);
  const float reg =
      (s.vcoef * fabsf(cy) + s.hcoef * fabsf(cx)) * s.inv_w;
  return (data + s.smooth * sm) + reg;
}

// the 5x5 replicate-border median of one channel at (x, y) of f
template <bool Y>
__device__ __forceinline__ float median_at(const float2* f, int h, int w,
                                           int x, int y) {
  float cols[5][5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const int xx = pano::clampi(x + c - 2, 0, w - 1);
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const float2 v = f[pano::clampi(y + r - 2, 0, h - 1) * w + xx];
      cols[c][r] = Y ? v.y : v.x;
    }
    pano::sort_column(cols[c]);
  }
  float p[10], q[10];
  pano::merge_pair(cols[0], cols[1], p);
  pano::merge_pair(cols[2], cols[3], q);
  return pano::median_of_parts(p, q, cols[4]);
}

// dst[y][x] = sum_t taps[t] * src[reflect(y + t - r)][x] (rows) or
// src[y][reflect(x + t - r)] (columns), from +0, taps ascending
template <bool ROWS>
__device__ __forceinline__ float2 blur_at(const pano::Taps& taps,
                                          const float2* src, int h, int w,
                                          int x, int y) {
  const int r = taps.n / 2;
  float2 acc = make_float2(0.f, 0.f);
  for (int t = 0; t < taps.n; ++t) {
    const float2 v = ROWS ? src[pano::reflect101(y + t - r, h) * w + x]
                          : src[y * w + pano::reflect101(x + t - r, w)];
    acc.x = acc.x + taps.v[t] * v.x;
    acc.y = acc.y + taps.v[t] * v.y;
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS, 1)
exact_level_kernel(const float* __restrict__ i0x,
                   const float* __restrict__ i0y,
                   const float* __restrict__ i1g,
                   const float* __restrict__ a0,
                   const float* __restrict__ a1,
                   const float* __restrict__ flow, float* __restrict__ out,
                   int h, int w, Scalars s, pano::Taps taps) {
  const int n = h * w;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* i0 = reinterpret_cast<float2*>(smem_raw);  // n  (i0x, i0y)
  float2* g = i0 + n;                                // n  i1g
  float2* bf = g + n;                                // n  blurred target
  float2* cur = bf + n;                              // n  flow
  float2* nxt = cur + n;                             // n  flow, next
  unsigned char* upd = reinterpret_cast<unsigned char*>(nxt + n);  // n

  const size_t plane = (size_t)blockIdx.x * n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float wmax = (float)(w - 2), hmax = (float)(h - 2);

  for (int k = tid; k < n; k += nt) {
    const size_t o = plane + k;
    i0[k] = make_float2(i0x[o], i0y[o]);
    g[k] = make_float2(i1g[2 * o], i1g[2 * o + 1]);
    cur[k] = make_float2(flow[2 * o], flow[2 * o + 1]);
    upd[k] = a0[o] > s.thr && a1[o] > s.thr;
  }
  __syncthreads();
  for (int k = tid; k < n; k += nt)
    nxt[k] = blur_at<true>(taps, cur, h, w, k % w, k / w);
  __syncthreads();
  for (int k = tid; k < n; k += nt)
    bf[k] = blur_at<false>(taps, nxt, h, w, k % w, k / w);
  __syncthreads();

  for (int ph = 0; ph < s.phases; ++ph) {
#pragma unroll 1
    for (int it = 0; it < s.iters; ++it) {
      for (int k = tid; k < n; k += nt) {
        const int y = k / w, x = k - y * w;
        const float2 f = cur[k], iv = i0[k], tv = bf[k];
        float2 bv = f;
        float be = err(s, g, w, wmax, hmax, x, y, f.x, f.y, iv, tv);
        // candidates: the flow of the left, upper, right and lower
        // neighbour, where it lies in the plane
        const bool in[4] = {x > 0, y > 0, x + 1 < w, y + 1 < h};
        const int at[4] = {k - 1, k - w, k + 1, k + w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (!in[c]) continue;
          const float2 cf = cur[at[c]];
          const float e = err(s, g, w, wmax, hmax, x, y, cf.x, cf.y, iv, tv);
          if (e < be) {
            be = e;
            bv = cf;
          }
        }
        float2 nf = f;
        if (upd[k]) {
          const float ex = err(s, g, w, wmax, hmax, x, y, bv.x + s.eps,
                               bv.y + 0.f, iv, tv);
          const float ey = err(s, g, w, wmax, hmax, x, y, bv.x + 0.f,
                               bv.y + s.eps, iv, tv);
          const float gx = (ex - be) * s.inv_eps;
          const float gy = (ey - be) * s.inv_eps;
          nf = make_float2(bv.x - s.step * gx, bv.y - s.step * gy);
        }
        nxt[k] = nf;
      }
      __syncthreads();
      float2* t = cur;
      cur = nxt;
      nxt = t;
    }
    for (int k = tid; k < n; k += nt) {
      const int y = k / w, x = k - y * w;
      nxt[k] = make_float2(median_at<false>(cur, h, w, x, y),
                           median_at<true>(cur, h, w, x, y));
    }
    __syncthreads();
    float2* t = cur;
    cur = nxt;
    nxt = t;
  }

  // low-alpha diffusion: the column pass writes the output
  for (int k = tid; k < n; k += nt)
    nxt[k] = blur_at<true>(taps, cur, h, w, k % w, k / w);
  __syncthreads();
  for (int k = tid; k < n; k += nt) {
    const size_t o = plane + k;
    const float2 b = blur_at<false>(taps, nxt, h, w, k % w, k / w);
    const float c = 1.f - a0[o] * a1[o];
    const float2 f = cur[k];
    out[2 * o] = c * b.x + (1.f - c) * f.x;
    out[2 * o + 1] = c * b.y + (1.f - c) * f.y;
  }
}

}  // namespace

// Shared-memory bytes a block needs for a level of the given pixel count,
// for the wrapper's checks; -1 for no pixel or more than a block can take.
extern "C" long long pano_exact_level_smem(int pixels) {
  if (pixels < 1 || smem_bytes(pixels) > SMEM_MAX) return -1;
  return (long long)smem_bytes(pixels);
}

extern "C" int pano_exact_level(const float* i0x, const float* i0y,
                                const float* i1g, const float* a0,
                                const float* a1, const float* flow,
                                float* out, int nb, int h, int w, int phases,
                                int iters, const float* taps_host, int ksize,
                                float thr, float smooth, float vcoef,
                                float hcoef, float inv_w, float eps,
                                float inv_eps, float step, void* stream) {
  if (nb < 1 || h < 2 || w < 2 || phases < 0 || iters < 0 || ksize < 1 ||
      ksize > pano::MAX_TAPS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(h * w);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      exact_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Scalars s{thr, smooth, vcoef, hcoef, inv_w,
                  eps, inv_eps, step, phases, iters};
  exact_level_kernel<<<nb, THREADS, smem, (cudaStream_t)stream>>>(
      i0x, i0y, i1g, a0, a1, flow, out, h, w, s,
      pano::make_taps(taps_host, ksize));
  return (int)cudaGetLastError();
}
