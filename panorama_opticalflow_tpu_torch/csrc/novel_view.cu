// The novel-view stage of a pair in one pass: both views' nearest samplers,
// the deghosting softmax combiner and the window's placement on the canvas.
//
// No TPU kernel: the JAX package samples and combines with jnp ops
// (ops/warp.py's samplers, models/novel_view.py's combiner), which XLA
// fuses.  On the card the plain version (ops.kernels.novel_view_plain:
// window_cols, the two samplers, the combiner, place_cols) is ~213 PyTorch
// kernels a pair, among them gathers through int64 index planes of ~144 MB
// each at a 4000 x 3584 window, and ~45 elementwise ops that each read and
// write a whole plane: ~80 times the stage's bytes' time.
//
// Contract (= ops.kernels.novel_view_plain on CUDA tensors, bit for bit).
// Canvases (N, H, W) RGBA u8; the window's flows (N, H, wd, 2) and blend
// (N, H, wd) float32; window column x is canvas column (roll + x) mod W.
// View L samples canvas L through flow_rl at t = blend, view R canvas R
// through flow_lr at t = 1 - blend, both in window coordinates:
//   source  sx = trunc(float(x) + f.x * t), sy likewise, each op rounded
//           alone;
//   exact   (a window below TILED_SAMPLER_MIN_H x _W) sx wrapped once into
//           [0, wd), sy clamped, then the flat index sy * wd + sx into the
//           stack of windows, as the plain gather takes it;
//   tiled   ops.warp.sample_nearest_wrap_tiled: per 64 x 128 tile of the
//           window the offsets ox = sx - x, oy = clamp(sy, 0, H-1) - y over
//           the tile's edge-padded entries (a partial tile repeats the last
//           row and column), their mean rounded half to even and clamped to
//           +-96; the residuals ry = clamp(oy - off_y, +-8) at the pixel and
//           rx = clamp(ox - off_x, +-8) at tile row clamp(r + ry, 0, 63) (the
//           x pass runs over the block rows on the vertically edge-extended
//           residual, then the y pass selects); the source row
//           clamp(y + off_y + ry, 0, H-1), the column x + off_x + rx wrapped
//           once within the window (past the padded width the last padded
//           column, which no pixel of the window reaches);
//   combine models/novel_view's deghosting softmax in PyTorch's operation
//           order, every product and sum rounded alone (-fmad=false): a
//           division by a Python number is PyTorch's product with the float32
//           reciprocal (/ 255, / wd), a tensor by a tensor an IEEE division;
//           torch.exp, tanh, sqrt, round are expf, tanhf, sqrtf, rintf;
//           transparent (all zero) where either sample's alpha is 0, else
//           alpha 255.
// The tile mean is the exact integer sum times 1/8192: PyTorch's float32
// mean of the same whole numbers equals it wherever that sum is exact in
// float32 (|sum| < 2^24, a mean offset under 2048 px).  The canvas outside
// the window is the wrapper's zeros.
//
// Bound on the H100: device-memory bytes, ~32 a pixel (the two flows 16,
// blend 4, the two RGBA samples 8, the output 4) against a few dozen float
// operations and four transcendental calls.  Design: one block of 256
// threads a 64 x 128 tile of one canvas of the stack (grid: tiles x, tiles
// y, N).  Phase 1 reads the tile's flows and blend once, coalesced, and
// keeps both views' integer offsets in shared memory as int8 (an offset
// beyond +-105 gives the same clamped residual against any tile offset, so
// 32 KB a block and several blocks an SM) while the block sums them exactly
// for the two tile offsets.  Phase 2 reads the flows and blend again (the
// block's own, from L2), fetches each view's sample as one 4-byte load (the
// +-104 px neighbourhood is shared with the neighbouring tiles and stays in
// L2), combines in registers and stores one uchar4 at its canvas column:
// no index plane, no intermediate plane, and no copy of the window.
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TH = 64;
constexpr int TW = 128;
constexpr int MARGIN = 8;
constexpr int MAX_OFF = 96;
constexpr int PAD = MAX_OFF + MARGIN;
// clamp(o - off, +-MARGIN) is the same for o and clamp(o, +-KEEP) at every
// tile offset |off| <= MAX_OFF
constexpr int KEEP = PAD + 1;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STEPS = TH * TW / THREADS;

// deghost constants (CPU/OpticalFlow.cpp:57-59)
constexpr float COLOR_DIFF_COEF = 10.f;
constexpr float SOFTMAX_SHARPNESS = 10.f;
constexpr float FLOW_MAG_COEF = 100.f;

struct Args {
  const uchar4* img_l;  // (N, H, W) canvases
  const uchar4* img_r;
  const float* flow_lr;  // (N, H, wd, 2) at strides fn, fy (floats)
  const float* flow_rl;
  const float* blend;  // (N, H, wd) at strides bn, by
  uchar4* out;         // (N, H, W)
  const long long* roll_ptr;  // the window's roll on the card, or null
  long long roll;             // else this one
  long long fn, fy, bn, by;
  int nb, h, w, wd;
  float inv_wd;  // float32(1) / float32(wd), PyTorch's reciprocal
};

__device__ __forceinline__ float2 flow_at(const float* f, const Args& a,
                                          int n, int y, int x) {
  return *reinterpret_cast<const float2*>(f + n * a.fn + y * a.fy + 2 * x);
}

__device__ __forceinline__ float blend_at(const Args& a, int n, int y,
                                          int x) {
  return a.blend[n * a.bn + y * a.by + x];
}

// trunc(float(x) + f * t) as int: the product and the sum rounded alone
__device__ __forceinline__ int source(int x, float f, float t) {
  return __float2int_rz((float)x + f * t);
}

// PyTorch's float32 mean of a tile's TH * TW whole numbers, rounded half to
// even and clamped: the sum is exact here, and 1/8192 is a power of two
__device__ __forceinline__ int tile_offset(long long sum) {
  const float mean = (float)sum * (1.f / (TH * TW));
  return (int)pano::clampf(rintf(mean), -(float)MAX_OFF, (float)MAX_OFF);
}

__device__ __forceinline__ int canvas_col(int c, int roll, int w) {
  const int cc = roll + c;
  return cc >= w ? cc - w : cc;
}

// the tiled sampler's pick for tile entry (r, c), pixel (y, x) of canvas n
__device__ __forceinline__ uchar4 tiled_sample(
    const uchar4* img, const Args& a, const int8_t* ox, const int8_t* oy,
    int off_x, int off_y, int n, int r, int c, int y, int x, int roll) {
  const int ry = pano::clampi(oy[r * TW + c] - off_y, -MARGIN, MARGIN);
  const int rr = pano::clampi(r + ry, 0, TH - 1);
  const int rx = pano::clampi(ox[rr * TW + c] - off_x, -MARGIN, MARGIN);
  const int row = pano::clampi(y + off_y + ry, 0, a.h - 1);
  const int j = min(x + off_x + rx, a.wd + PAD - 1);
  const int col = j < 0 ? j + a.wd : (j >= a.wd ? j - a.wd : j);
  return img[((size_t)n * a.h + row) * a.w + canvas_col(col, roll, a.w)];
}

// the exact sampler's pick: one wrap, a clamped row, the flat index into
// the stack of windows (a negative one counted from its end, as PyTorch
// indexes; kept inside it, where the plain gather raises)
__device__ __forceinline__ uchar4 point_sample(const uchar4* img,
                                               const Args& a, float2 f,
                                               float t, int n, int y, int x,
                                               int roll) {
  int sx = source(x, f.x, t);
  const int sy = pano::clampi(source(y, f.y, t), 0, a.h - 1);
  if (sx > a.wd - 1) sx -= a.wd;
  if (sx < 0) sx += a.wd;
  const long long plane = (long long)a.h * a.wd;
  long long g = n * plane + (long long)sy * a.wd + sx;
  const long long all = a.nb * plane;
  if (g < 0) g += all;
  g = g < 0 ? 0 : (g >= all ? all - 1 : g);
  const long long m = g / plane, rem = g - m * plane;
  const int row = (int)(rem / a.wd), col = (int)(rem - (long long)row * a.wd);
  return img[((size_t)m * a.h + row) * a.w + canvas_col(col, roll, a.w)];
}

__device__ __forceinline__ float mag(float2 f, float inv_wd) {
  return sqrtf(f.x * f.x + f.y * f.y) * inv_wd;
}

__device__ __forceinline__ unsigned char channel(float l, float wl, float r,
                                                 float wr) {
  return (unsigned char)pano::clampf(rintf(l * wl + r * wr), 0.f, 255.f);
}

// models/novel_view's combiner on one pixel, in PyTorch's order
__device__ __forceinline__ uchar4 combine(uchar4 cl, uchar4 cr, float2 flr,
                                          float2 frl, float blend_r,
                                          float inv_wd) {
  if (cl.w == 0 || cr.w == 0) return make_uchar4(0, 0, 0, 0);
  constexpr float inv255 = 1.f / 255.f;
  const float blend_l = 1.f - blend_r;
  const float mag_lr = mag(flr, inv_wd), mag_rl = mag(frl, inv_wd);
  const float l0 = cl.x, l1 = cl.y, l2 = cl.z, r0 = cr.x, r1 = cr.y,
              r2 = cr.z;
  const float diff =
      (fabsf(l0 - r0) + fabsf(l1 - r1) + fabsf(l2 - r2)) * inv255;
  const float deghost = tanhf(diff * COLOR_DIFF_COEF);
  const float alpha_l = (float)cl.w * inv255, alpha_r = (float)cr.w * inv255;
  const float a_l = SOFTMAX_SHARPNESS * blend_l * alpha_l *
                    (1.f + FLOW_MAG_COEF * mag_rl);
  const float a_r = SOFTMAX_SHARPNESS * blend_r * alpha_r *
                    (1.f + FLOW_MAG_COEF * mag_lr);
  const float m = fmaxf(a_l, a_r);
  const float exp_l = expf(a_l - m), exp_r = expf(a_r - m);
  const float sum_exp = exp_l + exp_r + 1e-5f * expf(-m);
  const float w_l = blend_l + deghost * (exp_l / sum_exp - blend_l);
  const float w_r = blend_r + deghost * (exp_r / sum_exp - blend_r);
  return make_uchar4(channel(l0, w_l, r0, w_r), channel(l1, w_l, r1, w_r),
                     channel(l2, w_l, r2, w_r), 255);
}

template <bool TILED>
__global__ void __launch_bounds__(THREADS) novel_view_kernel(Args a) {
  // both views' offsets of the tile's entries: [0] view L, [1] view R
  __shared__ int8_t ox[2][TH * TW], oy[2][TH * TW];
  __shared__ long long part[WARPS][4];
  const int n = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const long long roll_in = a.roll_ptr ? *a.roll_ptr : a.roll;
  const int roll = (int)(((roll_in % a.w) + a.w) % a.w);

  int off[4] = {0, 0, 0, 0};  // (x, y) of view L, then of view R
  if constexpr (TILED) {
    long long sum[4] = {0, 0, 0, 0};
    for (int k = 0; k < STEPS; ++k) {
      const int e = tid + k * THREADS, r = e / TW, c = e % TW;
      const int y = min(y0 + r, a.h - 1), x = min(x0 + c, a.wd - 1);
      const float b = blend_at(a, n, y, x);
      const float2 f[2] = {flow_at(a.flow_rl, a, n, y, x),
                           flow_at(a.flow_lr, a, n, y, x)};
      const float t[2] = {b, 1.f - b};
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int dx = source(x, f[v].x, t[v]) - x;
        const int dy = pano::clampi(source(y, f[v].y, t[v]), 0, a.h - 1) - y;
        sum[2 * v] += dx;
        sum[2 * v + 1] += dy;
        ox[v][e] = (int8_t)pano::clampi(dx, -KEEP, KEEP);
        oy[v][e] = (int8_t)pano::clampi(dy, -KEEP, KEEP);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      for (int o = 16; o > 0; o >>= 1)
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], o);
      if (tid % 32 == 0) part[tid / 32][i] = sum[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      long long s = 0;
      for (int wp = 0; wp < WARPS; ++wp) s += part[wp][i];
      off[i] = tile_offset(s);
    }
  }

  for (int k = 0; k < STEPS; ++k) {
    const int e = tid + k * THREADS, r = e / TW, c = e % TW;
    const int y = y0 + r, x = x0 + c;
    if (y >= a.h || x >= a.wd) continue;
    const float b = blend_at(a, n, y, x);
    const float2 flr = flow_at(a.flow_lr, a, n, y, x);
    const float2 frl = flow_at(a.flow_rl, a, n, y, x);
    uchar4 cl, cr;
    if constexpr (TILED) {
      cl = tiled_sample(a.img_l, a, ox[0], oy[0], off[0], off[1], n, r, c, y,
                        x, roll);
      cr = tiled_sample(a.img_r, a, ox[1], oy[1], off[2], off[3], n, r, c, y,
                        x, roll);
    } else {
      cl = point_sample(a.img_l, a, frl, b, n, y, x, roll);
      cr = point_sample(a.img_r, a, flr, 1.f - b, n, y, x, roll);
    }
    a.out[((size_t)n * a.h + y) * a.w + canvas_col(x, roll, a.w)] =
        combine(cl, cr, flr, frl, b, a.inv_wd);
  }
}

}  // namespace

extern "C" int pano_novel_view(const void* img_l, const void* img_r,
                               const float* flow_lr, const float* flow_rl,
                               const float* blend, void* out, int nb, int h,
                               int w, int wd, long long fn, long long fy,
                               long long bn, long long by,
                               const long long* roll_ptr, long long roll,
                               float inv_wd, int tiled, void* stream) {
  if (nb < 1 || h < 1 || wd < 1 || wd > w || nb > 65535 ||
      (tiled && wd <= PAD))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const uchar4*>(img_l),
               static_cast<const uchar4*>(img_r),
               flow_lr,
               flow_rl,
               blend,
               static_cast<uchar4*>(out),
               roll_ptr,
               roll,
               fn,
               fy,
               bn,
               by,
               nb,
               h,
               w,
               wd,
               inv_wd};
  const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, nb);
  if (tiled)
    novel_view_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  else
    novel_view_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
