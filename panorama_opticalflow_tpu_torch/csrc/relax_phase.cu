// One relaxation phase of the pixflow solver: K Jacobi iterations of
// 4-neighbour propagation + descent, in two variants:
//   fused    the blurred-flow target is computed in the kernel from f_base;
//            replaces relax_phase_pallas(..., fuse_bf=True), the
//            relaxation of every fused single-phase pyramid level;
//   unfused  the target (bfx, bfy) is an input, blurred once per level by
//            the caller; replaces relax_phase_pallas(..., fuse_bf=False),
//            each phase of multi-phase levels (relax_phases > 1) and of
//            levels with fuse_level_blurs=False.
// Both Pallas variants are _relax_phase_impl in
// panorama_opticalflow_tpu/ops/pallas/kernels.py.  The two differ only in
// how a block gets its target, so they are one kernel with a flag.
//
// The small levels (below pallas_min_pixels) keep the image's own borders
// instead: relax_small_kernel, the same body built with SMALL, is bit for
// bit ops.relax_fast.relax_phase_fast on the whole plane (ops.kernels.
// small_relax_phase_plain / _unfused_plain), with no JAX counterpart:
//   * a candidate from outside the image is no candidate (the plain
//     branch's validity masks), and a window position outside the image
//     is never read otherwise: the x pass rows beyond the image's first
//     and last row are filled by the pixels of those rows, with their own
//     offset and the edge-clamped w1 rows (the plain x pass's
//     edge-extended offsets and edge-padded w1);
//   * the fused target is the k-tap Gaussian of f_base with reflect-101
//     borders, the y pass first (ops.image.gaussian_blur), sums from +0
//     with the taps ascending;
//   * the regularisation is PyTorch's on the card: err adds
//     (vreg * |fy| + hreg * |fx|) * (1/w) to data + smooth * |bf - f|, and
//     the descent (hreg * sign(fx)) * (1/w), where 1/w is float32(1.0 / w)
//     (a division by a Python number is a product with that reciprocal).
// Its halo is 2 D K rows, not the reference's K + D + 2: an iteration
// reaches 2 D rows (a pixel's descent reads the x pass up to D rows away,
// whose accepted flow read the x pass up to D rows further) and one
// column, so the bits of a tile are those of the whole plane, whatever
// the tile.  (The edge contract's K + D + 2 rows fall short of that reach
// where residuals near D propagate: why the kernel levels hold a share of
// pixels, not every bit, against their plain versions.)  A window is built
// for at most SMALL_ITERS = 3 iterations (24 halo rows of 58 at D = 2);
// the wrapper runs a longer phase in launches of 3, which gives the same
// bits, since only the flow carries from one iteration to the next.
//
// Contract (= ops.kernels.relax_phase_fused_plain / _unfused_plain): every
// plane is edge-padded by a halo around each output tile and iterated on
// that window with edge-replicated shifts at the window border; the fused
// variant's regularisation target is the separable k-tap Gaussian of the
// edge-padded f_base, x pass first, the unfused variant reads bfx/bfy with
// the same clamped indices as every other plane.  Per iteration:
//   pass A  samples the bf16-quantised warped gradients w1 with a D-wide
//           separable hat window at the own offset and for the 4
//           neighbour candidates, error = data + smooth*|bf - f|
//           + vreg/w*|fy| + hreg/w*|fx|, strict-< take (left, up, right,
//           down);
//   pass B  one descent step from the analytic dhat derivative maps, at
//           pixels whose update mask is > 0.
// The output tile does not depend on the tile size: the halo covers the
// reach of K iterations (K + D + 2 rows as in the reference; K columns,
// because an iteration reaches one column: a candidate is a horizontal
// neighbour's flow, and every x-pass value a pixel reads lies in its own
// column).
//
// Bound on the H100: operations (about 300 an iteration and pixel in the
// least-work form, against 44 or 52 bytes a pixel), in practice the
// instruction throughput, since every product and sum is its own
// instruction (-fmad=false) and each pixel takes 12 IEEE square roots an
// iteration.  The reference sums all 2D + 1 taps of every hat pass because
// a TPU cannot gather; a hat weight is an exact zero at every tap but
// floor(d) and floor(d) + 1, and so is its derivative.  Design:
//   * two-tap gather in every pass.  An x pass reads its two w1 taps once
//     and, in pass B, forms the hat and the dhat sums from them; a y sum
//     reads two rows of the x-pass buffer.  Sums start at 0 and add the
//     taps ascending, so the bits are those of the dense sums.
//   * D and the iteration count the window is built for are template
//     parameters: the window is a constant, no run-time division, and a
//     thread owns the same PIX pixels of the window through every step.
//     What only the owner reads again (f_base, the accepted flow and its
//     sample, the mask) lives in its registers.
//   * What the iterations read again is staged in shared memory once a
//     block, already clamped, by asynchronous copies that are all in
//     flight together: w1 (then rounded to bf16 once, in place), i0, the
//     target, the flow state and its clamped y offset, both channels of a
//     pixel in one float2.  No device-memory read is left inside the
//     iterations.  The fused variant stages w1 over its dead blur source
//     while the blur's y pass runs.
//   * A thread evaluates the x pass at its own pixels, and the owners of
//     the window's first and last row also fill the rows that extend
//     their offset beyond the window, so an x pass needs no second sweep.
//     Four barriers an iteration.
//   * One block of 1024 threads an SM.  The staging needs about 220 KB
//     whatever the tile's shape, so a second block never fits; the
//     iterations are bound by latency between barriers until the SM holds
//     its 32 warps (512 threads with 8 pixels each took 1.6 times as
//     long).  The tile is the tallest whose window fits PIX * THREADS
//     owned pixels and the 227 KB of a block: 44 x 64 at K <= 3, D = 2,
//     so 69 % of the window is output.  Windows are built for K = 3, 5 and
//     7 at D = 1, 2 and 3; a K in between runs in the next larger one,
//     which changes no output bit.  Any other K and D run one more instance
//     that reads its window's geometry at run time (the same code, with
//     run-time divisions): the tallest window that fits, down to 8 tile
//     rows.  A window that does not fit a block's shared memory or its
//     threads' pixels is refused: the wrapper raises with the bytes it
//     would need and the largest K that fits (14 at D = 2 on an H100).
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int RTW = 64;
constexpr int THREADS = 1024;
constexpr int PIX = 4;         // window pixels a thread owns
constexpr int MIN_ROWS = 8;    // fewest tile rows of a window
constexpr int BLUR_TAPS = 15;  // the presets' target blur, unrolled
constexpr int SMALL_ITERS = 3;  // the most iterations a small window holds
constexpr size_t SMEM_MAX = 227 * 1024;  // of one block on sm_90

// the iteration count an unrolled window is built for: 3, 5 or 7
__host__ __device__ constexpr int built_iters(int iters) {
  return iters <= 3 ? 3 : iters <= 5 ? 5 : 7;
}

// D and K that run an unrolled instance; others run the run-time one
__host__ __device__ constexpr bool unrolled(int D, int iters) {
  return D >= 1 && D <= 3 && iters <= 7;
}

// Window of a block that runs up to KB iterations: the tile plus a halo of
// KB + D + 2 rows (small: 2 D KB) and KB columns each side.
struct Window {
  int hy, hx, the, twe, xr, ww;
  __host__ __device__ constexpr Window(int D_, int kb, int the_,
                                       bool small = false)
      : hy(small ? 2 * D_ * kb : kb + D_ + 2), hx(kb), the(the_),
        twe(RTW + 2 * kb),
        xr(the_ + 2 * (D_ + 1)), ww(RTW + 2 * kb + 2 * D_) {}
  __host__ __device__ constexpr int pixels() const { return the * twe; }
  // an x-pass buffer, the w1 window
  __host__ __device__ constexpr int nx() const { return xr * twe; }
  __host__ __device__ constexpr int nw() const { return xr * ww; }
  // flow, i0 and target as float2 and the y offset as float a pixel; two
  // x-pass buffers and w1 as float2
  __host__ __device__ constexpr size_t bytes() const {
    return 28 * (size_t)pixels() + 16 * (size_t)nx() + 8 * (size_t)nw();
  }
};

// as many rows as PIX * THREADS owned pixels and the shared memory allow,
// and never fewer than MIN_ROWS tile rows
__host__ __device__ constexpr Window make_window(int D, int kb,
                                                 bool small = false) {
  const int least = MIN_ROWS + 2 * Window(D, kb, 0, small).hy;
  int the = PIX * THREADS / (RTW + 2 * kb);
  while (the > least && Window(D, kb, the, small).bytes() > SMEM_MAX) --the;
  return Window(D, kb, the < least ? least : the, small);
}

struct Scalars {
  float lim, smooth, step, vreg_w, hreg_w;
  int fold, w1_bf16, fuse_bf, iters;
  int d, kb;  // the run-time instance's D and window iterations
  float vreg, hreg, inv_w;  // SMALL: the coefficients and float32(1 / w)
};

struct Planes {
  const float *fx, *fy, *bx, *by, *w1x, *w1y, *i0x, *i0y, *mask;
  const float *bfx, *bfy;  // the given target (unfused variant only)
  float *ofx, *ofy;
};

// (a.x, a.y) <- (gx[o], gy[o]) without a register in between
__device__ __forceinline__ void stage(float2* a, const float* gx,
                                      const float* gy, size_t o) {
  __pipeline_memcpy_async(&a->x, gx + o, sizeof(float));
  __pipeline_memcpy_async(&a->y, gy + o, sizeof(float));
}

// X(r,c) = sum_ox hat(dx - ox) * W1[r, c+ox] at the pixel's own position
// and, for a pixel of a first row (the window's, or SMALL the image's), on
// the D + 1 rows above it, and for one of a last row on the D + 1 below,
// which edge-extend its offset.  With DERIV also Xd, the same sum with
// dhat weights, from the same two taps.
template <bool DERIV>
__device__ __forceinline__ void x_pass(const Window& G, int D, float dx,
                                       int r, int c, bool first, bool last,
                                       const float2* W1, float2* X,
                                       float2* Xd) {
  const float fl = floorf(dx);
  const float t0 = dx - fl, t1 = dx - (fl + 1.f);
  const float h0 = pano::hat(t0), h1 = pano::hat(t1);
  const float d0 = pano::dhat(t0), d1 = pano::dhat(t1);
  const int r_lo = first ? r - (D + 1) : r;
  const int r_hi = last ? r + D + 1 : r;
  for (int rr = r_lo; rr <= r_hi; ++rr) {
    const float2* q = W1 + (rr + D + 1) * G.ww + c + D + (int)fl;
    const float2 v0 = q[0], v1 = q[1];
    const int k = (rr + D + 1) * G.twe + c;
    X[k] = pano::tap2(h0, v0, h1, v1);
    if (DERIV) Xd[k] = pano::tap2(d0, v0, d1, v1);
  }
}

// sum_oy hat(d - oy) * X[r + oy][c], r in window coordinates (the caller
// adds a neighbour's row offset)
__device__ __forceinline__ float2 y_sum(const Window& G, int D,
                                        const float2* X, float d, int r,
                                        int c) {
  const float fl = floorf(d);
  const float2* q = X + (r + (int)fl + D + 1) * G.twe + c;
  return pano::tap2(pano::hat(d - fl), q[0], pano::hat(d - (fl + 1.f)),
                    q[G.twe]);
}

// sum_t taps[t] * in[t * stride] on both planes, taps ascending; NT is the
// tap count when it is known at compile time (unrolled), else 0
template <int NT>
__device__ __forceinline__ float2 blur_sum(const pano::Taps& taps,
                                           const float2* in, int stride) {
  float2 acc = make_float2(0.f, 0.f);
  const int n = NT ? NT : taps.n;
#pragma unroll
  for (int t = 0; t < n; ++t) {
    const float2 v = in[t * stride];
    acc.x = acc.x + taps.v[t] * v.x;
    acc.y = acc.y + taps.v[t] * v.y;
  }
  return acc;
}

// the error of candidate flow cf with sample sv; SMALL in the plain branch's
// order (ops.relax_fast._err_terms), else the reference kernel's
template <bool SMALL>
__device__ __forceinline__ float err(const Scalars& s, float2 sv, float2 cf,
                                     float2 i0, float2 bf) {
  const float d0 = i0.x - sv.x, d1 = i0.y - sv.y;
  const float data = sqrtf(d0 * d0 + d1 * d1);
  const float fdx = bf.x - cf.x, fdy = bf.y - cf.y;
  const float sm = sqrtf(fdx * fdx + fdy * fdy);
  if (SMALL)
    return (data + s.smooth * sm) +
           (s.vreg * fabsf(cf.y) + s.hreg * fabsf(cf.x)) * s.inv_w;
  return data + s.smooth * sm + s.vreg_w * fabsf(cf.y) +
         s.hreg_w * fabsf(cf.x);
}

// sum_t taps[t] * v[(reflect101(i + t - n / 2, len) - lo) * stride] on both
// planes, from +0, taps ascending: one reflect-101 pass of the Gaussian
// over a line whose staged part starts at coordinate lo
template <int NT>
__device__ __forceinline__ float2 reflect_sum(const pano::Taps& taps,
                                              const float2* v, int stride,
                                              int i, int lo, int len) {
  float2 acc = make_float2(0.f, 0.f);
  const int n = NT ? NT : taps.n;
#pragma unroll
  for (int t = 0; t < n; ++t) {
    const float2 a = v[(pano::reflect101(i + t - n / 2, len) - lo) * stride];
    acc.x = acc.x + taps.v[t] * a.x;
    acc.y = acc.y + taps.v[t] * a.y;
  }
  return acc;
}

// D > 0: the window built for D and KB iterations; D == 0: the window of
// s.d and s.kb, made at run time.  SMALL: the image-border contract.
template <int D_, int KB, bool SMALL>
__device__ __forceinline__ void relax_body(const Planes& p, const Scalars& s,
                                           const pano::Taps& taps, int h,
                                           int w) {
  constexpr Window GC = make_window(D_ ? D_ : 1, D_ ? KB : 1, SMALL);
  static_assert(!D_ || GC.pixels() <= PIX * THREADS,
                "a thread owns at most PIX pixels");
  const Window G = D_ ? GC : make_window(s.d, s.kb, SMALL);
  const int D = D_ ? D_ : s.d;
  const int THE = G.the, TWE = G.twe, A = G.pixels();
  const int RTH = THE - 2 * G.hy;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* f = reinterpret_cast<float2*>(smem_raw);  // A   flow state
  float2* i0 = f + A;                               // A   (i0x, i0y)
  float2* bf = i0 + A;                              // A   blurred target
  float2* X = bf + A;                               // nx  x pass, hat
  float2* Xd = X + G.nx();                          // nx  x pass, dhat
  float2* W1 = Xd + G.nx();                         // nw  (w1x, w1y)
  float* dyc = reinterpret_cast<float*>(W1 + G.nw());  // A clamp(fy - by)

  const int tid = threadIdx.x;
  const int gy0 = blockIdx.y * RTH - G.hy, gx0 = blockIdx.x * RTW - G.hx;
  const size_t plane = (size_t)blockIdx.z * h * w;
  // device offset of window coordinates (r, c), edge-clamped
  auto at = [&](int r, int c) {
    return plane + (size_t)pano::clampi(gy0 + r, 0, h - 1) * w +
           pano::clampi(gx0 + c, 0, w - 1);
  };
  auto inside = [&](int r, int c) {
    return gy0 + r >= 0 && gy0 + r < h && gx0 + c >= 0 && gx0 + c < w;
  };
  auto stage_w1 = [&]() {
    for (int q = tid; q < G.nw(); q += THREADS)
      stage(W1 + q, p.w1x, p.w1y, at(q / G.ww - (D + 1), q % G.ww - D));
  };
  // the rows whose x pass a pixel of window row r extends: the window's
  // first and last, and SMALL the image's
  auto first = [&](int r) { return r == 0 || (SMALL && gy0 + r == 0); };
  auto last = [&](int r) {
    return r == THE - 1 || (SMALL && gy0 + r == h - 1);
  };

  // per owned pixel: f_base, the accepted flow and its sample, update bit,
  // and SMALL whether it lies in the image (no other pixel is iterated)
  float2 b[PIX], bestf[PIX], bests[PIX];
  unsigned upd[(PIX + 31) / 32] = {};
  unsigned live[(PIX + 31) / 32] = {};

  // Stage the window: asynchronous copies for what goes to shared memory
  // as it is, so that all of a thread's loads are in flight together.
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const int k = tid + j * THREADS;
    if (k < A) {
      const size_t o = at(k / TWE, k % TWE);
      stage(f + k, p.fx, p.fy, o);
      stage(i0 + k, p.i0x, p.i0y, o);
      if (!s.fuse_bf) stage(bf + k, p.bfx, p.bfy, o);
      b[j] = make_float2(p.bx[o], p.by[o]);
      if (p.mask[o] > 0.f) upd[j / 32] |= 1u << (j % 32);
      if (SMALL && inside(k / TWE, k % TWE)) live[j / 32] |= 1u << (j % 32);
    }
  }
  auto alive = [&](int j) {
    return !SMALL || (live[j / 32] >> (j % 32) & 1u);
  };
  if (s.fuse_bf) {
    // blurred-flow target over the window from the f_base planes, padded
    // by the blur radius more, both planes as one float2.  The scratch is
    // the x-pass and w1 buffers: the first pass's result first, so that w1
    // can be staged over the dead source while the second pass runs.
    const int gr = taps.n / 2;
    const int bh = THE + 2 * gr, bw = TWE + 2 * gr;
    float2* tmp = X;               // bh x TWE; SMALL THE x bw, no larger
    float2* src = tmp + bh * TWE;  // bh x bw
    for (int k = tid; k < bh * bw; k += THREADS)
      stage(src + k, p.bx, p.by, at(k / bw - gr, k % bw - gr));
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (SMALL) {
      // reflect-101, the y pass first: the staged rows and columns start
      // at gy0 - gr and gx0 - gr, and a reflected index of a pixel in the
      // image stays inside them; only the image's pixels are blurred
      for (int k = tid; k < THE * bw; k += THREADS) {
        const int r = k / bw, cc = k % bw;
        if (inside(r, cc - gr))
          tmp[k] = taps.n == BLUR_TAPS
                       ? reflect_sum<BLUR_TAPS>(taps, src + cc, bw, gy0 + r,
                                                gy0 - gr, h)
                       : reflect_sum<0>(taps, src + cc, bw, gy0 + r,
                                        gy0 - gr, h);
      }
      __syncthreads();
      stage_w1();
      for (int k = tid; k < A; k += THREADS) {
        const int r = k / TWE, c = k % TWE;
        if (inside(r, c))
          bf[k] = taps.n == BLUR_TAPS
                      ? reflect_sum<BLUR_TAPS>(taps, tmp + r * bw, 1,
                                               gx0 + c, gx0 - gr, w)
                      : reflect_sum<0>(taps, tmp + r * bw, 1, gx0 + c,
                                       gx0 - gr, w);
      }
    } else {
      for (int k = tid; k < bh * TWE; k += THREADS) {
        const float2* row = src + (k / TWE) * bw + k % TWE;
        tmp[k] = taps.n == BLUR_TAPS ? blur_sum<BLUR_TAPS>(taps, row, 1)
                                     : blur_sum<0>(taps, row, 1);
      }
      __syncthreads();
      stage_w1();
      for (int k = tid; k < A; k += THREADS)
        bf[k] = taps.n == BLUR_TAPS ? blur_sum<BLUR_TAPS>(taps, tmp + k, TWE)
                                    : blur_sum<0>(taps, tmp + k, TWE);
    }
  } else {
    stage_w1();
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  if (s.w1_bf16)
    for (int q = tid; q < G.nw(); q += THREADS)
      W1[q] = make_float2(
          __bfloat162float(__float2bfloat16_rn(W1[q].x)),
          __bfloat162float(__float2bfloat16_rn(W1[q].y)));
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const int k = tid + j * THREADS;
    if (k < A) dyc[k] = pano::clampf(f[k].y - b[j].y, -s.lim, s.lim);
  }
  __syncthreads();

#pragma unroll 1
  for (int it = 0; it < s.iters; ++it) {
    // ---- pass A: propagation ----
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      const int k = tid + j * THREADS;
      if (k < A && alive(j)) {
        const int r = k / TWE, c = k % TWE;
        x_pass<false>(G, D, pano::clampf(f[k].x - b[j].x, -s.lim, s.lim), r,
                      c, first(r), last(r), W1, X, Xd);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      const int k = tid + j * THREADS;
      if (k < A && alive(j)) {
        const int r = k / TWE, c = k % TWE;
        const float2 iv = i0[k], tv = bf[k];
        float2 bfv = f[k];
        float2 sv = y_sum(G, D, X, dyc[k], r, c);
        float be = err<SMALL>(s, sv, bfv, iv, tv);
        // candidates: from left, up, right, down; each is the neighbour's
        // flow with the neighbour's own sample map at the +-1 offset, which
        // for a horizontal neighbour is the pixel's own column.  SMALL: a
        // neighbour outside the image is none.
        const int nr[4] = {r, max(r - 1, 0), r, min(r + 1, THE - 1)};
        const int nc[4] = {max(c - 1, 0), c, min(c + 1, TWE - 1), c};
        const int ro[4] = {0, 1, 0, -1};
        const int co[4] = {1, 0, -1, 0};
        const bool in[4] = {gx0 + c > 0, gy0 + r > 0, gx0 + c < w - 1,
                            gy0 + r < h - 1};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (SMALL && !in[q]) continue;
          const int n = nr[q] * TWE + nc[q];
          const float2 cf = f[n];
          const float2 cs =
              y_sum(G, D, X, dyc[n], nr[q] + ro[q], nc[q] + co[q]);
          const float e = err<SMALL>(s, cs, cf, iv, tv);
          if (e < be) {
            be = e;
            bfv = cf;
            if (s.fold) sv = cs;
          }
        }
        bestf[j] = bfv;
        bests[j] = sv;
      }
    }
    __syncthreads();

    // ---- pass B: descent at the accepted flow ----
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      const int k = tid + j * THREADS;
      if (k < A && alive(j)) {
        const int r = k / TWE, c = k % TWE;
        x_pass<true>(G, D, pano::clampf(bestf[j].x - b[j].x, -s.lim, s.lim),
                     r, c, first(r), last(r), W1, X, Xd);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      const int k = tid + j * THREADS;
      if (k < A && alive(j)) {
        const float2 bfv = bestf[j];
        const float dy2 = pano::clampf(bfv.y - b[j].y, -s.lim, s.lim);
        const float fl = floorf(dy2);
        const float t0 = dy2 - fl, t1 = dy2 - (fl + 1.f);
        const int xk = (k / TWE + (int)fl + D + 1) * TWE + k % TWE;
        const float2 x0 = X[xk], x1 = X[xk + TWE];
        const float2 gy = pano::tap2(pano::dhat(t0), x0, pano::dhat(t1), x1);
        const float2 gx = pano::tap2(pano::hat(t0), Xd[xk], pano::hat(t1),
                               Xd[xk + TWE]);
        const float2 sv =
            s.fold ? bests[j]
                   : pano::tap2(pano::hat(t0), x0, pano::hat(t1), x1);
        const float2 iv = i0[k], tv = bf[k];
        const float d0 = iv.x - sv.x, d1 = iv.y - sv.y;
        const float q = sqrtf(d0 * d0 + d1 * d1);
        const float inv_q = q > 1e-12f ? 1.f / q : 0.f;
        const float ddx = -(d0 * gx.x + d1 * gx.y) * inv_q;
        const float ddy = -(d0 * gy.x + d1 * gy.y) * inv_q;
        const float fdx = tv.x - bfv.x, fdy = tv.y - bfv.y;
        const float sn = sqrtf(fdx * fdx + fdy * fdy);
        const float inv_s = sn > 1e-12f ? 1.f / sn : 0.f;
        const float gxs =
            SMALL ? (ddx + s.smooth * (-fdx * inv_s)) +
                        (s.hreg * pano::sgn(bfv.x)) * s.inv_w
                  : ddx + s.smooth * (-fdx * inv_s) +
                        s.hreg_w * pano::sgn(bfv.x);
        const float gys =
            SMALL ? (ddy + s.smooth * (-fdy * inv_s)) +
                        (s.vreg * pano::sgn(bfv.y)) * s.inv_w
                  : ddy + s.smooth * (-fdy * inv_s) +
                        s.vreg_w * pano::sgn(bfv.y);
        if (upd[j / 32] >> (j % 32) & 1u) {
          const float2 nf =
              make_float2(bfv.x - s.step * gxs, bfv.y - s.step * gys);
          f[k] = nf;
          dyc[k] = pano::clampf(nf.y - b[j].y, -s.lim, s.lim);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const int k = tid + j * THREADS;
    const int yq = k / TWE - G.hy, xq = k % TWE - G.hx;
    const int y = blockIdx.y * RTH + yq, x = blockIdx.x * RTW + xq;
    if (k < A && yq >= 0 && yq < RTH && xq >= 0 && xq < RTW && y < h &&
        x < w) {
      const size_t dst = plane + (size_t)y * w + x;
      p.ofx[dst] = f[k].x;
      p.ofy[dst] = f[k].y;
    }
  }
}

template <int D_, int KB>
__global__ void __launch_bounds__(THREADS, 1)
relax_phase_kernel(Planes p, Scalars s, pano::Taps taps, int h, int w) {
  relax_body<D_, KB, false>(p, s, taps, h, w);
}

template <int D_, int KB>
__global__ void __launch_bounds__(THREADS, 1)
relax_small_kernel(Planes p, Scalars s, pano::Taps taps, int h, int w) {
  relax_body<D_, KB, true>(p, s, taps, h, w);
}

// the opt-in shared-memory limit of one block on the current device
size_t smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return (size_t)bytes;
}

// the fused variant's blur scratch (float2) against the buffers it borrows:
// the x-pass result inside the two x-pass buffers, so that staging w1 does
// not touch it, and its source on to the end of w1.  The small kernel's
// y-pass result, the * (twe + 2 * radius), is never larger: a window that
// fits has fewer rows than columns (the * twe <= 4096, twe >= 66).
bool blur_fits(const Window& g, int ksize) {
  const size_t bh = g.the + 2 * (ksize / 2);
  return bh * g.twe <= 2 * (size_t)g.nx() &&
         bh * (g.twe + 2 * (ksize / 2)) + bh * g.twe <=
             2 * (size_t)g.nx() + g.nw();
}

// a window the kernel can run: it fits a block's shared memory and the
// pixels its threads own, and it has an output row
bool fits(const Window& g) {
  return g.bytes() <= SMEM_MAX && g.pixels() <= PIX * THREADS &&
         g.the > 2 * g.hy;
}

// the small kernel's D and K that run an unrolled instance (its window
// built for SMALL_ITERS); others run the run-time one
__host__ __device__ constexpr bool small_unrolled(int D, int iters) {
  return D >= 1 && D <= 3 && iters <= SMALL_ITERS;
}

// the window a launch at D and iters uses
Window window_for(int D, int iters, bool small) {
  if (small)
    return make_window(D, small_unrolled(D, iters) ? SMALL_ITERS : iters,
                       true);
  return make_window(D, unrolled(D, iters) ? built_iters(iters) : iters);
}

template <int D, int KB, bool SMALL>
int launch(const Planes& p, Scalars s, const pano::Taps& taps, int nb, int h,
           int w, const Window& g, cudaStream_t stream) {
  void (*kernel)(Planes, Scalars, pano::Taps, int, int);
  if constexpr (SMALL)
    kernel = relax_small_kernel<D, KB>;
  else
    kernel = relax_phase_kernel<D, KB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.bytes());
  if (err != cudaSuccess) return (int)err;
  const int rth = g.the - 2 * g.hy;
  dim3 grid((w + RTW - 1) / RTW, (h + rth - 1) / rth, nb);
  kernel<<<grid, THREADS, g.bytes(), stream>>>(p, s, taps, h, w);
  return (int)cudaGetLastError();
}

template <int D, bool SMALL>
int launch_built(const Planes& p, const Scalars& s, const pano::Taps& taps,
                 int nb, int h, int w, const Window& g, cudaStream_t st) {
  switch (built_iters(s.iters)) {
    case 3: return launch<D, 3, SMALL>(p, s, taps, nb, h, w, g, st);
    case 5: return launch<D, 5, SMALL>(p, s, taps, nb, h, w, g, st);
    default: return launch<D, 7, SMALL>(p, s, taps, nb, h, w, g, st);
  }
}

template <bool SMALL>
int dispatch(const Planes& p, Scalars s, const pano::Taps& taps, int nb,
             int h, int w, int D, int ksize, cudaStream_t st) {
  if (s.iters < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const Window g = window_for(D, s.iters, SMALL);
  if (!fits(g) || (s.fuse_bf && !blur_fits(g, ksize)))
    return (int)cudaErrorInvalidValue;
  if (SMALL ? !small_unrolled(D, s.iters) : !unrolled(D, s.iters)) {
    s.d = D;
    s.kb = s.iters;
    return launch<0, 0, SMALL>(p, s, taps, nb, h, w, g, st);
  }
  constexpr int K = SMALL_ITERS;
  if constexpr (SMALL) {
    switch (D) {
      case 1: return launch<1, K, true>(p, s, taps, nb, h, w, g, st);
      case 2: return launch<2, K, true>(p, s, taps, nb, h, w, g, st);
      default: return launch<3, K, true>(p, s, taps, nb, h, w, g, st);
    }
  } else {
    switch (D) {
      case 1: return launch_built<1, false>(p, s, taps, nb, h, w, g, st);
      case 2: return launch_built<2, false>(p, s, taps, nb, h, w, g, st);
      default: return launch_built<3, false>(p, s, taps, nb, h, w, g, st);
    }
  }
}

// Shared-memory bytes a block of the relax kernel needs at iters and D, for
// the wrapper's checks: -1 when the window holds more pixels than a
// block's threads own or no output row, 0 when the fused variant's blur
// scratch does not fit the buffers it borrows.
long long relax_smem(int iters, int D, int ksize, int fuse_bf, bool small) {
  if (iters < 1 || D < 1) return -1;
  const Window g = window_for(D, iters, small);
  if (g.pixels() > PIX * THREADS || g.the <= 2 * g.hy) return -1;
  if (g.bytes() <= SMEM_MAX && fuse_bf && !blur_fits(g, ksize)) return 0;
  return (long long)g.bytes();
}

}  // namespace

// The bytes of a kernel level's launch (relax_smem).
extern "C" long long pano_relax_smem(int iters, int D, int ksize,
                                     int fuse_bf) {
  return relax_smem(iters, D, ksize, fuse_bf, false);
}

// The same for one launch of the small kernel, which runs at most
// SMALL_ITERS iterations at D <= 3 (the wrapper runs a longer phase in
// launches of that many).
extern "C" long long pano_small_relax_smem(int iters, int D, int ksize,
                                           int fuse_bf) {
  return relax_smem(iters, D, ksize, fuse_bf, true);
}

extern "C" long long pano_smem_limit() { return (long long)smem_limit(); }

extern "C" int pano_relax_phase_fused(
    const float* fx, const float* fy, const float* bx, const float* by,
    const float* w1x, const float* w1y, const float* i0x, const float* i0y,
    const float* mask, float* ofx, float* ofy, int nb, int h, int w,
    int iters, int D, const float* taps_host, int ksize, float lim,
    float smooth, float step, float vreg_w, float hreg_w, int fold,
    int w1_bf16, void* stream) {
  if (ksize < 1 || ksize > pano::MAX_TAPS) return (int)cudaErrorInvalidValue;
  const Planes p{fx,  fy,   bx,      by,      w1x, w1y, i0x,
                 i0y, mask, nullptr, nullptr, ofx, ofy};
  const Scalars s{lim, smooth, step, vreg_w, hreg_w, fold, w1_bf16, 1, iters};
  return dispatch<false>(p, s, pano::make_taps(taps_host, ksize), nb, h, w,
                         D, ksize, (cudaStream_t)stream);
}

extern "C" int pano_relax_phase_unfused(
    const float* fx, const float* fy, const float* bx, const float* by,
    const float* w1x, const float* w1y, const float* i0x, const float* i0y,
    const float* bfx, const float* bfy, const float* mask, float* ofx,
    float* ofy, int nb, int h, int w, int iters, int D, float lim,
    float smooth, float step, float vreg_w, float hreg_w, int fold,
    int w1_bf16, void* stream) {
  const Planes p{fx, fy, bx, by, w1x, w1y, i0x, i0y, mask, bfx, bfy, ofx,
                 ofy};
  const Scalars s{lim, smooth, step, vreg_w, hreg_w, fold, w1_bf16, 0, iters};
  return dispatch<false>(p, s, pano::Taps{}, nb, h, w, D, 1,
                         (cudaStream_t)stream);
}

// The small levels' variants (relax_small_kernel): vreg and hreg are the
// coefficients themselves and inv_w is float32(1.0 / w).
extern "C" int pano_small_relax_phase_fused(
    const float* fx, const float* fy, const float* bx, const float* by,
    const float* w1x, const float* w1y, const float* i0x, const float* i0y,
    const float* mask, float* ofx, float* ofy, int nb, int h, int w,
    int iters, int D, const float* taps_host, int ksize, float lim,
    float smooth, float step, float vreg, float hreg, float inv_w, int fold,
    int w1_bf16, void* stream) {
  if (ksize < 1 || ksize > pano::MAX_TAPS || h < 2 || w < 2)
    return (int)cudaErrorInvalidValue;
  const Planes p{fx,  fy,   bx,      by,      w1x, w1y, i0x,
                 i0y, mask, nullptr, nullptr, ofx, ofy};
  Scalars s{lim, smooth, step, 0.f, 0.f, fold, w1_bf16, 1, iters};
  s.vreg = vreg, s.hreg = hreg, s.inv_w = inv_w;
  return dispatch<true>(p, s, pano::make_taps(taps_host, ksize), nb, h, w, D,
                        ksize, (cudaStream_t)stream);
}

extern "C" int pano_small_relax_phase_unfused(
    const float* fx, const float* fy, const float* bx, const float* by,
    const float* w1x, const float* w1y, const float* i0x, const float* i0y,
    const float* bfx, const float* bfy, const float* mask, float* ofx,
    float* ofy, int nb, int h, int w, int iters, int D, float lim,
    float smooth, float step, float vreg, float hreg, float inv_w, int fold,
    int w1_bf16, void* stream) {
  if (h < 2 || w < 2) return (int)cudaErrorInvalidValue;
  const Planes p{fx, fy, bx, by, w1x, w1y, i0x, i0y, mask, bfx, bfy, ofx,
                 ofy};
  Scalars s{lim, smooth, step, 0.f, 0.f, fold, w1_bf16, 0, iters};
  s.vreg = vreg, s.hreg = hreg, s.inv_w = inv_w;
  return dispatch<true>(p, s, pano::Taps{}, nb, h, w, D, 1,
                        (cudaStream_t)stream);
}
