// One relaxation phase of the pixflow solver: K Jacobi iterations of
// 4-neighbour propagation + descent, in two variants (FUSE_BF):
//   fused    the blurred-flow target is computed in the kernel from f_base;
//            replaces relax_phase_pallas(..., fuse_bf=True), the
//            relaxation of every fused single-phase pyramid level;
//   unfused  the target (bfx, bfy) is an input, blurred once per level by
//            the caller; replaces relax_phase_pallas(..., fuse_bf=False),
//            each phase of multi-phase levels (relax_phases > 1) and of
//            levels with fuse_level_blurs=False.
// Both Pallas variants are _relax_phase_impl in
// panorama_opticalflow_tpu/ops/pallas/kernels.py.
//
// Contract (= ops.kernels.relax_phase_fused_plain / _unfused_plain): every
// plane is edge-padded by halo = K + D + 2 around each output tile and
// iterated on that window with edge-replicated shifts at the window
// border; the fused variant's regularisation target is the separable
// k-tap Gaussian of the edge-padded f_base, x pass first, the unfused
// variant reads bfx/bfy with the same clamped indices as every other
// plane.  Per iteration:
//   pass A  samples the bf16-quantised warped gradients w1 with a D-wide
//           separable hat window at the own offset and for the 4
//           neighbour candidates, error = data + smooth*|bf - f|
//           + vreg/w*|fy| + hreg/w*|fx|, strict-< take (left, up, right,
//           down);
//   pass B  one descent step from the analytic dhat derivative maps, at
//           pixels whose update mask is > 0.
// The output tile does not depend on the tile size: the halo covers the
// reach of K iterations.
//
// Bound on the H100: arithmetic and shared-memory bandwidth.  One phase
// reads 9 planes and writes 2 (44 bytes a pixel), but does 4 x-passes and
// ~14 y-passes of (2D+1) taps per iteration and a 15 x 15 separable blur,
// a few thousand flops a pixel.  Design: one block per (32, 64) output
// tile and flow direction; the K iterations stay in shared memory (the
// flow state, blurred target, accepted candidate and its sample, one
// derivative map and one x-pass buffer pair: 177 KB at K=3, D=2, for
// both variants), so device memory is touched once per phase as in the
// reference kernel.  The fused variant's blur scratch reuses the buffers
// that the iterations fill later; the unfused one needs none.
// The neighbour sample maps are not stored: each pixel evaluates its
// neighbours' y passes from the shared x-pass buffer.  Inputs read only
// once a pass (f_base, i0, mask, w1) are read from device memory with
// clamped indices (the reference's edge padding) and served by L1/L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int RTH = 32;
constexpr int RTW = 64;
constexpr int THREADS = 512;

struct Scalars {
  float lim, smooth, step, vreg_w, hreg_w;
  int fold, w1_bf16;
};

struct Planes {
  const float *fx, *fy, *bx, *by, *w1x, *w1y, *i0x, *i0y, *mask;
  const float *bfx, *bfy;  // the given target (unfused variant only)
  float *ofx, *ofy;
};

template <int D>
struct Relax {
  // window geometry of one block
  int h, w, halo, the, twe, xr, xw, gy0, gx0;
  size_t plane;
  Planes p;
  Scalars s;

  __device__ Relax(const Planes& p_, const Scalars& s_, int h_, int w_,
                   int iters)
      : h(h_), w(w_), p(p_), s(s_) {
    halo = iters + D + 2;
    the = RTH + 2 * halo;
    twe = RTW + 2 * halo;
    xr = the + 2 * (D + 1);
    xw = twe + 2;
    gy0 = blockIdx.y * RTH - halo;
    gx0 = blockIdx.x * RTW - halo;
    plane = (size_t)blockIdx.z * h * w;
  }

  // global value of a plane at window coords (r, c), edge-clamped
  __device__ float g(const float* a, int r, int c) const {
    const int y = pano::clampi(gy0 + r, 0, h - 1);
    const int x = pano::clampi(gx0 + c, 0, w - 1);
    return a[plane + (size_t)y * w + x];
  }

  __device__ float w1(const float* a, int r, int c) const {
    const float v = g(a, r, c);
    return s.w1_bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
  }

  // X(r,c) = sum_ox wfn(dx(r,c) - ox) * W1[r, c+ox] over rows
  // [-(D+1), the+D+1) and cols [-1, twe+1), dx edge-extended at the
  // window border; dx = clip(f(r,c) - bx(r,c)) from the window state f
  template <bool DERIV>
  __device__ void x_pass(const float* f, float* Xx, float* Xy) const {
    for (int k = threadIdx.x; k < xr * xw; k += blockDim.x) {
      const int r = k / xw - (D + 1), c = k % xw - 1;
      const int rc = pano::clampi(r, 0, the - 1);
      const int cc = pano::clampi(c, 0, twe - 1);
      const float dx =
          pano::clampf(f[rc * twe + cc] - g(p.bx, rc, cc), -s.lim, s.lim);
      float ax = 0.f, ay = 0.f;
#pragma unroll
      for (int ox = -D; ox <= D; ++ox) {
        const float wt = DERIV ? pano::dhat(dx - (float)ox)
                               : pano::hat(dx - (float)ox);
        ax = ax + wt * w1(p.w1x, r, c + ox);
        ay = ay + wt * w1(p.w1y, r, c + ox);
      }
      Xx[k] = ax;
      Xy[k] = ay;
    }
  }

  // sum_oy wfn(d - oy) * X[r + oy + ro][c + co]
  template <bool DERIV>
  __device__ float y_sum(const float* X, float d, int r, int c, int ro,
                         int co) const {
    const float* col = X + (r + ro + D + 1) * xw + c + co + 1;
    float acc = 0.f;
#pragma unroll
    for (int oy = -D; oy <= D; ++oy) {
      const float wt = DERIV ? pano::dhat(d - (float)oy)
                             : pano::hat(d - (float)oy);
      acc = acc + wt * col[oy * xw];
    }
    return acc;
  }

  __device__ float err(float sx, float sy, float cfx, float cfy, float i0x,
                       float i0y, float bfx, float bfy) const {
    const float d0 = i0x - sx, d1 = i0y - sy;
    const float data = sqrtf(d0 * d0 + d1 * d1);
    const float fdx = bfx - cfx, fdy = bfy - cfy;
    const float sm = sqrtf(fdx * fdx + fdy * fdy);
    return data + s.smooth * sm + s.vreg_w * fabsf(cfy) +
           s.hreg_w * fabsf(cfx);
  }
};

template <int D, bool FUSE_BF>
__global__ void __launch_bounds__(THREADS)
relax_phase_kernel(Planes p, Scalars s, pano::Taps taps, int h, int w,
                   int iters) {
  extern __shared__ float smem[];
  const Relax<D> R(p, s, h, w, iters);
  const int the = R.the, twe = R.twe, A = the * twe;
  const int xsz = R.xr * R.xw;
  float* fx = smem;
  float* fy = fx + A;
  float* bfx = fy + A;
  float* bfy = bfx + A;
  float* bestfx = bfy + A;
  float* bestfy = bestfx + A;
  float* bestsx = bestfy + A;
  float* bestsy = bestsx + A;
  float* gyx = bestsy + A;
  float* gyy = gyx + A;
  float* Xx = gyy + A;
  float* Xy = Xx + xsz;

  for (int k = threadIdx.x; k < A; k += blockDim.x) {
    fx[k] = R.g(p.fx, k / twe, k % twe);
    fy[k] = R.g(p.fy, k / twe, k % twe);
  }

  if constexpr (FUSE_BF) {
    // blurred-flow target over the window from the f_base planes, padded
    // by gr more; scratch lives in the not-yet-used best/gy buffers
    const int gr = taps.n / 2;
    const int bh = the + 2 * gr, bw = twe + 2 * gr;
    float* src = bestfx;         // bh x bw
    float* tmp = src + bh * bw;  // bh x twe
    for (int pl = 0; pl < 2; ++pl) {
      const float* b = pl ? p.by : p.bx;
      float* bf = pl ? bfy : bfx;
      for (int k = threadIdx.x; k < bh * bw; k += blockDim.x)
        src[k] = R.g(b, k / bw - gr, k % bw - gr);
      __syncthreads();
      for (int k = threadIdx.x; k < bh * twe; k += blockDim.x) {
        const float* row = src + (k / twe) * bw + k % twe;
        float acc = 0.f;
        for (int t = 0; t < taps.n; ++t) acc = acc + taps.v[t] * row[t];
        tmp[k] = acc;
      }
      __syncthreads();
      for (int k = threadIdx.x; k < A; k += blockDim.x) {
        const float* col = tmp + (k / twe) * twe + k % twe;
        float acc = 0.f;
        for (int t = 0; t < taps.n; ++t)
          acc = acc + taps.v[t] * col[t * twe];
        bf[k] = acc;
      }
      __syncthreads();
    }
  } else {
    // the given target, edge-clamped like every other plane
    for (int k = threadIdx.x; k < A; k += blockDim.x) {
      bfx[k] = R.g(p.bfx, k / twe, k % twe);
      bfy[k] = R.g(p.bfy, k / twe, k % twe);
    }
    __syncthreads();
  }

  for (int it = 0; it < iters; ++it) {
    // ---- pass A: propagation ----
    R.template x_pass<false>(fx, Xx, Xy);
    __syncthreads();
    for (int k = threadIdx.x; k < A; k += blockDim.x) {
      const int r = k / twe, c = k % twe;
      const float i0x = R.g(p.i0x, r, c), i0y = R.g(p.i0y, r, c);
      const float tbx = bfx[k], tby = bfy[k];
      const float dy = pano::clampf(fy[k] - R.g(p.by, r, c), -s.lim, s.lim);
      float bx_ = fx[k], by_ = fy[k];
      float sx = R.template y_sum<false>(Xx, dy, r, c, 0, 0);
      float sy = R.template y_sum<false>(Xy, dy, r, c, 0, 0);
      float be = R.err(sx, sy, bx_, by_, i0x, i0y, tbx, tby);
      // candidates: from left, up, right, down; each is the neighbour's
      // flow with the neighbour's own sample map at the +-1 offset
      const int nr[4] = {r, max(r - 1, 0), r, min(r + 1, the - 1)};
      const int nc[4] = {max(c - 1, 0), c, min(c + 1, twe - 1), c};
      const int ro[4] = {0, 1, 0, -1};
      const int co[4] = {1, 0, -1, 0};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = nr[q] * twe + nc[q];
        const float cfx = fx[n], cfy = fy[n];
        const float ndy =
            pano::clampf(cfy - R.g(p.by, nr[q], nc[q]), -s.lim, s.lim);
        const float csx =
            R.template y_sum<false>(Xx, ndy, nr[q], nc[q], ro[q], co[q]);
        const float csy =
            R.template y_sum<false>(Xy, ndy, nr[q], nc[q], ro[q], co[q]);
        const float e = R.err(csx, csy, cfx, cfy, i0x, i0y, tbx, tby);
        if (e < be) {
          be = e;
          bx_ = cfx;
          by_ = cfy;
          if (s.fold) {
            sx = csx;
            sy = csy;
          }
        }
      }
      bestfx[k] = bx_;
      bestfy[k] = by_;
      bestsx[k] = sx;
      bestsy[k] = sy;
    }
    __syncthreads();

    // ---- pass B: descent at the accepted flow ----
    R.template x_pass<false>(bestfx, Xx, Xy);
    __syncthreads();
    for (int k = threadIdx.x; k < A; k += blockDim.x) {
      const int r = k / twe, c = k % twe;
      const float dy2 =
          pano::clampf(bestfy[k] - R.g(p.by, r, c), -s.lim, s.lim);
      gyx[k] = R.template y_sum<true>(Xx, dy2, r, c, 0, 0);
      gyy[k] = R.template y_sum<true>(Xy, dy2, r, c, 0, 0);
      if (!s.fold) {
        bestsx[k] = R.template y_sum<false>(Xx, dy2, r, c, 0, 0);
        bestsy[k] = R.template y_sum<false>(Xy, dy2, r, c, 0, 0);
      }
    }
    __syncthreads();
    R.template x_pass<true>(bestfx, Xx, Xy);
    __syncthreads();
    for (int k = threadIdx.x; k < A; k += blockDim.x) {
      const int r = k / twe, c = k % twe;
      const float bfx_ = bestfx[k], bfy_ = bestfy[k];
      const float dy2 = pano::clampf(bfy_ - R.g(p.by, r, c), -s.lim, s.lim);
      const float gxx = R.template y_sum<false>(Xx, dy2, r, c, 0, 0);
      const float gxy = R.template y_sum<false>(Xy, dy2, r, c, 0, 0);
      const float d0 = R.g(p.i0x, r, c) - bestsx[k];
      const float d1 = R.g(p.i0y, r, c) - bestsy[k];
      const float q = sqrtf(d0 * d0 + d1 * d1);
      const float inv_q = q > 1e-12f ? 1.f / q : 0.f;
      const float ddx = -(d0 * gxx + d1 * gxy) * inv_q;
      const float ddy = -(d0 * gyx[k] + d1 * gyy[k]) * inv_q;
      const float fdx = bfx[k] - bfx_, fdy = bfy[k] - bfy_;
      const float sv = sqrtf(fdx * fdx + fdy * fdy);
      const float inv_s = sv > 1e-12f ? 1.f / sv : 0.f;
      const float gx = ddx + s.smooth * (-fdx * inv_s) +
                       s.hreg_w * pano::sgn(bfx_);
      const float gy = ddy + s.smooth * (-fdy * inv_s) +
                       s.vreg_w * pano::sgn(bfy_);
      if (R.g(p.mask, r, c) > 0.f) {
        fx[k] = bfx_ - s.step * gx;
        fy[k] = bfy_ - s.step * gy;
      }
    }
    __syncthreads();
  }

  for (int k = threadIdx.x; k < RTH * RTW; k += blockDim.x) {
    const int yq = k / RTW, xq = k % RTW;
    const int y = blockIdx.y * RTH + yq, x = blockIdx.x * RTW + xq;
    if (y >= h || x >= w) continue;
    const int src_k = (yq + R.halo) * twe + xq + R.halo;
    const size_t dst = R.plane + (size_t)y * w + x;
    p.ofx[dst] = fx[src_k];
    p.ofy[dst] = fy[src_k];
  }
}

// shared-memory bytes of one block, or 0 when the fused variant's blur
// scratch does not fit the buffers it borrows
size_t relax_smem(int iters, int D, int ksize, bool fuse_bf) {
  const int halo = iters + D + 2, gr = ksize / 2;
  const size_t the = RTH + 2 * halo, twe = RTW + 2 * halo;
  const size_t A = the * twe;
  const size_t X = (the + 2 * (D + 1)) * (twe + 2);
  const size_t blur = (the + 2 * gr) * (twe + 2 * gr) + (the + 2 * gr) * twe;
  if (fuse_bf && blur > 6 * A) return 0;  // must fit the 6 spare buffers
  return (10 * A + 2 * X) * sizeof(float);
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

template <int D, bool FUSE_BF>
int launch(const Planes& p, const Scalars& s, const pano::Taps& taps, int nb,
           int h, int w, int iters, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      relax_phase_kernel<D, FUSE_BF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((w + RTW - 1) / RTW, (h + RTH - 1) / RTH, nb);
  relax_phase_kernel<D, FUSE_BF><<<grid, THREADS, smem, stream>>>(
      p, s, taps, h, w, iters);
  return (int)cudaGetLastError();
}

template <bool FUSE_BF>
int dispatch(const Planes& p, const Scalars& s, const pano::Taps& taps,
             int nb, int h, int w, int iters, int D, int ksize,
             cudaStream_t st) {
  if (iters < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = relax_smem(iters, D, ksize, FUSE_BF);
  if (smem == 0 || smem > smem_limit()) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 1: return launch<1, FUSE_BF>(p, s, taps, nb, h, w, iters, smem, st);
    case 2: return launch<2, FUSE_BF>(p, s, taps, nb, h, w, iters, smem, st);
    case 3: return launch<3, FUSE_BF>(p, s, taps, nb, h, w, iters, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// shared-memory bytes a block of the relax kernel needs (0: refused) and
// the most the current device allows, for the wrapper's error message
extern "C" long long pano_relax_smem(int iters, int D, int ksize,
                                     int fuse_bf) {
  return (long long)relax_smem(iters, D, ksize, fuse_bf != 0);
}

extern "C" long long pano_smem_limit() { return (long long)smem_limit(); }

extern "C" int pano_relax_phase_fused(
    const float* fx, const float* fy, const float* bx, const float* by,
    const float* w1x, const float* w1y, const float* i0x, const float* i0y,
    const float* mask, float* ofx, float* ofy, int nb, int h, int w,
    int iters, int D, const float* taps_host, int ksize, float lim,
    float smooth, float step, float vreg_w, float hreg_w, int fold,
    int w1_bf16, void* stream) {
  if (ksize < 1 || ksize > 31 || ksize % 2 == 0)
    return (int)cudaErrorInvalidValue;
  const Planes p{fx,  fy,   bx,      by,      w1x, w1y, i0x,
                 i0y, mask, nullptr, nullptr, ofx, ofy};
  const Scalars s{lim, smooth, step, vreg_w, hreg_w, fold, w1_bf16};
  return dispatch<true>(p, s, pano::make_taps(taps_host, ksize), nb, h, w,
                        iters, D, ksize, (cudaStream_t)stream);
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
  const Scalars s{lim, smooth, step, vreg_w, hreg_w, fold, w1_bf16};
  return dispatch<false>(p, s, pano::Taps{}, nb, h, w, iters, D, 1,
                         (cudaStream_t)stream);
}
