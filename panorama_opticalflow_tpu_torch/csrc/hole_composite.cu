// The final composite of a pair in one pass: each pixel's source by its
// code, and for the overlap holes the reference's eight-ray search for the
// nearest pure-L or pure-R pixel.
//
// No TPU kernel: the JAX package composites with XLA ops
// (models/stitcher.py).  The kernel was added because on the card the plain
// version (ops.kernels.hole_composite_plain: ops.distance.
// two_class_hole_search, an int16 doubling field of 8 rays x 7 passes at
// radius 100, four full-plane ops a pass, and the four selects) is ~270
// PyTorch kernels a call that move ~13 GB at a 4000 x 3584 window, where
// the stage needs ~13 bytes a pixel.
//
// Contract (= ops.kernels.hole_composite_plain on CUDA tensors, bit for
// bit).  A pixel's code is (uint8)(map + 75 (merged alpha > 0)); code 100
// takes L, 50 takes R, 225, 175 and 125 the merged view, 150 (an overlap
// hole) the fill the search gives, any other code 0.  The search runs on
// the window's columns (roll + [0, width)) mod W, the whole canvas where
// there is no window (roll 0, width W); a hole outside the window is 0.
// From a hole at window column p of row y each of the eight unit rays
// visits j = 1, 2, ... while j < radius and stops at the window's and the
// canvas's edges; its hit is the first pixel of code 100 (value 2 j) or
// code 50 (2 j + 1), and the least value over the rays wins (so L wins a
// tie).  The reference's boundary rule hides window column 0 from the rays
// with dx < 0 and row 0 from those with dy < 0.  A value below 2 radius
// fills with L where even and R where odd, else opaque black (0, 0, 0,
// 255).  Each canvas of a stack is composited alone.
//
// Bound on the H100: device-memory bytes, 9 a pixel (the map byte, the
// merged pixel read, the output written) and 4 more where a source pixel
// is taken; the walks' reads of their neighbours' codes hit the caches.
// Design: one thread a pixel, a block 256 pixels of one row, so a warp's
// loads and stores are contiguous.  A warp with holes searches them: with
// at most WARP_WALK_MAX holes one hole at a time, its 32 lanes testing 32
// steps of a ray at once (a ballot finds the first hit), so a lone hole
// costs at most 8 x 4 rounds of loads, not 8 x 99 dependent steps; with
// more, each hole's lane walks its own rays.  A ray stops at its first hit
// and at the best value found so far (a later hit cannot win), and the
// code a walk reads is made from its two bytes in place: no plane of
// codes, distances or masks, no atomics, and the work grows with the
// holes, not with the canvas.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned char CODE_L = 100;
constexpr unsigned char CODE_R = 50;
constexpr unsigned char CODE_HOLE = 150;
constexpr unsigned char MERGED_CODE = 75;  // added where the merged view is
// a warp with more holes than this walks them a lane each, else the warp
// walks them one by one, 32 steps of a ray at a time (on an H100, 4 kept
// the lane walk's time at 40 % holes and halved it at 0.2 %; 16 and 32
// tripled and quadrupled it at 40 %)
constexpr int WARP_WALK_MAX = 4;

struct Args {
  const unsigned char* map;  // (N, H, W)
  const uchar4* img_l;       // (N, H, W) RGBA
  const uchar4* img_r;
  const uchar4* merged;
  uchar4* out;
  const long long* roll_ptr;  // the window's roll on the card, or null
  long long roll;             // the roll where roll_ptr is null
  int h, w, width, radius;
};

// one canvas of the stack: its map and its merged view's bytes
struct Plane {
  const unsigned char* map;
  const unsigned char* merged;
};

__device__ __forceinline__ unsigned char code_of(unsigned char map,
                                                 unsigned char alpha) {
  return (unsigned char)(map + (alpha > 0 ? MERGED_CODE : 0));
}

// the code at window column p of row y
__device__ __forceinline__ unsigned char code_at(const Args& a, Plane c,
                                                 int y, int p, int roll) {
  int x = p + roll;
  if (x >= a.w) x -= a.w;
  const long long i = (long long)y * a.w + x;
  return code_of(c.map[i], c.merged[4 * i + 3]);
}

// the steps a ray from window column p of row y may take: j < radius, a
// hit at j can win only where 2 j < best, the ray stops at the window's
// and the canvas's edges, and window column 0 and row 0 are hidden from
// the rays towards them
template <int DY, int DX>
__device__ __forceinline__ int ray_steps(const Args& a, int y, int p,
                                         int best) {
  int n = min(a.radius - 1, (best - 1) >> 1);
  if (DX > 0) n = min(n, a.width - 1 - p);
  if (DX < 0) n = min(n, p - 1);
  if (DY > 0) n = min(n, a.h - 1 - y);
  if (DY < 0) n = min(n, y - 1);
  return n;
}

// one lane walks one ray: the least value 2 j + class, or `best` where the
// ray finds nothing below it
template <int DY, int DX>
__device__ __forceinline__ int lane_walk(const Args& a, Plane c, int y,
                                         int p, int roll, int best) {
  const int n = ray_steps<DY, DX>(a, y, p, best);
  for (int j = 1; j <= n; ++j) {
    const unsigned char code = code_at(a, c, y + j * DY, p + j * DX, roll);
    if (code == CODE_L) return 2 * j;
    if (code == CODE_R) return min(best, 2 * j + 1);
  }
  return best;
}

// the warp walks one ray of one hole (y, p the same in every lane), lane
// l testing step j0 + l; the first hit is the lowest lane that has one
template <int DY, int DX>
__device__ __forceinline__ int warp_walk(const Args& a, Plane c, int y,
                                         int p, int roll, int best,
                                         int lane) {
  const int n = ray_steps<DY, DX>(a, y, p, best);
  for (int j0 = 1; j0 <= n; j0 += 32) {
    const int j = j0 + lane;
    int hit = 0;
    if (j <= n) {
      const unsigned char code = code_at(a, c, y + j * DY, p + j * DX, roll);
      hit = code == CODE_L ? 1 : (code == CODE_R ? 2 : 0);
    }
    const unsigned found = __ballot_sync(FULL, hit != 0);
    if (found) {
      const int first = __ffs(found) - 1;
      const int jf = j0 + first;
      return __shfl_sync(FULL, hit, first) == 1 ? 2 * jf
                                                : min(best, 2 * jf + 1);
    }
  }
  return best;
}

// the eight rays of a hole, by one lane or by the warp
template <bool WARP>
__device__ __forceinline__ int search(const Args& a, Plane c, int y, int p,
                                      int roll, int lane) {
  int b = 2 * a.radius;
#define PANO_RAY(DY, DX)                                           \
  b = WARP ? warp_walk<DY, DX>(a, c, y, p, roll, b, lane)          \
           : lane_walk<DY, DX>(a, c, y, p, roll, b)
  PANO_RAY(0, 1);
  PANO_RAY(0, -1);
  PANO_RAY(1, 0);
  PANO_RAY(-1, 0);
  PANO_RAY(1, 1);
  PANO_RAY(-1, -1);
  PANO_RAY(1, -1);
  PANO_RAY(-1, 1);
#undef PANO_RAY
  return b;
}

__global__ void __launch_bounds__(THREADS) hole_composite_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.x * THREADS + threadIdx.x;
  const bool in_row = x < a.w;  // every lane stays for the warp's walks
  const long long plane = (long long)a.h * a.w;
  const long long base = blockIdx.z * plane;
  const Plane c{a.map + base,
                reinterpret_cast<const unsigned char*>(a.merged + base)};
  long long roll = (a.roll_ptr ? *a.roll_ptr : a.roll) % a.w;
  if (roll < 0) roll += a.w;
  int p = x - (int)roll;  // the window column
  if (p < 0) p += a.w;
  for (int y = blockIdx.y; y < a.h; y += gridDim.y) {
    const long long i = base + (long long)y * a.w + x;
    uchar4 m = make_uchar4(0, 0, 0, 0);
    unsigned char code = 0;
    if (in_row) {
      m = a.merged[i];
      code = code_of(c.map[i - base], m.w);
    }
    const bool hole = in_row && code == CODE_HOLE && p < a.width;
    unsigned holes = __ballot_sync(FULL, hole);
    int best = 0;
    if (__popc(holes) > WARP_WALK_MAX) {
      if (hole) best = search<false>(a, c, y, p, (int)roll, lane);
    } else {
      while (holes) {
        const int src = __ffs(holes) - 1;
        holes &= holes - 1;
        const int b = search<true>(a, c, y, __shfl_sync(FULL, p, src),
                                   (int)roll, lane);
        if (lane == src) best = b;
      }
    }
    if (!in_row) continue;
    uchar4 v = make_uchar4(0, 0, 0, 0);
    if (code == CODE_L) {
      v = a.img_l[i];
    } else if (code == CODE_R) {
      v = a.img_r[i];
    } else if (code == 225 || code == 175 || code == 125) {
      v = m;
    } else if (hole) {
      if (best < 2 * a.radius)
        v = (best & 1) ? a.img_r[i] : a.img_l[i];
      else
        v = make_uchar4(0, 0, 0, 255);
    }
    a.out[i] = v;
  }
}

}  // namespace

extern "C" int pano_hole_composite(const void* map, const void* img_l,
                                   const void* img_r, const void* merged,
                                   void* out, int nb, int h, int w,
                                   const long long* roll_ptr, long long roll,
                                   int width, int radius, void* stream) {
  if (nb < 1 || nb > 65535 || h < 1 || w < 1 || width < 1 || width > w ||
      radius < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const unsigned char*>(map),
               static_cast<const uchar4*>(img_l),
               static_cast<const uchar4*>(img_r),
               static_cast<const uchar4*>(merged),
               static_cast<uchar4*>(out),
               roll_ptr,
               roll,
               h,
               w,
               width,
               radius};
  const dim3 grid((unsigned)((w + THREADS - 1) / THREADS),
                  (unsigned)(h < 65535 ? h : 65535), nb);
  hole_composite_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
