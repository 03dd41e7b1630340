// The blend field's eight-ray distances of both classes of a canvas map in
// one pass: for each pixel, the strided first-hit distance along the eight
// rays to a pure-L pixel (code 100) and to a pure-R pixel (code 50).
//
// No TPU kernel: the JAX package searches with XLA scans (ops/distance.py).
// The kernel was added because on the card the plain version
// (ops.kernels.blend_distances_plain: two ops.distance.eight_ray_min_distance
// calls, each eight scans built from where, cummin/cummax, flips, zero-pad
// cats, stride reshapes and, for the diagonals, a shear onto an H x (W+H-1)
// plane) is ~276 PyTorch kernels a pair that move ~42 GB at a 4000 x 3584
// window, for 0.13 GB of work.
//
// Contract (= ops.kernels.blend_distances_plain on CUDA tensors, bit for
// bit).  A ray from (y, x) along (dy, dx) visits offsets i = 0, step,
// 2 step, ... until it leaves the map (diagonals do not wrap); its distance
// is the first i whose pixel is a candidate of the class, kept only where
// float32(i) < float32(max_i) (the plain ops compare with the scalar
// rounded to float32), else +inf.  A straight ray measures float32(i), a
// diagonal one float32(i) * float32(sqrt 2), one rounded product, after the
// cut.  A pixel's distance is the least of its eight rays' (a min is exact
// in any order).  Candidates the reference's boundary rule hides:
//   -x: column 0;  -y: row 0;  (-y, -x): row 0 or column 0;
//   (+y, -x): column 0;  (-y, +x): row 0;  +x, +y, (+y, +x): none.
// Each map of a stack is searched alone.
//
// Bound on the H100: device-memory bytes, 9 a pixel (the map's byte read
// once, two float32 distances written), against a few dozen integer
// operations.  Design: the eight rays are four families of lines (rows,
// columns, the two diagonals), and a ray of stride `step` stays in one
// residue class of its line, so each family is a set of independent chains
// (a line's pixels of one residue mod step).  One thread walks one chain:
// backwards carrying each class's nearest candidate at or after (the
// forward ray), then forwards carrying the nearest at or before (the
// reverse ray); one byte read gives both classes.  Neighbouring threads
// take neighbouring residues of a row, or neighbouring columns and
// diagonals at the same rows, so a warp's loads and stores share sectors.
// The families meet in the outputs by atomicMin on the int32 bits of the
// non-negative float32 distances (their order), from the wrapper's +inf
// fill: no chain is stored and no intermediate plane exists.  A write that
// cannot lower the value (+inf, or a reverse ray of a forward candidate)
// is left out.  Grid: (chains / THREADS, 4 families, N); no shared memory,
// so every shape the plain version takes runs.  Only the output columns
// [x0, x0 + wout) are written (the wrap-extended canvas's crop).  On an
// H100 it runs at ~5 % of the bytes bound, at the same cost a pixel whether
// the planes fit the L2 or not, and batching the loads gained nothing: the
// up to 16 atomic updates a pixel (4 families, 2 walks, 2 classes) set its
// pace.
#include <algorithm>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned char CODE_L = 100;
constexpr unsigned char CODE_R = 50;
constexpr int FAMILIES = 4;  // rows, columns, (+y, +x) and (+y, -x) lines

struct Args {
  const unsigned char* codes;  // (N, H, W) at strides cn, ch, cw
  float* out_l;                // (N, H, wout), +inf filled
  float* out_r;
  long long cn, ch, cw;
  int h, w, step, x0, wout;
  float max_i;  // float32(max_i)
  float diag;   // float32(sqrt 2)
};

// One chain: its first pixel, the pixel step between its entries, its length
struct Chain {
  int y, x, dy, dx, len;
};

__device__ __forceinline__ int first_at_or_after(int lo, int r, int step) {
  return lo + ((r - lo) % step + step) % step;
}

// chain t of family f, or len 0 where t names none
__device__ __forceinline__ Chain chain_of(const Args& a, int f,
                                          long long t) {
  Chain c{0, 0, 0, 0, 0};
  const int s = a.step;
  if (f == 0) {  // row y, residue r of x
    const int se = min(s, a.w);
    const long long y = t / se;
    const int r = (int)(t % se);
    if (y >= a.h) return c;
    c = {(int)y, r, 0, s, (a.w - r + s - 1) / s};
    return c;
  }
  const int se = min(s, a.h);
  if (f == 1) {  // column x, residue r of y
    const long long r = t / a.w;
    if (r >= se) return c;
    c = {(int)r, (int)(t % a.w), s, 0, (a.h - (int)r + s - 1) / s};
    return c;
  }
  // diagonal line c of W + H - 1: x - y + H - 1 (f == 2) or x + y (f == 3),
  // residue r of y
  const int lines = a.w + a.h - 1;
  const long long r = t / lines;
  if (r >= se) return c;
  const int line = (int)(t % lines);
  int ylo, yhi;
  if (f == 2) {
    ylo = max(0, a.h - 1 - line);
    yhi = min(a.h - 1, a.w + a.h - 2 - line);
  } else {
    ylo = max(0, line - (a.w - 1));
    yhi = min(a.h - 1, line);
  }
  const int y0 = first_at_or_after(ylo, (int)r, s);
  if (y0 > yhi) return c;
  c.y = y0;
  c.x = f == 2 ? y0 + line - (a.h - 1) : line - y0;
  c.dy = s;
  c.dx = f == 2 ? s : -s;
  c.len = (yhi - y0) / s + 1;
  return c;
}

// the boundary rule: is a candidate at (y, x) hidden from the family's
// forward ray (its chain's direction) or from its reverse ray?
__device__ __forceinline__ bool hidden_forward(int f, int x) {
  return f == 3 && x == 0;
}

__device__ __forceinline__ bool hidden_reverse(int f, int y, int x) {
  switch (f) {
    case 0: return x == 0;
    case 1: return y == 0;
    case 2: return y == 0 || x == 0;
    default: return y == 0;
  }
}

// lower out[i] to the distance of `steps` ray steps, where it is kept
__device__ __forceinline__ void lower(float* out, long long i, int steps,
                                      int f, const Args& a) {
  float v = (float)(steps * a.step);
  if (!(v < a.max_i)) return;
  if (f >= 2) v = v * a.diag;
  atomicMin(reinterpret_cast<int*>(out) + i, __float_as_int(v));
}

__global__ void __launch_bounds__(THREADS) eight_ray_kernel(Args a) {
  const int f = blockIdx.y, n = blockIdx.z;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const Chain c = chain_of(a, f, t);
  if (c.len == 0) return;
  const unsigned char* codes = a.codes + n * a.cn;
  const long long plane = (long long)a.h * a.wout;
  float* out_l = a.out_l + n * plane;
  float* out_r = a.out_r + n * plane;

  // backwards: the nearest candidate at or after, for the forward ray
  int next_l = -1, next_r = -1;
  for (int k = c.len - 1; k >= 0; --k) {
    const int y = c.y + k * c.dy, x = c.x + k * c.dx;
    const unsigned char code = codes[y * a.ch + x * a.cw];
    if (!hidden_forward(f, x)) {
      if (code == CODE_L) next_l = k;
      if (code == CODE_R) next_r = k;
    }
    const int xo = x - a.x0;
    if (xo < 0 || xo >= a.wout) continue;
    const long long i = (long long)y * a.wout + xo;
    if (next_l >= 0) lower(out_l, i, next_l - k, f, a);
    if (next_r >= 0) lower(out_r, i, next_r - k, f, a);
  }
  // forwards: the nearest candidate at or before, for the reverse ray; a
  // forward candidate's own pixel already holds 0
  int last_l = -1, last_r = -1;
  for (int k = 0; k < c.len; ++k) {
    const int y = c.y + k * c.dy, x = c.x + k * c.dx;
    const unsigned char code = codes[y * a.ch + x * a.cw];
    const bool rev = !hidden_reverse(f, y, x);
    const bool fwd = !hidden_forward(f, x);
    if (rev && code == CODE_L) last_l = k;
    if (rev && code == CODE_R) last_r = k;
    const int xo = x - a.x0;
    if (xo < 0 || xo >= a.wout) continue;
    const long long i = (long long)y * a.wout + xo;
    if (last_l >= 0 && !(fwd && code == CODE_L))
      lower(out_l, i, k - last_l, f, a);
    if (last_r >= 0 && !(fwd && code == CODE_R))
      lower(out_r, i, k - last_r, f, a);
  }
}

}  // namespace

extern "C" int pano_eight_ray(const void* codes, float* out_l, float* out_r,
                              int nb, int h, int w, long long cn,
                              long long ch, long long cw, int step, int x0,
                              int wout, float max_i, float diag,
                              void* stream) {
  if (nb < 1 || nb > 65535 || h < 1 || w < 1 || step < 1 || x0 < 0 ||
      wout < 1 || x0 + wout > w)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const unsigned char*>(codes),
               out_l,
               out_r,
               cn,
               ch,
               cw,
               h,
               w,
               step,
               x0,
               wout,
               max_i,
               diag};
  const long long rows = (long long)h * std::min(step, w);
  const long long cols = (long long)w * std::min(step, h);
  const long long diags = (long long)(w + h - 1) * std::min(step, h);
  const long long most = std::max({rows, cols, diags});
  const dim3 grid((unsigned)((most + THREADS - 1) / THREADS), FAMILIES, nb);
  eight_ray_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
