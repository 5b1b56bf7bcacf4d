// Hopper kernels for the ECC hot loop of the phase-1 frame program.
//
// Five kernels, each the counterpart of one Pallas TPU kernel in
// upsp_tpu/ops/pallas_ecc.py:
//
//   K1 blur         <- _blur_kernel via _blur_batched / make_blur
//   K2 warp         <- _warp_kernel via _warp_banded_batched /
//                      warp_affine_banded
//   K3 GN moments   <- _moments_kernel via _moments_batched / ecc_gn_moments
//   K4 warp+filter  <- _warp_filter_kernel via _warp_filter_batched /
//                      make_warp_filter
//   K6 hot pixels   <- _hot_kernel via _hot_batched / fix_hot_pixels_pallas
//                      (count pass + repair pass, below)
//
// What bounds them on the H100: all four are memory-bound.  Per pixel they
// move 8 bytes (K1, K2: one f32 read, one f32 write), 8 bytes (K3: the
// warped image and the template) or 8-12 bytes (K4: one read, one or two
// writes), against 3.35 TB/s of HBM; the arithmetic (at most ~150 flops a
// pixel in K3) stays far under the card's f32 rate.  So the design goal is
// one HBM pass per image and coalesced rows:
//
//   - K1, K2 and K4 work on 32x32 output tiles with their halo staged in
//     shared memory, so every input pixel is read from HBM once per tile
//     and the separable passes run out of shared memory.
//   - K2 and K4 sample their two tent taps per axis directly at the
//     separable positions, so there is no band limit (the TPU kernel reads
//     static row shifts within +-3 px; here any displacement is exact, and
//     inside the band the result equals the TPU kernel's).
//   - K3 accumulates the 42 statistics of a 4-row strip in registers, then
//     reduces the block in f64 with warp shuffles and writes one partial
//     per block.  A second small kernel sums the partials in a fixed order
//     in f64: no float atomics, so the statistics (and with them the ECC
//     telemetry and the intensities) are the same from run to run.
//
// The plain PyTorch twins of all four live beside the wrappers in
// upsp_tpu_torch/ops/ecc_kernels.py and define the semantics.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libupsp_ecc.so ecc.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_X = 32;
constexpr int TILE_Y = 32;
constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;
constexpr int NTHREADS = BLOCK_X * BLOCK_Y;
constexpr int MAX_R = 3;  // taps <= 7

// shared-memory pitches for the largest halo (+1 breaks bank conflicts)
constexpr int SEP_P = TILE_X + 2 * MAX_R + 2 + 1;  // sep tile (+1 px ring)
constexpr int SEP_ROWS = TILE_Y + 2 * MAX_R + 2;
constexpr int WRP_P = TILE_X + 2 * MAX_R + 1;  // warped/blur input tile
constexpr int WRP_ROWS = TILE_Y + 2 * MAX_R;

constexpr int MOM_ROWS = 4;  // image rows per moments block
constexpr int MOM_THREADS = 256;
constexpr int NSTAT = 42;

struct Taps {
  float t[7];
  int k;
};

struct WarpP {
  float a00, a01, tx, a10, a11, ty;
};

__device__ __forceinline__ WarpP load_warp(const float* __restrict__ w,
                                           int b) {
  const float* p = w + 6 * b;
  WarpP q;
  q.a00 = p[0];
  q.a01 = p[1];
  q.tx = p[2];
  q.a10 = p[3];
  q.a11 = p[4];
  q.ty = p[5];
  return q;
}

// a * v + b + c * d with every product and sum rounded separately: the
// sample positions must not depend on FMA contraction, because a sample
// that straddles the zero border changes by the full pixel value per pixel
// of position (the plain twin rounds each operation the same way)
__device__ __forceinline__ float affine_pos(float a, float v, float b,
                                            float c, float d) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, v), b), __fmul_rn(c, d));
}

// BORDER_REFLECT_101 index (valid while the radius is below n)
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) return -i;
  if (i >= n) return 2 * (n - 1) - i;
  return i;
}

// Separable resample at source position (ys, xs): the tent taps
// floor(p), floor(p)+1 per axis, rows first, zero outside the image
// (BORDER_CONSTANT) -- R @ img @ C^T of ops/warp.py, one entry.
__device__ __forceinline__ float sep_value(const float* __restrict__ img,
                                           int H, int W, float ys,
                                           float xs) {
  if (!(ys > -1.f && ys < (float)H && xs > -1.f && xs < (float)W)) {
    return 0.f;  // both taps of one axis outside the image (or NaN)
  }
  const float y0f = floorf(ys);
  const float x0f = floorf(xs);
  const int y0 = (int)y0f;
  const int x0 = (int)x0f;
  const float wy1 = ys - y0f;
  const float wy0 = 1.f - wy1;
  const float wx1 = xs - x0f;
  const float wx0 = 1.f - wx1;
  const bool vy0 = y0 >= 0;
  const bool vy1 = y0 + 1 < H;
  const bool vx0 = x0 >= 0;
  const bool vx1 = x0 + 1 < W;
  float t0 = 0.f, t1 = 0.f;
  if (vx0) {
    if (vy0) t0 = wy0 * __ldg(img + (size_t)y0 * W + x0);
    if (vy1) t0 += wy1 * __ldg(img + (size_t)(y0 + 1) * W + x0);
  }
  if (vx1) {
    if (vy0) t1 = wy0 * __ldg(img + (size_t)y0 * W + x0 + 1);
    if (vy1) t1 += wy1 * __ldg(img + (size_t)(y0 + 1) * W + x0 + 1);
  }
  float out = 0.f;
  if (vx0) out = wx0 * t0;
  if (vx1) out += wx1 * t1;
  return out;
}

// The order-2 shear Taylor correction at image pixel (r, c) from the 3x3
// neighbourhood of the separable image centred at s[0] (row pitch p).
// Derivatives are zero on the outer ring: gx/gxx at columns 0 and W-1,
// gy/gyy at rows 0 and H-1, gxy on the whole ring (ops/warp.py:170-197).
__device__ __forceinline__ float taylor(const float* s, int p, int r, int c,
                                        const WarpP& w, int H, int W) {
  const float cy = (H - 1) * 0.5f;
  const float cx = (W - 1) * 0.5f;
  const float inv_ax = 1.f / w.a00;
  const float inv_ay = 1.f / w.a11;
  const float v = s[0];
  const bool ex = (c > 0) && (c < W - 1);
  const bool ey = (r > 0) && (r < H - 1);
  float gx = 0.f, gxx = 0.f, gy = 0.f, gyy = 0.f, gxy = 0.f;
  if (ex) {
    const float rt = s[1], lf = s[-1];
    gx = 0.5f * (rt - lf) * inv_ax;
    gxx = (rt - 2.f * v + lf) * inv_ax * inv_ax;
  }
  if (ey) {
    const float dn = s[p], up = s[-p];
    gy = 0.5f * (dn - up) * inv_ay;
    gyy = (dn - 2.f * v + up) * inv_ay * inv_ay;
  }
  if (ex && ey) {
    gxy = 0.25f * (s[p + 1] - s[p - 1] - s[-p + 1] + s[-p - 1]) * inv_ax *
          inv_ay;
  }
  const float dx = w.a01 * ((float)r - cy);  // row-varying x displacement
  const float dy = w.a10 * ((float)c - cx);  // column-varying y displacement
  float out = v + dx * gx + dy * gy;
  out = out + 0.5f * dx * dx * gxx + dx * dy * gxy + 0.5f * dy * dy * gyy;
  return out;
}

// Fill a shared tile with the separable image over rows [r0, r0+ny) and
// columns [c0, c0+nx) (any integers: outside the image it is still the
// BORDER_CONSTANT resample).
__device__ __forceinline__ void fill_sep(float* sep, int pitch, int r0,
                                         int c0, int ny, int nx,
                                         const float* __restrict__ img,
                                         int H, int W, const WarpP& w) {
  const float cy = (H - 1) * 0.5f;
  const float cx = (W - 1) * 0.5f;
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  for (int i = tid; i < ny * nx; i += NTHREADS) {
    const int ly = i / nx;
    const int lx = i - ly * nx;
    const int r = r0 + ly;
    const int c = c0 + lx;
    // separable sample positions, residual shear centred on the image
    const float ys = affine_pos(w.a11, (float)r, w.ty, w.a10, cx);
    const float xs = affine_pos(w.a00, (float)c, w.tx, w.a01, cy);
    sep[ly * pitch + lx] = sep_value(img, H, W, ys, xs);
  }
}

// Separable filter of a staged (TILE_Y+2r) x (TILE_X+2r) tile: vertical
// pass into `vbuf`, then the horizontal pass straight to `out`.
__device__ __forceinline__ void filter_tile(const float* src, float* vbuf,
                                            const Taps& taps, int ty0,
                                            int tx0, int H, int W,
                                            float* __restrict__ out) {
  const int r = taps.k / 2;
  const int nx = TILE_X + 2 * r;
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  for (int i = tid; i < TILE_Y * nx; i += NTHREADS) {
    const int ly = i / nx;
    const int lx = i - ly * nx;
    float acc = 0.f;
    for (int j = 0; j < taps.k; ++j) {
      acc += taps.t[j] * src[(ly + j) * WRP_P + lx];
    }
    vbuf[ly * WRP_P + lx] = acc;
  }
  __syncthreads();
  for (int ly = threadIdx.y; ly < TILE_Y; ly += BLOCK_Y) {
    const int lx = threadIdx.x;
    const int y = ty0 + ly;
    const int x = tx0 + lx;
    if (y < H && x < W) {
      float acc = 0.f;
      for (int j = 0; j < taps.k; ++j) {
        acc += taps.t[j] * vbuf[ly * WRP_P + lx + j];
      }
      out[(size_t)y * W + x] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// K1: separable reflect-101 blur, <= 7 taps.
// Replaces _blur_kernel (pallas_ecc.py:779, via _blur_batched :829).
// Bound: 8 B/pixel of HBM traffic.  Design: a 32x32 tile plus its r-pixel
// reflected halo is read once into shared memory; both passes run there.

__global__ void __launch_bounds__(NTHREADS)
blur_kernel(const float* __restrict__ in, float* __restrict__ out, int H,
            int W, Taps taps) {
  __shared__ float tile[WRP_ROWS * WRP_P];
  __shared__ float vbuf[TILE_Y * WRP_P];
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TILE_Y;
  const int tx0 = blockIdx.x * TILE_X;
  const float* img = in + (size_t)b * H * W;
  const int r = taps.k / 2;
  const int ny = TILE_Y + 2 * r;
  const int nx = TILE_X + 2 * r;
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  for (int i = tid; i < ny * nx; i += NTHREADS) {
    const int ly = i / nx;
    const int lx = i - ly * nx;
    const int y = ty0 - r + ly;
    const int x = tx0 - r + lx;
    float v = 0.f;
    // rows/columns past the last tile's ragged edge are never read by a
    // written output; everything else mirrors reflect-101
    if (y < H + r && x < W + r) {
      v = __ldg(img + (size_t)reflect101(y, H) * W + reflect101(x, W));
    }
    tile[ly * WRP_P + lx] = v;
  }
  __syncthreads();
  filter_tile(tile, vbuf, taps, ty0, tx0, H, W, out + (size_t)b * H * W);
}

// ---------------------------------------------------------------------------
// K2: out(y, x) = img(W @ [x, y, 1]), separable tent resample + order-2
// shear Taylor correction, zero outside the image.
// Replaces _warp_kernel (pallas_ecc.py:253, via _warp_banded_batched :285).
// Bound: 8 B/pixel; the four tap reads per separable sample hit L1/L2
// (neighbouring threads read neighbouring pixels).  Design: the separable
// image of the tile and a 1-pixel ring is computed once into shared
// memory, so the Taylor term's 3x3 differences cost no further samples.

__global__ void __launch_bounds__(NTHREADS)
warp_kernel(const float* __restrict__ in, const float* __restrict__ warps,
            float* __restrict__ out, int H, int W) {
  __shared__ float sep[(TILE_Y + 2) * SEP_P];
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TILE_Y;
  const int tx0 = blockIdx.x * TILE_X;
  const float* img = in + (size_t)b * H * W;
  const WarpP w = load_warp(warps, b);
  fill_sep(sep, SEP_P, ty0 - 1, tx0 - 1, TILE_Y + 2, TILE_X + 2, img, H, W,
           w);
  __syncthreads();
  float* o = out + (size_t)b * H * W;
  for (int ly = threadIdx.y; ly < TILE_Y; ly += BLOCK_Y) {
    const int lx = threadIdx.x;
    const int y = ty0 + ly;
    const int x = tx0 + lx;
    if (y < H && x < W) {
      o[(size_t)y * W + x] =
          taylor(sep + (ly + 1) * SEP_P + lx + 1, SEP_P, y, x, w, H, W);
    }
  }
}

// ---------------------------------------------------------------------------
// K4: K2 then K1's reflect-101 filter of the WARPED image, one pass; the
// optional second output is the pre-filter warped image.
// Replaces _warp_filter_kernel (pallas_ecc.py:367, via _warp_filter_batched
// :444).  Bound: 8 B/pixel (12 with the warped output).  Design: three
// shared-memory stages per tile -- separable image, warped image with the
// filter halo, vertical pass -- so the warped image never goes to HBM
// unless asked for.

__global__ void __launch_bounds__(NTHREADS)
warp_filter_kernel(const float* __restrict__ in,
                   const float* __restrict__ warps, float* __restrict__ out,
                   float* __restrict__ warped_out, int H, int W, Taps taps) {
  __shared__ float sep[SEP_ROWS * SEP_P];
  __shared__ float wrp[WRP_ROWS * WRP_P];
  __shared__ float vbuf[TILE_Y * WRP_P];
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TILE_Y;
  const int tx0 = blockIdx.x * TILE_X;
  const float* img = in + (size_t)b * H * W;
  const WarpP w = load_warp(warps, b);
  const int r = taps.k / 2;

  // separable image over rows [ty0-r-1, ty0+TILE_Y+r+1): covers the 3x3
  // Taylor neighbourhood of every warped pixel the filter halo needs,
  // including the reflected ones at the image edges (a reflected halo row
  // lies within r rows of the edge, so its neighbours are in this range)
  const int sr0 = ty0 - r - 1;
  const int sc0 = tx0 - r - 1;
  fill_sep(sep, SEP_P, sr0, sc0, TILE_Y + 2 * r + 2, TILE_X + 2 * r + 2, img,
           H, W, w);
  __syncthreads();

  // warped image over the tile plus an r halo; beyond the image the halo
  // takes reflect-101 of the warped image (pallas_ecc.py:406-437)
  const int ny = TILE_Y + 2 * r;
  const int nx = TILE_X + 2 * r;
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  float* wo = warped_out ? warped_out + (size_t)b * H * W : nullptr;
  for (int i = tid; i < ny * nx; i += NTHREADS) {
    const int ly = i / nx;
    const int lx = i - ly * nx;
    const int y = ty0 - r + ly;
    const int x = tx0 - r + lx;
    float v = 0.f;
    if (y < H + r && x < W + r) {
      const int gy = reflect101(y, H);
      const int gx = reflect101(x, W);
      v = taylor(sep + (gy - sr0) * SEP_P + (gx - sc0), SEP_P, gy, gx, w, H,
                 W);
      if (wo && y == gy && x == gx && ly >= r && ly < r + TILE_Y &&
          lx >= r && lx < r + TILE_X) {
        wo[(size_t)y * W + x] = v;
      }
    }
    wrp[ly * WRP_P + lx] = v;
  }
  __syncthreads();
  filter_tile(wrp, vbuf, taps, ty0, tx0, H, W, out + (size_t)b * H * W);
}

// ---------------------------------------------------------------------------
// K3: the 42 raw Gauss-Newton statistics of (warped image, template).
// Replaces _moments_kernel (pallas_ecc.py:534, via _moments_batched :587).
// Bound: 8 B/pixel read, ~150 flops/pixel.  Design: one block per 4-row
// strip, f32 register accumulation per thread, f64 warp-shuffle block
// reduction, one (42,) f64 partial per block; moments_reduce_kernel sums
// the partials in a fixed order (no atomics: deterministic statistics).

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(MOM_THREADS)
moments_kernel(const float* __restrict__ iws, const float* __restrict__ tmpl,
               const float* __restrict__ warps,
               const float* __restrict__ mask_warps,
               const float* __restrict__ kshift_p,
               double* __restrict__ partials, int H, int W) {
  __shared__ double red[MOM_THREADS / 32][NSTAT];
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const float* iw = iws + (size_t)b * H * W;
  const WarpP w = load_warp(warps, b);
  const WarpP m = load_warp(mask_warps, b);
  const float kshift = *kshift_p;
  const float inv_det = 1.f / (w.a00 * w.a11 - w.a01 * w.a10);
  const float cy = (H - 1) * 0.5f;
  const float cx = (W - 1) * 0.5f;

  float acc[NSTAT];
#pragma unroll
  for (int k = 0; k < NSTAT; ++k) acc[k] = 0.f;

  for (int rr = 0; rr < MOM_ROWS; ++rr) {
    const int y = blk * MOM_ROWS + rr;
    if (y >= H) break;
    // validity of the separable sample under the MASK warp (the composed
    // integer pre-shift), pallas_ecc.py:555-556, 899-900
    const float ysm = affine_pos(m.a11, (float)y, m.ty, m.a10, cx);
    const bool my = (ysm >= 0.f) && (ysm <= (float)(H - 1));
    if (!my) continue;
    const bool gmask = (y > 0) && (y < H - 1);
    const float yf = (float)y;
    const float* row = iw + (size_t)y * W;
    const float* trow = tmpl + (size_t)y * W;
    for (int x = threadIdx.x; x < W; x += MOM_THREADS) {
      const float xsm = affine_pos(m.a00, (float)x, m.tx, m.a01, cy);
      if (!(xsm >= 0.f && xsm <= (float)(W - 1))) continue;
      const bool emask = (x > 0) && (x < W - 1);
      // central differences, zero on the outer ring
      const float gix = emask ? 0.5f * (row[x + 1] - row[x - 1]) : 0.f;
      const float giy = gmask ? 0.5f * (row[x + W] - row[x - W]) : 0.f;
      const float gx = (w.a11 * gix - w.a10 * giy) * inv_det;
      const float gy = (-w.a01 * gix + w.a00 * giy) * inv_det;
      // brightness-shifted fields (pallas_ecc.py:536-543)
      const float iv = row[x] - kshift;
      const float tv = __ldg(trow + x) - kshift;
      const float xf = (float)x;
      const float f3[3] = {gx * gx, gx * gy, gy * gy};
#pragma unroll
      for (int q = 0; q < 3; ++q) {  // Hessian moments [xx,xy,yy,x,y,1]
        const float f = f3[q];
        acc[6 * q + 0] += f * xf * xf;
        acc[6 * q + 1] += f * xf * yf;
        acc[6 * q + 2] += f * yf * yf;
        acc[6 * q + 3] += f * xf;
        acc[6 * q + 4] += f * yf;
        acc[6 * q + 5] += f;
      }
      const float z3[3] = {tv, iv, 1.f};
#pragma unroll
      for (int zi = 0; zi < 3; ++zi) {  // [gx x, gy x, gx y, gy y, gx, gy].z
        const float gxz = gx * z3[zi];
        const float gyz = gy * z3[zi];
        acc[18 + 6 * zi + 0] += gxz * xf;
        acc[18 + 6 * zi + 1] += gyz * xf;
        acc[18 + 6 * zi + 2] += gxz * yf;
        acc[18 + 6 * zi + 3] += gyz * yf;
        acc[18 + 6 * zi + 4] += gxz;
        acc[18 + 6 * zi + 5] += gyz;
      }
      // masked sums: area, S_t, S_i, S_tt, S_ii, S_ti
      acc[36] += 1.f;
      acc[37] += tv;
      acc[38] += iv;
      acc[39] += tv * tv;
      acc[40] += iv * iv;
      acc[41] += tv * iv;
    }
  }

  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NSTAT; ++k) {
    const double v = warp_sum((double)acc[k]);
    if (lane == 0) red[wid][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < NSTAT) {
    double s = 0.0;
    for (int i = 0; i < MOM_THREADS / 32; ++i) s += red[i][threadIdx.x];
    partials[((size_t)b * gridDim.x + blk) * NSTAT + threadIdx.x] = s;
  }
}

// fixed-order f64 sum of the per-block partials -> (B, 128) f32
__global__ void moments_reduce_kernel(const double* __restrict__ partials,
                                      float* __restrict__ out, int nblk) {
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  float v = 0.f;
  if (k < NSTAT) {
    double s = 0.0;
    const double* p = partials + (size_t)b * nblk * NSTAT + k;
    for (int i = 0; i < nblk; ++i) s += p[(size_t)i * NSTAT];
    v = (float)s;
  }
  out[(size_t)b * 128 + k] = v;
}

// ---------------------------------------------------------------------------
// K6: hot-pixel repair.  A pixel >= thresh whose value exceeds the median
// of its 4-neighbours (the 2nd smallest of the 3 or 2 that exist at edges
// and corners) by more than min_change takes that median; a frame with
// more than max_hot pixels >= thresh is left as it is.
// Replaces _hot_kernel (pallas_ecc.py:659, via _hot_batched :739).
// Bound: 8 B/pixel for the repair plus 4 B/pixel for the count, no
// arithmetic to speak of.  The TPU kernel holds a whole frame in VMEM and
// counts it before it repairs it; here a frame spans hundreds of blocks,
// so the count is its own pass: hot_count_kernel reduces each block in
// registers and adds one integer per block to the frame's counter with an
// atomic (integer sums do not depend on order, so the result is exact and
// repeatable), and hot_fix_kernel then repairs the frame.  The neighbour
// reads of hot_fix_kernel happen only at pixels >= thresh, a handful per
// frame.

constexpr int HOT_THREADS = 256;
constexpr int HOT_PER_THREAD = 16;  // count pass: pixels per thread

__global__ void __launch_bounds__(HOT_THREADS)
hot_count_kernel(const float* __restrict__ in, int* __restrict__ counts,
                 long long hw, float thresh) {
  __shared__ int red[HOT_THREADS / 32];
  const int b = blockIdx.y;
  const float* img = in + (size_t)b * hw;
  int n = 0;
  for (long long i = (long long)blockIdx.x * HOT_THREADS + threadIdx.x;
       i < hw; i += (long long)gridDim.x * HOT_THREADS) {
    n += (__ldg(img + i) >= thresh) ? 1 : 0;
  }
  n = __reduce_add_sync(0xffffffffu, n);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int i = 0; i < HOT_THREADS / 32; ++i) s += red[i];
    if (s) atomicAdd(counts + b, s);
  }
}

// torch.minimum / torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__global__ void __launch_bounds__(HOT_THREADS)
hot_fix_kernel(const float* __restrict__ in, const int* __restrict__ counts,
               float* __restrict__ out, int H, int W, float thresh,
               float min_change, int max_hot) {
  const int b = blockIdx.y;
  const long long hw = (long long)H * W;
  const long long i = (long long)blockIdx.x * HOT_THREADS + threadIdx.x;
  if (i >= hw) return;
  const float* img = in + (size_t)b * hw;
  const float x = img[i];
  float v = x;
  if (x >= thresh && counts[b] <= max_hot) {
    const float big = 3.0e38f;  // missing neighbour (ops/image.py)
    const int y = (int)(i / W);
    const int c = (int)(i - (long long)y * W);
    const float up = y > 0 ? img[i - W] : big;
    const float down = y < H - 1 ? img[i + W] : big;
    const float left = c > 0 ? img[i - 1] : big;
    const float right = c < W - 1 ? img[i + 1] : big;
    const int n_valid = 4 - (up >= big) - (down >= big) - (left >= big) -
                        (right >= big);
    // 4-element sorting network: 2nd and 3rd smallest
    const float mid_lo = tmax(tmin(up, down), tmin(left, right));
    const float mid_hi = tmin(tmax(up, down), tmax(left, right));
    const float s2 = tmin(mid_lo, mid_hi);
    const float s3 = tmax(mid_lo, mid_hi);
    const float median = n_valid == 4 ? s3 : s2;
    if (x - median > min_change) v = median;
  }
  out[(size_t)b * hw + i] = v;
}

Taps make_taps(int k, float t0, float t1, float t2, float t3, float t4,
               float t5, float t6) {
  Taps t;
  t.t[0] = t0;
  t.t[1] = t1;
  t.t[2] = t2;
  t.t[3] = t3;
  t.t[4] = t4;
  t.t[5] = t5;
  t.t[6] = t6;
  t.k = k;
  return t;
}

dim3 tile_grid(int B, int H, int W) {
  return dim3((W + TILE_X - 1) / TILE_X, (H + TILE_Y - 1) / TILE_Y, B);
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface.  Every function enqueues on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

extern "C" {

int upsp_ecc_moments_blocks(int H) { return (H + MOM_ROWS - 1) / MOM_ROWS; }

int upsp_ecc_blur(const float* in, float* out, int B, int H, int W, int k,
                  float t0, float t1, float t2, float t3, float t4, float t5,
                  float t6, void* stream) {
  const Taps taps = make_taps(k, t0, t1, t2, t3, t4, t5, t6);
  blur_kernel<<<tile_grid(B, H, W), dim3(BLOCK_X, BLOCK_Y), 0,
                (cudaStream_t)stream>>>(in, out, H, W, taps);
  return (int)cudaGetLastError();
}

int upsp_ecc_warp(const float* in, const float* warps, float* out, int B,
                  int H, int W, void* stream) {
  warp_kernel<<<tile_grid(B, H, W), dim3(BLOCK_X, BLOCK_Y), 0,
                (cudaStream_t)stream>>>(in, warps, out, H, W);
  return (int)cudaGetLastError();
}

int upsp_ecc_warp_filter(const float* in, const float* warps, float* out,
                         float* warped, int B, int H, int W, int k, float t0,
                         float t1, float t2, float t3, float t4, float t5,
                         float t6, void* stream) {
  const Taps taps = make_taps(k, t0, t1, t2, t3, t4, t5, t6);
  warp_filter_kernel<<<tile_grid(B, H, W), dim3(BLOCK_X, BLOCK_Y), 0,
                       (cudaStream_t)stream>>>(in, warps, out, warped, H, W,
                                               taps);
  return (int)cudaGetLastError();
}

int upsp_ecc_moments(const float* iws, const float* tmpl, const float* warps,
                     const float* mask_warps, const float* kshift,
                     double* partials, float* out, int B, int H, int W,
                     void* stream) {
  const int nblk = upsp_ecc_moments_blocks(H);
  moments_kernel<<<dim3(nblk, B), MOM_THREADS, 0, (cudaStream_t)stream>>>(
      iws, tmpl, warps, mask_warps, kshift, partials, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moments_reduce_kernel<<<B, 128, 0, (cudaStream_t)stream>>>(partials, out,
                                                             nblk);
  return (int)cudaGetLastError();
}

// `counts` is (B,) int32 and must hold zeros on entry
int upsp_ecc_hot(const float* in, int* counts, float* out, int B, int H,
                 int W, float thresh, float min_change, int max_hot,
                 void* stream) {
  const long long hw = (long long)H * W;
  const int per_block = HOT_THREADS * HOT_PER_THREAD;
  const int nblk = (int)((hw + per_block - 1) / per_block);
  hot_count_kernel<<<dim3(nblk, B), HOT_THREADS, 0, (cudaStream_t)stream>>>(
      in, counts, hw, thresh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int fblk = (int)((hw + HOT_THREADS - 1) / HOT_THREADS);
  hot_fix_kernel<<<dim3(fblk, B), HOT_THREADS, 0, (cudaStream_t)stream>>>(
      in, counts, out, H, W, thresh, min_change, max_hot);
  return (int)cudaGetLastError();
}

}  // extern "C"
