// Hopper kernels for the ECC hot loop of the phase-1 frame program.
//
// Six kernels, each the counterpart of one Pallas TPU kernel in
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
//   K9 fused GN     <- _gn_fused_kernel via _gn_fused_batched / ecc_gn_fused
//                      (K2 then K3 without the warped image in HBM)
//
// K1-K4 and K9 take float32 or bfloat16 images (the JAX package's
// compute_dtype=bfloat16 path): each is a template on the image type, loads
// bf16, computes in f32 and rounds once, at its store, to nearest even
// (__float2bfloat16_rn, as astype(bfloat16) does).  Warps, statistics and
// K9/K3's outputs stay f32.
//
// What bounds them on the H100, at its peak rates: K1-K4 in f32 their
// bytes -- per pixel 8 (K1, K2: one f32 read, one f32 write; K3: the
// image and the template), 8-12 (K4: one read, one or two writes), half
// that in bf16, against 3.35 TB/s of HBM.  The functions need about 18
// (K1), 36 (K2), 46 (K4), 61 (K3) and 97 (K9) flops a pixel once the
// row- and column-constant work (sample positions, weights, the y factors
// of the statistics) is taken out, against 67 TFLOP/s of f32; that holds
// K9, and K3 in bf16.  As written they reach 10-28% of that bound and run
// no faster in bf16 than in f32 (PERF.md), so instruction work per pixel,
// not HBM, holds them today (accumulate_pixel, for one, sums the y terms
// per pixel).  The design goal is one HBM pass per image and coalesced rows:
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
// The plain PyTorch twins of all of them live beside the wrappers in
// upsp_tpu_torch/ops/ecc_kernels.py and define the semantics.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libupsp_ecc.so ecc.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include "image_io.cuh"

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
template <typename T>
__device__ __forceinline__ float sep_value(const T* __restrict__ img, int H,
                                           int W, float ys, float xs) {
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
    if (vy0) t0 = wy0 * ldf(img + (size_t)y0 * W + x0);
    if (vy1) t0 += wy1 * ldf(img + (size_t)(y0 + 1) * W + x0);
  }
  if (vx1) {
    if (vy0) t1 = wy0 * ldf(img + (size_t)y0 * W + x0 + 1);
    if (vy1) t1 += wy1 * ldf(img + (size_t)(y0 + 1) * W + x0 + 1);
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
template <typename T>
__device__ __forceinline__ void fill_sep(float* sep, int pitch, int r0,
                                         int c0, int ny, int nx,
                                         const T* __restrict__ img, int H,
                                         int W, const WarpP& w) {
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
template <typename T>
__device__ __forceinline__ void filter_tile(const float* src, float* vbuf,
                                            const Taps& taps, int ty0,
                                            int tx0, int H, int W,
                                            T* __restrict__ out) {
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
      stf(out + (size_t)y * W + x, acc);
    }
  }
}

// ---------------------------------------------------------------------------
// K1: separable reflect-101 blur, <= 7 taps.
// Replaces _blur_kernel (pallas_ecc.py:779, via _blur_batched :829).
// Bound: 8 B/pixel of HBM traffic.  Design: a 32x32 tile plus its r-pixel
// reflected halo is read once into shared memory; both passes run there.

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
blur_kernel(const T* __restrict__ in, T* __restrict__ out, int H, int W,
            Taps taps) {
  __shared__ float tile[WRP_ROWS * WRP_P];
  __shared__ float vbuf[TILE_Y * WRP_P];
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TILE_Y;
  const int tx0 = blockIdx.x * TILE_X;
  const T* img = in + (size_t)b * H * W;
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
      v = ldf(img + (size_t)reflect101(y, H) * W + reflect101(x, W));
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

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
warp_kernel(const T* __restrict__ in, const float* __restrict__ warps,
            T* __restrict__ out, int H, int W) {
  __shared__ float sep[(TILE_Y + 2) * SEP_P];
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TILE_Y;
  const int tx0 = blockIdx.x * TILE_X;
  const T* img = in + (size_t)b * H * W;
  const WarpP w = load_warp(warps, b);
  fill_sep(sep, SEP_P, ty0 - 1, tx0 - 1, TILE_Y + 2, TILE_X + 2, img, H, W,
           w);
  __syncthreads();
  T* o = out + (size_t)b * H * W;
  for (int ly = threadIdx.y; ly < TILE_Y; ly += BLOCK_Y) {
    const int lx = threadIdx.x;
    const int y = ty0 + ly;
    const int x = tx0 + lx;
    if (y < H && x < W) {
      stf(o + (size_t)y * W + x,
          taylor(sep + (ly + 1) * SEP_P + lx + 1, SEP_P, y, x, w, H, W));
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

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
warp_filter_kernel(const T* __restrict__ in, const float* __restrict__ warps,
                   T* __restrict__ out, T* __restrict__ warped_out, int H,
                   int W, Taps taps) {
  __shared__ float sep[SEP_ROWS * SEP_P];
  __shared__ float wrp[WRP_ROWS * WRP_P];
  __shared__ float vbuf[TILE_Y * WRP_P];
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TILE_Y;
  const int tx0 = blockIdx.x * TILE_X;
  const T* img = in + (size_t)b * H * W;
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
  T* wo = warped_out ? warped_out + (size_t)b * H * W : nullptr;
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
        stf(wo + (size_t)y * W + x, v);
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
// Bound: 8 B/pixel read (f32), ~61 flops/pixel.  Design: one block per 4-row
// strip, f32 register accumulation per thread, f64 warp-shuffle block
// reduction, one (42,) f64 partial per block; moments_reduce_kernel sums
// the partials in a fixed order (no atomics: deterministic statistics).

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// One valid pixel's share of the 42 statistics: the warped gradient from
// the central differences (gix, giy) of the warped image, the
// brightness-shifted image and template values (pallas_ecc.py:536-543).
__device__ __forceinline__ void accumulate_pixel(float* acc, float gix,
                                                 float giy, float iv,
                                                 float tv, float xf, float yf,
                                                 const WarpP& w,
                                                 float inv_det) {
  const float gx = (w.a11 * gix - w.a10 * giy) * inv_det;
  const float gy = (-w.a01 * gix + w.a00 * giy) * inv_det;
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

// validity of pixel (y, x)'s separable sample under the MASK warp (the
// composed integer pre-shift), pallas_ecc.py:555-556, 899-900
__device__ __forceinline__ bool mask_row(const WarpP& m, int y, int H,
                                         float cx) {
  const float ysm = affine_pos(m.a11, (float)y, m.ty, m.a10, cx);
  return (ysm >= 0.f) && (ysm <= (float)(H - 1));
}
__device__ __forceinline__ bool mask_col(const WarpP& m, int x, int W,
                                         float cy) {
  const float xsm = affine_pos(m.a00, (float)x, m.tx, m.a01, cy);
  return xsm >= 0.f && xsm <= (float)(W - 1);
}

// f64 sum of a block's per-thread accumulators (warp shuffles, then the
// warps in order); thread 0..41 writes statistic k of the block's partial
template <int THREADS>
__device__ __forceinline__ void block_partial(const float* acc, int tid,
                                              double (*red)[NSTAT],
                                              double* __restrict__ out) {
  const int lane = tid & 31;
  const int wid = tid >> 5;
#pragma unroll
  for (int k = 0; k < NSTAT; ++k) {
    const double v = warp_sum((double)acc[k]);
    if (lane == 0) red[wid][k] = v;
  }
  __syncthreads();
  if (tid < NSTAT) {
    double s = 0.0;
    for (int i = 0; i < THREADS / 32; ++i) s += red[i][tid];
    out[tid] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(MOM_THREADS)
moments_kernel(const T* __restrict__ iws, const T* __restrict__ tmpl,
               const float* __restrict__ warps,
               const float* __restrict__ mask_warps,
               const float* __restrict__ kshift_p,
               double* __restrict__ partials, int H, int W) {
  __shared__ double red[MOM_THREADS / 32][NSTAT];
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const T* iw = iws + (size_t)b * H * W;
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
    if (!mask_row(m, y, H, cx)) continue;
    const bool gmask = (y > 0) && (y < H - 1);
    const T* row = iw + (size_t)y * W;
    const T* trow = tmpl + (size_t)y * W;
    for (int x = threadIdx.x; x < W; x += MOM_THREADS) {
      if (!mask_col(m, x, W, cy)) continue;
      const bool emask = (x > 0) && (x < W - 1);
      // central differences, zero on the outer ring
      const float gix =
          emask ? 0.5f * (ldf(row + x + 1) - ldf(row + x - 1)) : 0.f;
      const float giy =
          gmask ? 0.5f * (ldf(row + x + W) - ldf(row + x - W)) : 0.f;
      accumulate_pixel(acc, gix, giy, ldf(row + x) - kshift,
                       ldf(trow + x) - kshift, (float)x, (float)y, w,
                       inv_det);
    }
  }
  block_partial<MOM_THREADS>(
      acc, threadIdx.x, red,
      partials + ((size_t)b * gridDim.x + blk) * NSTAT);
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
// K9: one Gauss-Newton step's statistics straight from the UNWARPED image:
// K3's 42 statistics of K2's warped image, without the warped image.
// Replaces _gn_fused_kernel (pallas_ecc.py:968, via _gn_fused_batched
// :1044).  Bound: reading the image and the template, 8 B/pixel in f32 (4
// in bf16) -- against K2 then K3's 16 (8): the warped image is neither
// written nor read back (17.3 MB per 1200x1800 f32 frame per step).
// Design: each block owns a GN_TY x GN_TX tile.  It computes K2's
// separable image over the tile plus a 2-pixel ring into shared memory
// (fill_sep, the same sampling as K2), then the warped image over the tile
// plus a 1-pixel ring (taylor, as K2; zero outside the image), so the
// central differences at the tile's seams read the neighbouring tiles'
// rows and columns from shared memory.  The statistics then follow K3
// pixel by pixel (accumulate_pixel), one f64 partial per block, summed by
// moments_reduce_kernel in a fixed order.  The warped values stay f32 also
// for bf16 images (the JAX kernel's _sep_rows_block does the same), so
// K9 does not round where K2 then K3 rounds the warped image.

constexpr int GN_TX = 128;
constexpr int GN_TY = 32;
constexpr int GN_SP = GN_TX + 4 + 1;  // separable tile pitch (+2 ring)
constexpr int GN_WP = GN_TX + 2 + 1;  // warped tile pitch (+1 ring)

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
gn_fused_kernel(const T* __restrict__ imgs, const T* __restrict__ tmpl,
                const float* __restrict__ warps,
                const float* __restrict__ mask_warps,
                const float* __restrict__ kshift_p,
                double* __restrict__ partials, int H, int W) {
  __shared__ float sep[(GN_TY + 4) * GN_SP];
  __shared__ float wrp[(GN_TY + 2) * GN_WP];
  __shared__ double red[NTHREADS / 32][NSTAT];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * GN_TY;
  const int x0 = blockIdx.x * GN_TX;
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  const T* img = imgs + (size_t)b * H * W;
  const WarpP w = load_warp(warps, b);
  const WarpP m = load_warp(mask_warps, b);

  fill_sep(sep, GN_SP, y0 - 2, x0 - 2, GN_TY + 4, GN_TX + 4, img, H, W, w);
  __syncthreads();
  // warped rows [y0-1, y0+GN_TY+1), columns [x0-1, x0+GN_TX+1); zero
  // outside the image (the moments kernel never reads those: the outer
  // ring has no central difference)
  constexpr int NY = GN_TY + 2;
  constexpr int NX = GN_TX + 2;
  for (int i = tid; i < NY * NX; i += NTHREADS) {
    const int ly = i / NX;
    const int lx = i - ly * NX;
    const int r = y0 - 1 + ly;
    const int c = x0 - 1 + lx;
    float v = 0.f;
    if (r >= 0 && r < H && c >= 0 && c < W) {
      v = taylor(sep + (ly + 1) * GN_SP + lx + 1, GN_SP, r, c, w, H, W);
    }
    wrp[ly * GN_WP + lx] = v;
  }
  __syncthreads();

  const float kshift = *kshift_p;
  const float inv_det = 1.f / (w.a00 * w.a11 - w.a01 * w.a10);
  const float cy = (H - 1) * 0.5f;
  const float cx = (W - 1) * 0.5f;
  float acc[NSTAT];
#pragma unroll
  for (int k = 0; k < NSTAT; ++k) acc[k] = 0.f;
  for (int i = tid; i < GN_TY * GN_TX; i += NTHREADS) {
    const int ly = i / GN_TX;
    const int lx = i - ly * GN_TX;
    const int y = y0 + ly;
    const int x = x0 + lx;
    if (y >= H || x >= W || !mask_row(m, y, H, cx) || !mask_col(m, x, W, cy)) {
      continue;
    }
    const float* c = wrp + (ly + 1) * GN_WP + lx + 1;
    const float gix = (x > 0 && x < W - 1) ? 0.5f * (c[1] - c[-1]) : 0.f;
    const float giy =
        (y > 0 && y < H - 1) ? 0.5f * (c[GN_WP] - c[-GN_WP]) : 0.f;
    accumulate_pixel(acc, gix, giy, c[0] - kshift,
                     ldf(tmpl + (size_t)y * W + x) - kshift, (float)x,
                     (float)y, w, inv_det);
  }
  const int nblk = gridDim.x * gridDim.y;
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  block_partial<NTHREADS>(acc, tid, red,
                          partials + ((size_t)b * nblk + blk) * NSTAT);
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

dim3 gn_grid(int B, int H, int W) {
  return dim3((W + GN_TX - 1) / GN_TX, (H + GN_TY - 1) / GN_TY, B);
}

// launchers of the image-type templates (T = float or bf16)

template <typename T>
int launch_blur(const T* in, T* out, int B, int H, int W, Taps taps,
                void* stream) {
  blur_kernel<T><<<tile_grid(B, H, W), dim3(BLOCK_X, BLOCK_Y), 0,
                   (cudaStream_t)stream>>>(in, out, H, W, taps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_warp(const T* in, const float* warps, T* out, int B, int H, int W,
                void* stream) {
  warp_kernel<T><<<tile_grid(B, H, W), dim3(BLOCK_X, BLOCK_Y), 0,
                   (cudaStream_t)stream>>>(in, warps, out, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_warp_filter(const T* in, const float* warps, T* out, T* warped,
                       int B, int H, int W, Taps taps, void* stream) {
  warp_filter_kernel<T><<<tile_grid(B, H, W), dim3(BLOCK_X, BLOCK_Y), 0,
                          (cudaStream_t)stream>>>(in, warps, out, warped, H,
                                                  W, taps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_moments(const T* iws, const T* tmpl, const float* warps,
                   const float* mask_warps, const float* kshift,
                   double* partials, float* out, int B, int H, int W,
                   void* stream) {
  const int nblk = (H + MOM_ROWS - 1) / MOM_ROWS;
  moments_kernel<T><<<dim3(nblk, B), MOM_THREADS, 0, (cudaStream_t)stream>>>(
      iws, tmpl, warps, mask_warps, kshift, partials, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moments_reduce_kernel<<<B, 128, 0, (cudaStream_t)stream>>>(partials, out,
                                                             nblk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gn_fused(const T* imgs, const T* tmpl, const float* warps,
                    const float* mask_warps, const float* kshift,
                    double* partials, float* out, int B, int H, int W,
                    void* stream) {
  const dim3 grid = gn_grid(B, H, W);
  gn_fused_kernel<T><<<grid, dim3(BLOCK_X, BLOCK_Y), 0,
                       (cudaStream_t)stream>>>(imgs, tmpl, warps, mask_warps,
                                               kshift, partials, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moments_reduce_kernel<<<B, 128, 0, (cudaStream_t)stream>>>(
      partials, out, grid.x * grid.y);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface.  Every function enqueues on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError().  The
// _bf16 entry points take bfloat16 images (and template); warps, kshift,
// partials and statistics are float32/float64 in both.

#define UPSP_TAPS_ARGS                                                     \
  int k, float t0, float t1, float t2, float t3, float t4, float t5,      \
      float t6
#define UPSP_TAPS make_taps(k, t0, t1, t2, t3, t4, t5, t6)

extern "C" {

// (B, nblk, 42) float64 partials of upsp_ecc_moments / upsp_ecc_gn_fused
int upsp_ecc_moments_blocks(int H) { return (H + MOM_ROWS - 1) / MOM_ROWS; }
int upsp_ecc_gn_fused_blocks(int H, int W) {
  const dim3 g = gn_grid(1, H, W);
  return (int)(g.x * g.y);
}

int upsp_ecc_blur(const float* in, float* out, int B, int H, int W,
                  UPSP_TAPS_ARGS, void* stream) {
  return launch_blur(in, out, B, H, W, UPSP_TAPS, stream);
}
int upsp_ecc_blur_bf16(const bf16* in, bf16* out, int B, int H, int W,
                       UPSP_TAPS_ARGS, void* stream) {
  return launch_blur(in, out, B, H, W, UPSP_TAPS, stream);
}

int upsp_ecc_warp(const float* in, const float* warps, float* out, int B,
                  int H, int W, void* stream) {
  return launch_warp(in, warps, out, B, H, W, stream);
}
int upsp_ecc_warp_bf16(const bf16* in, const float* warps, bf16* out, int B,
                       int H, int W, void* stream) {
  return launch_warp(in, warps, out, B, H, W, stream);
}

int upsp_ecc_warp_filter(const float* in, const float* warps, float* out,
                         float* warped, int B, int H, int W, UPSP_TAPS_ARGS,
                         void* stream) {
  return launch_warp_filter(in, warps, out, warped, B, H, W, UPSP_TAPS,
                            stream);
}
int upsp_ecc_warp_filter_bf16(const bf16* in, const float* warps, bf16* out,
                              bf16* warped, int B, int H, int W,
                              UPSP_TAPS_ARGS, void* stream) {
  return launch_warp_filter(in, warps, out, warped, B, H, W, UPSP_TAPS,
                            stream);
}

int upsp_ecc_moments(const float* iws, const float* tmpl, const float* warps,
                     const float* mask_warps, const float* kshift,
                     double* partials, float* out, int B, int H, int W,
                     void* stream) {
  return launch_moments(iws, tmpl, warps, mask_warps, kshift, partials, out,
                        B, H, W, stream);
}
int upsp_ecc_moments_bf16(const bf16* iws, const bf16* tmpl,
                          const float* warps, const float* mask_warps,
                          const float* kshift, double* partials, float* out,
                          int B, int H, int W, void* stream) {
  return launch_moments(iws, tmpl, warps, mask_warps, kshift, partials, out,
                        B, H, W, stream);
}

int upsp_ecc_gn_fused(const float* imgs, const float* tmpl,
                      const float* warps, const float* mask_warps,
                      const float* kshift, double* partials, float* out,
                      int B, int H, int W, void* stream) {
  return launch_gn_fused(imgs, tmpl, warps, mask_warps, kshift, partials,
                         out, B, H, W, stream);
}
int upsp_ecc_gn_fused_bf16(const bf16* imgs, const bf16* tmpl,
                           const float* warps, const float* mask_warps,
                           const float* kshift, double* partials, float* out,
                           int B, int H, int W, void* stream) {
  return launch_gn_fused(imgs, tmpl, warps, mask_warps, kshift, partials,
                         out, B, H, W, stream);
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
