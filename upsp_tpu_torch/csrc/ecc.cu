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
// K9, and K3 in bf16.  K1, K2 and K9 as first written reach 10-28% of that
// bound and run no faster in bf16 than in f32 (PERF.md): instruction work
// per pixel, not HBM, holds them.  K3 and K4 are redesigned to take the
// row- and column-constant work out of the pixel loops (their notes
// below).  The design goal is one HBM pass per image and coalesced rows:
//
//   - K1, K2 and K9 work on 32x32 (K9 32x128) output tiles with their halo
//     staged in shared memory, so every input pixel is read from HBM once
//     per tile and the separable passes run out of shared memory; K4 on
//     32x128 tiles with per-row and per-column sampling tables.
//   - K2, K4 and K9 sample their two tent taps per axis directly at the
//     separable positions, so there is no band limit (the TPU kernel reads
//     static row shifts within +-3 px; here any displacement is exact, and
//     inside the band the result equals the TPU kernel's).
//   - K3 (and K9) write one f64 partial of the 42 statistics per block; a
//     second small kernel sums the partials in a fixed order in f64: no
//     float atomics, so the statistics (and with them the ECC telemetry
//     and the intensities) are the same from run to run.
//
// The plain PyTorch twins of all of them live beside the wrappers in
// upsp_tpu_torch/ops/ecc_kernels.py and define the semantics.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libupsp_ecc.so ecc.cu

#include <cuda_runtime.h>
#include <limits.h>
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
constexpr int WRP_P = TILE_X + 2 * MAX_R + 1;  // warped/blur input tile
constexpr int WRP_ROWS = TILE_Y + 2 * MAX_R;

// K3: a block owns a strip of MOM_ROWS rows and at most MOM_MAX_COLS
// columns of one frame (mom_grid).  37 rows: the 8 frames x 33 strips of
// the full configuration's 1200-row batch are one wave of
// MOM_BLOCKS_PER_SM blocks on each of an H100's 132 SMs
constexpr int MOM_BLOCKS_PER_SM = 2;  // at most 128 registers a thread
constexpr int MOM_ROWS = 37;
constexpr int MOM_MAX_COLS = 2048;
constexpr int MOM_THREADS = 256;
// rows in flight beyond the three a row's sums read (y-1, y, y+1); the
// ring holds those plus the row being staged
constexpr int MOM_AHEAD = 2;
constexpr int MOM_GROUPS = 3 + MOM_AHEAD;
constexpr int MOM_IMG_SLOTS = MOM_GROUPS + 1;
constexpr int MOM_TMPL_SLOTS = MOM_GROUPS;
constexpr int NSTAT = 42;

// K4: output tile, one warp per row group
constexpr int WF_TX = 128;
constexpr int WF_TY = 32;
constexpr int WF_WARPS = 8;

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
// :444).  Bound: 8 B/pixel (12 with the warped output), 46 flops/pixel.
// Design: a block owns a WF_TY x WF_TX output tile (32 x 128), eight warps
// each taking whole rows, in five shared-memory stages:
//   1. tables: per separable row and column the two tent taps (index
//      clamped into the image, weight 0 where the tap is outside, as the
//      plain twin's _tent_pair), per warped row and column the reflected
//      sample's separable offset, its Taylor factors (WarpedAt) and its
//      edge flag -- each once per block, with K2's rounded affine_pos and
//      floorf, so no position is computed per pixel;
//   2. the source window the taps read, staged with coalesced loads (each
//      thread issues all of its loads before it stores any) when it fits
//      the block's budget (|a00|, |a11| up to ~1.02);
//      otherwise stage 3 reads the taps from global memory, in this kernel;
//   3. the separable image over the tile plus an R+1 ring, rows first, then
//      columns (sep_value's order);
//   4. the warped image over the tile plus an R ring (taylor's terms, from
//      the tables' factors; the ring beyond the image reflects the warped
//      image, pallas_ecc.py:406-437);
//   5. the horizontal filter pass (the plain twin's order), then the
//      vertical pass straight to the output, 16-byte stores where a row is
//      16-byte aligned (4 f32 or 8 bf16 pixels a lane), else one pixel a
//      lane; the warped output leaves stage 4 the same way.
// The stages share two regions: A holds the source window, then the warped
// tile; B the separable tile, then the horizontal pass.  Templated on the
// filter radius R, so every tap loop unrolls.

struct __align__(16) Tent {  // one separable row's (column's) tent taps
  int i0, i1;
  float w0, w1;
};

// One warped row's (column's) Taylor factors.  For a row at image row r
// (reflected) with dx = a01 (r - cy): d1 = dx / (2 a00), d2 = dx^2 /
// (2 a00^2), so that dx gx = d1 (s[c+1] - s[c-1]) and dx^2 gxx / 2 = d2
// (s[c+1] + s[c-1] - 2 s[c]); a column likewise with dy = a10 (c - cx)
// and a11.  `edge` says the derivatives across this row (column) exist:
// taylor's ey for a row, ex for a column.
struct __align__(16) WarpedAt {
  int off;  // separable-tile offset of the reflected row (column)
  float d1, d2;
  int edge;
};

__device__ __forceinline__ WarpedAt warped_at(int off, float d, float inv_a,
                                              bool edge) {
  const float h = 0.5f * d * inv_a;
  return {off, h, h * d * inv_a, edge};
}

// the tent taps of position p over [0, n), zero outside (sep_value's)
__device__ __forceinline__ Tent tent(float p, int n) {
  Tent t;
  if (p > -1.f && p < (float)n) {
    const float f = floorf(p);
    const int k = (int)f;
    t.w1 = p - f;
    t.w0 = 1.f - t.w1;
    if (k < 0) t.w0 = 0.f;
    if (k + 1 >= n) t.w1 = 0.f;
    t.i0 = max(k, 0);
    t.i1 = min(k + 1, n - 1);
  } else {  // both taps outside the image (or NaN)
    t.w0 = t.w1 = 0.f;
    t.i0 = t.i1 = (p >= (float)n) ? n - 1 : 0;
  }
  return t;
}

template <int R>
struct WfLayout {
  static constexpr int SEP_ROWS = WF_TY + 2 * R + 2;
  static constexpr int SEP_COLS = WF_TX + 2 * R + 2;
  static constexpr int SEP_P = SEP_COLS;
  static constexpr int WRP_ROWS = WF_TY + 2 * R;
  static constexpr int WRP_COLS = WF_TX + 2 * R;
  // warped column j sits at WRP_OFF + j, so the tile's first column (j = R)
  // is 16-byte aligned for the vector reads of the warped output
  static constexpr int WRP_OFF = (4 - R % 4) % 4;
  static constexpr int WRP_P = (WRP_COLS + WRP_OFF + 3) / 4 * 4;
  static constexpr int HB_P = WF_TX + 4;
  // the staged source window's budget: the separable tile plus the slack
  // of |a00|, |a11| up to ~1.02 (the budget keeps five blocks on an SM at
  // R = 1; more slack costs residency)
  static constexpr int SRC_ROWS = SEP_ROWS + 2;
  static constexpr int SRC_P = SEP_COLS + 4;
  static constexpr int SRC_FLOATS = SRC_ROWS * SRC_P;
  static constexpr int A_FLOATS =
      ((SRC_FLOATS > WRP_ROWS * WRP_P ? SRC_FLOATS : WRP_ROWS * WRP_P) + 3) /
      4 * 4;  // B starts 16-byte aligned
  static constexpr int B_RAW = (SEP_ROWS * SEP_P > WRP_ROWS * HB_P)
                                   ? SEP_ROWS * SEP_P
                                   : WRP_ROWS * HB_P;
  static constexpr int B_FLOATS = (B_RAW + 3) / 4 * 4;
  static constexpr size_t BYTES =
      sizeof(float) * (A_FLOATS + B_FLOATS) +
      sizeof(Tent) * (SEP_ROWS + SEP_COLS) +
      sizeof(WarpedAt) * (WRP_ROWS + WRP_COLS);
};

// Store n values of one image row: lane l of a warp writes values
// [V l, V l + V) with one 16-byte store (V = 4 f32 or 8 bf16) where `dst` is
// 16-byte aligned, reading them with vec(j, v); else one value a lane,
// scalar(j).  Both compute in f32; a bf16 store rounds once.
__device__ __forceinline__ void st_vec(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ void st_vec(bf16* dst, const float* v) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]),
                 bf16x2_bits(v[4], v[5]), bf16x2_bits(v[6], v[7]));
}

template <typename T, typename Scalar, typename Vec>
__device__ __forceinline__ void write_row(T* dst, int n, int lane,
                                          Scalar scalar, Vec vec) {
  constexpr int V = 16 / sizeof(T);
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int nvec = n / V;
    for (int k = lane; k < nvec; k += 32) {
      float v[V];
      vec(k * V, v);
      st_vec(dst + k * V, v);
    }
    const int j = nvec * V + lane;
    if (j < n) stf(dst + j, scalar(j));
  } else {
    for (int j = lane; j < n; j += 32) stf(dst + j, scalar(j));
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(32 * WF_WARPS)
warp_filter_kernel(const T* __restrict__ in, const float* __restrict__ warps,
                   T* __restrict__ out, T* __restrict__ warped_out, int H,
                   int W, Taps taps) {
  using L = WfLayout<R>;
  constexpr int K = 2 * R + 1;
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) float wf_smem[];
  float* A = wf_smem;
  float* Bs = A + L::A_FLOATS;
  Tent* srow = reinterpret_cast<Tent*>(Bs + L::B_FLOATS);
  Tent* scol = srow + L::SEP_ROWS;
  WarpedAt* wrow = reinterpret_cast<WarpedAt*>(scol + L::SEP_COLS);
  WarpedAt* wcol = wrow + L::WRP_ROWS;
  __shared__ int win[4];  // source window: rows [0], [1]; columns [2], [3]

  const int lane = threadIdx.x;
  const int wid = threadIdx.y;
  const int tid = wid * 32 + lane;
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * WF_TY;
  const int tx0 = blockIdx.x * WF_TX;
  const int ty_n = min(WF_TY, H - ty0);  // output rows of this tile
  const int tx_n = min(WF_TX, W - tx0);
  const int nys = ty_n + 2 * R + 2;  // separable rows and columns
  const int nxs = tx_n + 2 * R + 2;
  const int nyw = ty_n + 2 * R;  // warped rows and columns
  const int nxw = tx_n + 2 * R;
  // separable rows [ty0-R-1, ty0+ty_n+R+1) cover the 3x3 Taylor
  // neighbourhood of every warped pixel the filter halo needs, including
  // the reflected ones (a reflected halo row lies within R rows of the edge)
  const int sr0 = ty0 - R - 1;
  const int sc0 = tx0 - R - 1;
  const T* img = in + (size_t)b * H * W;
  const WarpP w = load_warp(warps, b);
  const float cy = (H - 1) * 0.5f;
  const float cx = (W - 1) * 0.5f;

  // 1. tables, one warp each; the window is the span of the clamped taps
  if (wid < 2) {
    const bool rows = wid == 0;
    const int n = rows ? nys : nxs;
    int lo = INT_MAX, hi = INT_MIN;
    for (int i = lane; i < n; i += 32) {
      const Tent t =
          rows ? tent(affine_pos(w.a11, (float)(sr0 + i), w.ty, w.a10, cx), H)
               : tent(affine_pos(w.a00, (float)(sc0 + i), w.tx, w.a01, cy), W);
      (rows ? srow : scol)[i] = t;
      lo = min(lo, t.i0);
      hi = max(hi, t.i1);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      win[2 * wid] = lo;
      win[2 * wid + 1] = hi;
    }
  } else if (wid == 2) {
    for (int i = lane; i < nyw; i += 32) {
      const int gy = reflect101(ty0 - R + i, H);
      wrow[i] = warped_at((gy - sr0) * L::SEP_P, w.a01 * ((float)gy - cy),
                          1.f / w.a00, (gy > 0) && (gy < H - 1));
    }
  } else if (wid == 3) {
    for (int j = lane; j < nxw; j += 32) {
      const int gx = reflect101(tx0 - R + j, W);
      wcol[j] = warped_at(gx - sc0, w.a10 * ((float)gx - cx), 1.f / w.a11,
                          (gx > 0) && (gx < W - 1));
    }
  }
  __syncthreads();

  // 2. the source window into A (pitch SRC_P), if it fits: every thread
  // issues all its loads before it stores any, so the block waits for
  // global memory once
  const int wy0 = win[0];
  const int wx0 = win[2];
  const int nwr = win[1] - wy0 + 1;
  const int nwc = win[3] - wx0 + 1;
  const bool in_smem = nwr <= L::SRC_ROWS && nwc <= L::SRC_P;
  if (in_smem) {
    constexpr int N = (L::SRC_FLOATS + 32 * WF_WARPS - 1) / (32 * WF_WARPS);
    float v[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int k = tid + n * 32 * WF_WARPS;
      const int i = k / L::SRC_P;
      const int j = k - i * L::SRC_P;
      v[n] = (i < nwr && j < nwc) ? ldf(img + (size_t)(wy0 + i) * W + wx0 + j)
                                  : 0.f;
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int k = tid + n * 32 * WF_WARPS;
      if (k < L::SRC_FLOATS) A[k] = v[n];
    }
  }
  // the taps' indices become offsets into the window, or into the image
  if (wid < 2) {
    const bool rows = wid == 0;
    Tent* t = rows ? srow : scol;
    const int lo = in_smem ? (rows ? wy0 : wx0) : 0;
    const int scale = rows ? (in_smem ? L::SRC_P : W) : 1;
    for (int i = lane; i < (rows ? nys : nxs); i += 32) {
      t[i].i0 = (t[i].i0 - lo) * scale;
      t[i].i1 = (t[i].i1 - lo) * scale;
    }
  }
  __syncthreads();

  // 3. separable image into B: rows first, then columns
  auto fill = [&](auto tap) {
    for (int k = tid; k < L::SEP_ROWS * L::SEP_COLS; k += 32 * WF_WARPS) {
      const int i = k / L::SEP_COLS;
      const int j = k - i * L::SEP_COLS;
      if (i >= nys || j >= nxs) continue;
      const Tent ry = srow[i];
      const Tent rx = scol[j];
      float t0 = ry.w0 * tap(ry.i0 + rx.i0);
      t0 += ry.w1 * tap(ry.i1 + rx.i0);
      float t1 = ry.w0 * tap(ry.i0 + rx.i1);
      t1 += ry.w1 * tap(ry.i1 + rx.i1);
      float v = rx.w0 * t0;
      v += rx.w1 * t1;
      Bs[i * L::SEP_P + j] = v;
    }
  };
  if (in_smem) {
    fill([&](int k) { return A[k]; });
  } else {
    fill([&](int k) { return ldf(img + k); });
  }
  __syncthreads();

  // 4. warped image over the tile plus its R ring into A: taylor's terms,
  // with the factors of the row and column tables
  for (int k = tid; k < L::WRP_ROWS * L::WRP_COLS; k += 32 * WF_WARPS) {
    const int i = k / L::WRP_COLS;
    const int j = k - i * L::WRP_COLS;
    if (i >= nyw || j >= nxw) continue;
    const WarpedAt ry = wrow[i];
    const WarpedAt rx = wcol[j];
    const float* c = Bs + ry.off + rx.off;
    constexpr int P = L::SEP_P;
    const float v = c[0];
    const float hx = rx.edge ? c[1] - c[-1] : 0.f;
    const float hxx = rx.edge ? c[1] + c[-1] - 2.f * v : 0.f;
    const float hy = ry.edge ? c[P] - c[-P] : 0.f;
    const float hyy = ry.edge ? c[P] + c[-P] - 2.f * v : 0.f;
    const float hxy =
        (rx.edge && ry.edge) ? c[P + 1] - c[P - 1] - c[-P + 1] + c[-P - 1] : 0.f;
    float out = v + ry.d1 * hx + rx.d1 * hy;
    out = out + ry.d2 * hxx + (ry.d1 * rx.d1) * hxy + rx.d2 * hyy;
    A[i * L::WRP_P + L::WRP_OFF + j] = out;
  }
  __syncthreads();

  // 5a. the warped output; the horizontal pass into B
  if (warped_out) {
    T* wo = warped_out + (size_t)b * H * W;
    for (int ly = wid; ly < ty_n; ly += WF_WARPS) {
      const float* s = A + (ly + R) * L::WRP_P + L::WRP_OFF + R;
      write_row(wo + (size_t)(ty0 + ly) * W + tx0, tx_n, lane,
                [&](int j) { return s[j]; },
                [&](int j, float* v) {
#pragma unroll
                  for (int e = 0; e < V; e += 4) {
                    const float4 q = *reinterpret_cast<const float4*>(s + j + e);
                    v[e] = q.x;
                    v[e + 1] = q.y;
                    v[e + 2] = q.z;
                    v[e + 3] = q.w;
                  }
                });
    }
  }
  for (int i = wid; i < nyw; i += WF_WARPS) {
    const float* s = A + i * L::WRP_P + L::WRP_OFF;
    float* dst = Bs + i * L::HB_P;
    for (int j = lane; j < tx_n; j += 32) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) acc += taps.t[k] * s[j + k];
      dst[j] = acc;
    }
  }
  __syncthreads();

  // 5b. the vertical pass, straight to the output
  T* o = out + (size_t)b * H * W;
  for (int ly = wid; ly < ty_n; ly += WF_WARPS) {
    const float* s = Bs + ly * L::HB_P;
    write_row(o + (size_t)(ty0 + ly) * W + tx0, tx_n, lane,
              [&](int j) {
                float acc = 0.f;
#pragma unroll
                for (int k = 0; k < K; ++k) acc += taps.t[k] * s[k * L::HB_P + j];
                return acc;
              },
              [&](int j, float* v) {
#pragma unroll
                for (int e = 0; e < V; ++e) v[e] = 0.f;
#pragma unroll
                for (int k = 0; k < K; ++k) {
#pragma unroll
                  for (int e = 0; e < V; e += 4) {
                    const float4 q =
                        *reinterpret_cast<const float4*>(s + k * L::HB_P + j + e);
                    v[e] += taps.t[k] * q.x;
                    v[e + 1] += taps.t[k] * q.y;
                    v[e + 2] += taps.t[k] * q.z;
                    v[e + 3] += taps.t[k] * q.w;
                  }
                }
              });
  }
}

// ---------------------------------------------------------------------------
// K3: the 42 raw Gauss-Newton statistics of (warped image, template).
// Replaces _moments_kernel (pallas_ecc.py:534, via _moments_batched :587).
// Bound: 8 B/pixel read (f32; 4 in bf16, where the 61 flops/pixel bound
// it).  Design:
//   - a block owns a strip of MOM_ROWS rows (and at most MOM_MAX_COLS
//     columns) of one frame, so a frame's blocking, and with it the order
//     of its sums, depends on H and W only; the frame is the fastest grid index,
//     so the blocks of one strip in all B frames run together and read the
//     template's rows from L2, once from HBM per call;
//   - rows are staged in shared memory with 16-byte cp.async copies (the
//     unaligned head and tail of a row element by element), a ring of
//     rows y-1, y, y+1 of the image and row y of the template, with the
//     next MOM_AHEAD rows in flight while row y is summed: each image row
//     leaves HBM once;
//   - the statistics factor per row: a thread sums the x-only terms of row
//     y (sum f x^2, f x, f for the three Hessian products f; g x, g for the
//     six gradient-times-z products g; the masked sums) and folds the row's
//     f x, f and g sums with y and y^2 at the row's end, so no y term is
//     formed per pixel; the products share ax = gx x and ay = gy x
//     (f x^2 = ax ax, ..., g x = ax t, ...), ~37 f32 operations a pixel;
//   - validity under the mask warp: mask_row once per row, mask_col once
//     per column and block (a bitmask per thread, with the same rounded
//     affine_pos, so membership equals the per-pixel test);
//   - one block reduction per strip (f32 within a warp, f64 across
//     warps); moments_reduce_kernel sums the partials in a fixed order in
//     f64 (no atomics: deterministic statistics).

template <typename Acc>
__device__ __forceinline__ Acc warp_sum(Acc v) {
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

// sum of a block's per-thread accumulators: warp shuffles in Acc (K9 f64;
// K3 f32, its thread sums being short), then the warps in order in f64;
// thread 0..41 writes statistic k of the block's partial
template <int THREADS, typename Acc = double>
__device__ __forceinline__ void block_partial(const float* acc, int tid,
                                              double (*red)[NSTAT],
                                              double* __restrict__ out) {
  const int lane = tid & 31;
  const int wid = tid >> 5;
#pragma unroll
  for (int k = 0; k < NSTAT; ++k) {
    const double v = warp_sum((Acc)acc[k]);
    if (lane == 0) red[wid][k] = v;
  }
  __syncthreads();
  if (tid < NSTAT) {
    double s = 0.0;
    for (int i = 0; i < THREADS / 32; ++i) s += red[i][tid];
    out[tid] = s;
  }
}

// cp.async: 16-byte global -> shared copies that bypass the registers
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's latest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// Stage n elements from `src` (any element alignment) into the 16-byte
// aligned slot `dst`: element e lands at dst[mis + e], mis being src's
// offset within its 16-byte line, so the body goes as 16-byte cp.async
// copies and the head and tail (under 16 bytes each) element by element.
template <typename T>
__device__ __forceinline__ void stage_row(T* dst, const T* src, int n,
                                          int tid) {
  constexpr int V = 16 / sizeof(T);
  const int mis = (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
  const int head = min((V - mis) % V, n);
  const int nvec = (n - head) / V;
  const int tail = n - head - nvec * V;
  T* d = dst + mis;
  if (tid < head) {
    d[tid] = src[tid];
  } else if (tid < head + tail) {
    const int e = head + nvec * V + (tid - head);
    d[e] = src[e];
  }
  for (int v = tid; v < nvec; v += MOM_THREADS) {
    cp_async16(d + head + v * V, src + head + v * V);
  }
}

// the staged copy of `src` (stage_row's): p[e] is src[e]
template <typename T>
__device__ __forceinline__ const T* staged(const T* slot, const T* src) {
  return slot + (reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T);
}

// elements per staged row: a strip's columns, their two neighbours and the
// alignment offset, in whole 16-byte lines
template <typename T>
__host__ __device__ __forceinline__ int mom_pitch(int cw) {
  constexpr int V = 16 / sizeof(T);
  return (cw + 2 + V - 1 + V - 1) / V * V;
}

template <typename T>
__global__ void __launch_bounds__(MOM_THREADS, MOM_BLOCKS_PER_SM)
moments_kernel(const T* __restrict__ iws, const T* __restrict__ tmpl,
               const float* __restrict__ warps,
               const float* __restrict__ mask_warps,
               const float* __restrict__ kshift_p,
               double* __restrict__ partials, int H, int W, int cw) {
  extern __shared__ __align__(16) unsigned char mom_smem[];
  __shared__ double red[MOM_THREADS / 32][NSTAT];
  const int pitch = mom_pitch<T>(cw);
  T* ibuf = reinterpret_cast<T*>(mom_smem);
  T* tbuf = ibuf + MOM_IMG_SLOTS * pitch;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int y0 = blockIdx.y * MOM_ROWS;
  const int nrows = min(MOM_ROWS, H - y0);
  const int c0 = blockIdx.z * cw;
  const int c1 = min(W, c0 + cw);
  const int s0 = max(c0 - 1, 0);  // staged columns [s0, s0 + ns)
  const int ns = min(c1 + 1, W) - s0;
  const T* iw = iws + (size_t)b * H * W;
  const WarpP w = load_warp(warps, b);
  const WarpP m = load_warp(mask_warps, b);
  const float kshift = *kshift_p;
  const float inv_det = 1.f / (w.a00 * w.a11 - w.a01 * w.a10);
  const float cy = (H - 1) * 0.5f;
  const float cx = (W - 1) * 0.5f;

  // group j stages image row y0-1+j (j = 0 .. nrows+1) into image slot
  // j % MOM_IMG_SLOTS and, for the strip's own rows, the template row
  // into slot j % MOM_TMPL_SLOTS; row i's sums read groups i .. i+2
  auto stage = [&](int j) {
    const int y = y0 - 1 + j;
    if (j <= nrows + 1 && y >= 0 && y < H) {
      stage_row(ibuf + (j % MOM_IMG_SLOTS) * pitch, iw + (size_t)y * W + s0,
                ns, tid);
      if (j >= 1 && j <= nrows) {
        stage_row(tbuf + (j % MOM_TMPL_SLOTS) * pitch,
                  tmpl + (size_t)y * W + s0, ns, tid);
      }
    }
    cp_async_commit();
  };
  for (int j = 0; j < MOM_GROUPS; ++j) stage(j);

  // this thread's columns x = c0 + tid + k MOM_THREADS: bit k of `cols`
  // if the mask warp keeps x, of `inner` if x has both neighbours
  constexpr int KMAX = (MOM_MAX_COLS + MOM_THREADS - 1) / MOM_THREADS;
  unsigned cols = 0, inner = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int x = c0 + tid + k * MOM_THREADS;
    if (x < c1 && mask_col(m, x, W, cy)) cols |= 1u << k;
    if (x > 0 && x < W - 1) inner |= 1u << k;
  }
  const float ncols = (float)__popc(cols);
  // the warped gradient from the undivided differences dh = i(x+1) - i(x-1)
  // and dv = i(y+1) - i(y-1): gx = p dh + q dv, gy = r dh + s dv
  const float p = 0.5f * w.a11 * inv_det, q = -0.5f * w.a10 * inv_det;
  const float r = -0.5f * w.a01 * inv_det, s = 0.5f * w.a00 * inv_det;

  // strip sums, for the three Hessian products f = gx gx, gx gy, gy gy:
  // f x^2, f x y, f y^2, f x, f y, f; for the six products g = gx t, gy t,
  // gx i, gy i, gx, gy: g x, g y, g; the masked sums
  float fxx[3] = {}, fxy[3] = {}, fyy[3] = {}, fx[3] = {}, fy[3] = {},
        f1[3] = {};
  float gxs[6] = {}, gys[6] = {}, g1[6] = {};
  float ms[6] = {};

  for (int i = 0; i < nrows; ++i) {
    cp_async_wait<MOM_AHEAD>();
    __syncthreads();  // rows y-1..y+1 staged; row y-2's slot is free
    stage(i + MOM_GROUPS);
    const int y = y0 + i;
    if (!mask_row(m, y, H, cx)) continue;
    // the staged rows, indexed by x - s0; on the outer rows up = dn = mid,
    // so dv = 0 there
    const bool gmask = (y > 0) && (y < H - 1);
    const T* row = iw + (size_t)y * W + s0;
    const T* mid = staged(ibuf + ((i + 1) % MOM_IMG_SLOTS) * pitch, row);
    const T* up =
        gmask ? staged(ibuf + (i % MOM_IMG_SLOTS) * pitch, row - W) : mid;
    const T* dn = gmask
                      ? staged(ibuf + ((i + 2) % MOM_IMG_SLOTS) * pitch, row + W)
                      : mid;
    const T* tr = staged(tbuf + ((i + 1) % MOM_TMPL_SLOTS) * pitch,
                         tmpl + (size_t)y * W + s0);
    const int e0 = c0 + tid - s0;
    float rfx[3] = {}, rf[3] = {}, rg[6] = {};  // the row's sums
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (!(cols & (1u << k))) continue;
      const int e = e0 + k * MOM_THREADS;
      const float xf = (float)(c0 + tid + k * MOM_THREADS);
      const float dh =
          (inner & (1u << k)) ? to_f(mid[e + 1]) - to_f(mid[e - 1]) : 0.f;
      const float dv = to_f(dn[e]) - to_f(up[e]);
      const float gx = p * dh + q * dv;
      const float gy = r * dh + s * dv;
      const float iv = to_f(mid[e]) - kshift;
      const float tv = to_f(tr[e]) - kshift;
      const float ax = gx * xf;
      const float ay = gy * xf;
      fxx[0] += ax * ax;
      fxx[1] += ax * ay;
      fxx[2] += ay * ay;
      rfx[0] += ax * gx;
      rfx[1] += ax * gy;
      rfx[2] += ay * gy;
      rf[0] += gx * gx;
      rf[1] += gx * gy;
      rf[2] += gy * gy;
      gxs[0] += ax * tv;
      gxs[1] += ay * tv;
      gxs[2] += ax * iv;
      gxs[3] += ay * iv;
      gxs[4] += ax;
      gxs[5] += ay;
      rg[0] += gx * tv;
      rg[1] += gy * tv;
      rg[2] += gx * iv;
      rg[3] += gy * iv;
      rg[4] += gx;
      rg[5] += gy;
      ms[1] += tv;
      ms[2] += iv;
      ms[3] += tv * tv;
      ms[4] += iv * iv;
      ms[5] += tv * iv;
    }
    ms[0] += ncols;
    const float yf = (float)y;
    const float yy = yf * yf;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      fx[j] += rfx[j];
      f1[j] += rf[j];
      fxy[j] += yf * rfx[j];
      fy[j] += yf * rf[j];
      fyy[j] += yy * rf[j];
    }
#pragma unroll
    for (int n = 0; n < 6; ++n) {
      g1[n] += rg[n];
      gys[n] += yf * rg[n];
    }
  }

  // the (42,) layout of ecc_gn_moments
  float acc[NSTAT];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    acc[6 * q + 0] = fxx[q];
    acc[6 * q + 1] = fxy[q];
    acc[6 * q + 2] = fyy[q];
    acc[6 * q + 3] = fx[q];
    acc[6 * q + 4] = fy[q];
    acc[6 * q + 5] = f1[q];
  }
#pragma unroll
  for (int z = 0; z < 3; ++z) {  // [gx x, gy x, gx y, gy y, gx, gy] . z
    acc[18 + 6 * z + 0] = gxs[2 * z];
    acc[18 + 6 * z + 1] = gxs[2 * z + 1];
    acc[18 + 6 * z + 2] = gys[2 * z];
    acc[18 + 6 * z + 3] = gys[2 * z + 1];
    acc[18 + 6 * z + 4] = g1[2 * z];
    acc[18 + 6 * z + 5] = g1[2 * z + 1];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) acc[36 + k] = ms[k];
  const size_t blk = (size_t)blockIdx.y * gridDim.z + blockIdx.z;
  block_partial<MOM_THREADS, float>(
      acc, tid, red,
      partials + ((size_t)b * gridDim.y * gridDim.z + blk) * NSTAT);
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

// a kernel's shared memory above the default 48 KB, static and dynamic
// together, must be allowed first (once per kernel and size)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

template <typename T, int R>
int launch_wf(const T* in, const float* warps, T* out, T* warped, int B,
              int H, int W, Taps taps, void* stream) {
  static size_t allowed = 0;
  const size_t smem = WfLayout<R>::BYTES;
  const cudaError_t err = allow_smem(warp_filter_kernel<T, R>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + WF_TX - 1) / WF_TX, (H + WF_TY - 1) / WF_TY, B);
  warp_filter_kernel<T, R><<<grid, dim3(32, WF_WARPS), smem,
                             (cudaStream_t)stream>>>(in, warps, out, warped,
                                                     H, W, taps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_warp_filter(const T* in, const float* warps, T* out, T* warped,
                       int B, int H, int W, Taps taps, void* stream) {
  switch (taps.k) {
    case 1:
      return launch_wf<T, 0>(in, warps, out, warped, B, H, W, taps, stream);
    case 3:
      return launch_wf<T, 1>(in, warps, out, warped, B, H, W, taps, stream);
    case 5:
      return launch_wf<T, 2>(in, warps, out, warped, B, H, W, taps, stream);
    case 7:
      return launch_wf<T, 3>(in, warps, out, warped, B, H, W, taps, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K3's grid: (frames, strips of MOM_ROWS rows, column chunks of `cw` <=
// MOM_MAX_COLS columns)
dim3 mom_grid(int B, int H, int W, int* cw) {
  const int ncol = (W + MOM_MAX_COLS - 1) / MOM_MAX_COLS;
  *cw = (W + ncol - 1) / ncol;
  return dim3(B, (H + MOM_ROWS - 1) / MOM_ROWS, ncol);
}

template <typename T>
int launch_moments(const T* iws, const T* tmpl, const float* warps,
                   const float* mask_warps, const float* kshift,
                   double* partials, float* out, int B, int H, int W,
                   void* stream) {
  static size_t allowed = 0;
  int cw;
  const dim3 grid = mom_grid(B, H, W, &cw);
  const size_t smem =
      sizeof(T) * (MOM_IMG_SLOTS + MOM_TMPL_SLOTS) * mom_pitch<T>(cw);
  cudaError_t err = allow_smem(moments_kernel<T>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  moments_kernel<T><<<grid, MOM_THREADS, smem, (cudaStream_t)stream>>>(
      iws, tmpl, warps, mask_warps, kshift, partials, H, W, cw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moments_reduce_kernel<<<B, 128, 0, (cudaStream_t)stream>>>(
      partials, out, grid.y * grid.z);
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
int upsp_ecc_moments_blocks(int H, int W) {
  int cw;
  const dim3 g = mom_grid(1, H, W, &cw);
  return (int)(g.y * g.z);
}
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
