// Hopper kernels for the ECC hot loop of the phase-1 frame program.
//
// Six kernels, each the counterpart of one Pallas TPU kernel in
// upsp_tpu/ops/pallas_ecc.py:
//
//   K1 blur         <- _blur_kernel via _blur_batched / make_blur
//   K2 warp         <- _warp_kernel via _warp_banded_batched /
//                      warp_affine_banded
//   K3 GN moments   <- _moments_kernel via _moments_batched / ecc_gn_moments;
//                      its reduce stage may also do the step's closed-form
//                      update (upsp_ecc_moments_update), which the JAX
//                      package does in XLA after the kernel
//   K4 warp+filter  <- _warp_filter_kernel via _warp_filter_batched /
//                      make_warp_filter
//   K6 hot pixels   <- _hot_kernel via _hot_batched / fix_hot_pixels_pallas
//                      (one streaming pass + a per-frame repair, below)
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
// K9, and K3 in bf16.  As first written, K1-K4 and K9 reached 10-28% of
// that bound and ran no faster in bf16 than in f32 (PERF.md): instruction
// work per pixel, not HBM, held them.  K1-K4 are redesigned to take the
// row- and column-constant work out of the pixel loops, stage each input
// row once and store 16 bytes a lane (their notes below).  The design goal
// is one HBM pass per image and coalesced rows:
//
//   - K1 streams strips of rows through registers, 16 bytes of columns a
//     thread; K3 stages strips of rows with cp.async; K2 and K4 work on
//     32x128 output tiles with per-row and per-column sampling tables and
//     their source window staged in shared memory (shared device
//     functions); K9 walks bands of rows of column strips with the same
//     functions and K3's row-folded sums, carrying its halo rows.
//   - K2, K4 and K9 sample their two tent taps per axis directly at the
//     separable positions, so there is no band limit (the TPU kernel reads
//     static row shifts within +-3 px; here any displacement is sampled
//     exactly, and inside the band the result equals the TPU kernel's).
//     K2 and K4 round every operation of the resample and of the Taylor
//     term as their plain twins do, so their warped values are the twins'
//     to the bit at any shear.
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

// K1: threads a block, each owning 16 bytes of output columns (blur_kernel)
constexpr int BLUR_THREADS = 128;

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

// K2 and K4: output tile, one warp per row group
constexpr int WF_TX = 128;
constexpr int WF_TY = 32;
constexpr int WF_WARPS = 8;
// at most 48 registers a thread, so that five blocks fit an SM (their
// shared memory is sized for five)
constexpr int WF_BLOCKS_PER_SM = 5;

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

// cp.async: 16-byte global -> shared copies that bypass the registers
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
// a 4-byte copy (an f32 element), through L1
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
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

// src's element offset within its 16-byte line
template <typename T>
__device__ __forceinline__ int line_offset(const T* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
}

// Stage n elements from `src` (any element alignment) into the 16-byte
// aligned slot `dst`, by a block of MOM_THREADS: element e lands at
// dst[line_offset(src) + e], so the body goes as 16-byte cp.async copies
// and the head and tail (under 16 bytes each) element by element.
template <typename T>
__device__ __forceinline__ void stage_row(T* dst, const T* src, int n,
                                          int tid) {
  constexpr int V = 16 / sizeof(T);
  const int mis = line_offset(src);
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
  return slot + line_offset(src);
}

// Store n values of one image row: lane l of a warp writes values [V l,
// V l + V) with one 16-byte store (V = 4 f32 or 8 bf16) where `dst` is
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

// N consecutive f32 values from 16-byte aligned `p` into v
template <int N>
__device__ __forceinline__ void ld_run(const float* p, float* v) {
#pragma unroll
  for (int e = 0; e < N; e += 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + e);
    v[e] = q.x;
    v[e + 1] = q.y;
    v[e + 2] = q.z;
    v[e + 3] = q.w;
  }
}

// The order-2 shear Taylor term of one warped pixel from the 3x3
// neighbourhood of the separable image (rows u, m, d; columns l, c, r),
// its row's x displacement dx = a01 (y - cy) and hdx2 = 0.5 dx dx, its
// column's dy = a10 (x - cx) and hdy2, and 1/a00, 1/a11.  Derivatives are
// zero on the outer ring: gx/gxx where !ex (columns 0 and W-1), gy/gyy
// where !ey (rows 0 and H-1), gxy on the whole ring (ops/warp.py:170-197).
// Every operation is rounded on its own, in the plain twin's order
// (_warp_f32): at a few pixels of shear the terms reach thousands of counts
// and cancel, so another order, a factored form or an FMA moves the sum by
// several ulps of those terms (2e-3 counts and more on 1200-row frames).
__device__ __forceinline__ float taylor_px(float ul, float uc, float ur,
                                           float ml, float mc, float mr,
                                           float dl, float dc, float dr,
                                           float dx, float hdx2, bool ey,
                                           float dy, float hdy2, bool ex,
                                           float inv_ax, float inv_ay) {
  const float gx =
      ex ? __fmul_rn(__fmul_rn(0.5f, __fsub_rn(mr, ml)), inv_ax) : 0.f;
  const float gxx = ex ? __fmul_rn(__fmul_rn(__fadd_rn(__fsub_rn(mr, 2.f * mc),
                                                       ml),
                                             inv_ax),
                                   inv_ax)
                       : 0.f;
  const float gy =
      ey ? __fmul_rn(__fmul_rn(0.5f, __fsub_rn(dc, uc)), inv_ay) : 0.f;
  const float gyy = ey ? __fmul_rn(__fmul_rn(__fadd_rn(__fsub_rn(dc, 2.f * mc),
                                                       uc),
                                             inv_ay),
                                   inv_ay)
                       : 0.f;
  const float hxy = __fadd_rn(__fsub_rn(__fsub_rn(dr, dl), ur), ul);
  const float gxy =
      (ex && ey) ? __fmul_rn(__fmul_rn(__fmul_rn(0.25f, hxy), inv_ax), inv_ay)
                 : 0.f;
  float out = __fadd_rn(__fadd_rn(mc, __fmul_rn(dx, gx)), __fmul_rn(dy, gy));
  out = __fadd_rn(out, __fmul_rn(hdx2, gxx));
  out = __fadd_rn(out, __fmul_rn(__fmul_rn(dx, dy), gxy));
  return __fadd_rn(out, __fmul_rn(hdy2, gyy));
}

// 0.5 d d as the plain twin rounds it
__device__ __forceinline__ float half_sq(float d) {
  return __fmul_rn(__fmul_rn(0.5f, d), d);
}

// ---------------------------------------------------------------------------
// K1: separable reflect-101 blur, <= 7 taps.
// Replaces _blur_kernel (pallas_ecc.py:779, via _blur_batched :829).
// Bound: 8 B/pixel of HBM traffic in f32, 4 in bf16, 18 flops.  Design: a
// thread owns V adjacent output columns (4 f32 or 8 bf16: one 16-byte
// store) of a strip of `strip` rows of one frame; a block is BLUR_THREADS
// such threads side by side.  The thread streams the strip's input rows --
// its rows and R rows above and below, reflected when the row index is
// chosen -- top to bottom, two rows' loads in flight at a time: per row the
// three aligned 16-byte vectors around its columns (its neighbours' loads
// of the same lines hit L1), or, within R of the row's ends and on rows
// that are not 16-byte aligned, element by element with reflect-101 at the
// ends.  It filters each row horizontally into V values, keeps the last
// 2R+1 filtered rows in registers and sums them vertically into its output
// row: no shared memory and no barrier.  Horizontal, then vertical, each
// summed from tap 0 upwards, each product and sum rounded on its own
// (__fmul_rn, __fadd_rn: no FMA contraction): the plain twin's order and
// rounding, so the output is the twin's to the bit.  Templated on R, so
// the tap loops unroll and the ring and the taps stay in registers.  The
// strip height makes the grid one wave of resident blocks (launch_blur_r);
// an output pixel's arithmetic does not depend on it.  Staging each row in
// shared memory with cp.async and keeping the filtered ring there (one
// barrier a row) measured slower at every shape and type (PERF.md).

// 16 bytes at 16-byte aligned p, widened to f32
__device__ __forceinline__ void ld_vec(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void ld_vec(const bf16* p, float* v) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// reflect-101 of any column index into [0, n) (columns past a partial last
// group are computed and never stored)
__device__ __forceinline__ int reflect_any(int i, int n) {
  return reflect101(min(max(i, -(n - 1)), 2 * (n - 1)), n);
}

// the M = V + 2R input values of row `row` that columns [c, c + V) read:
// run[i] is column c - R + i
template <typename T, int M>
__device__ __forceinline__ void blur_run(const T* row, int c, int W,
                                         bool fast, float* run) {
  constexpr int V = 16 / sizeof(T);
  constexpr int R = (M - V) / 2;
  if (fast) {  // columns [c - V, c + 2V) lie in the row, 16-byte aligned
    float q[3 * V];
    ld_vec(row + c - V, q);
    ld_vec(row + c, q + V);
    ld_vec(row + c + V, q + 2 * V);
#pragma unroll
    for (int i = 0; i < M; ++i) run[i] = q[V - R + i];
  } else {
#pragma unroll
    for (int i = 0; i < M; ++i) run[i] = ldf(row + reflect_any(c - R + i, W));
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(BLUR_THREADS)
blur_kernel(const T* __restrict__ in, T* __restrict__ out, int H, int W,
            int strip, Taps taps) {
  constexpr int K = 2 * R + 1;
  constexpr int V = 16 / sizeof(T);
  constexpr int M = V + 2 * R;
  const int c = (blockIdx.x * BLUR_THREADS + threadIdx.x) * V;
  if (c >= W) return;
  const int y0 = blockIdx.y * strip;
  const int nrows = min(strip, H - y0);
  const int b = blockIdx.z;
  const T* img = in + (size_t)b * H * W;
  T* o = out + (size_t)b * H * W;
  float t[K];
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = taps.t[k];
  const bool inner = c >= V && c + 2 * V <= W;
  const bool full = c + V <= W;
  float ring[K][V];  // the last K filtered rows, oldest first
  const int nr = nrows + 2 * R;  // input row j is image row y0 - R + j
  for (int j0 = 0; j0 < nr; j0 += 2) {
    float run[2][M];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const T* row =
          img + (size_t)reflect101(y0 - R + min(j0 + u, nr - 1), H) * W;
      const bool fast =
          inner && (reinterpret_cast<uintptr_t>(row + c) & 15) == 0;
      blur_run<T, M>(row, c, W, fast, run[u]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = j0 + u;
      if (j >= nr) break;
#pragma unroll
      for (int k = 0; k < K - 1; ++k) {
#pragma unroll
        for (int e = 0; e < V; ++e) ring[k][e] = ring[k + 1][e];
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float acc = __fmul_rn(t[0], run[u][e]);
#pragma unroll
        for (int k = 1; k < K; ++k) {
          acc = __fadd_rn(acc, __fmul_rn(t[k], run[u][e + k]));
        }
        ring[K - 1][e] = acc;
      }
      if (j < 2 * R) continue;
      float v[V];  // output row y0 + j - 2R
#pragma unroll
      for (int e = 0; e < V; ++e) {
        v[e] = __fmul_rn(t[0], ring[0][e]);
#pragma unroll
        for (int k = 1; k < K; ++k) {
          v[e] = __fadd_rn(v[e], __fmul_rn(t[k], ring[k][e]));
        }
      }
      T* dst = o + (size_t)(y0 + j - 2 * R) * W + c;
      if (full && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        st_vec(dst, v);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (c + e < W) stf(dst + e, v[e]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The separable image of an output tile, shared by K2 and K4.
//
// A block owns a WF_TY x WF_TX output tile (32 x 128, eight warps) and
// needs the separable image (R @ img @ C^T of ops/warp.py) over the tile
// plus a ring of R+1 pixels (R: K4's filter radius; 0 for K2):
//   - sep_window: the source rows and columns its tent taps read.  A
//     sample position is affine in the row (column) index and rounded
//     monotonically (affine_pos), and tent's taps are monotone in the
//     position, so the span follows from the first and last separable row
//     and column alone, before any table exists;
//   - stage_window: if the span fits the budget (|a00|, |a11| up to
//     ~1.02), its rows go to shared memory as 16-byte cp.async copies (the
//     unaligned head and tail element by element), in flight while the
//     block builds its tables; otherwise the taps read global memory, in
//     the same kernel;
//   - tent_table: per separable row and column the two tent taps (index
//     clamped into the image, weight 0 where the tap is outside, as the
//     plain twin's _tent_pair), as offsets into the staged window or the
//     image, each once per block with K2's rounded affine_pos and floorf,
//     so no position is computed per pixel;
//   - sep_tile: the separable image, rows first, then columns, each
//     product and sum rounded on its own (the plain twin's order);
//   - taylor_px: the order-2 shear Taylor term of one warped pixel from its
//     3x3 separable neighbourhood and its row's and column's displacements
//     (WarpedAt), formed once per row and column.
// The separable tile and the warped values are thus the twin's to the bit.

struct __align__(16) Tent {  // one separable row's (column's) tent taps
  int i0, i1;
  float w0, w1;
};

// One warped row's (column's) displacement for taylor_px: for a row at
// image row r, d = dx = a01 (r - cy) and dd = 0.5 dx dx; a column likewise
// with dy = a10 (c - cx).  `edge` says the derivatives across this row
// (column) exist: taylor_px's ey for a row, ex for a column.  `off` is K4's
// separable-tile offset of the row (column) its reflected ring reads.
struct __align__(16) WarpedAt {
  int off;
  float d, dd;
  int edge;
};

__device__ __forceinline__ WarpedAt warped_at(int off, float d, bool edge) {
  return {off, d, half_sq(d), edge};
}

// the tent taps of position p over [0, n), zero outside the image
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

// separable row r's and column c's taps: the sample positions, residual
// shear centred on the image
__device__ __forceinline__ Tent row_tent(const WarpP& w, int r, int H,
                                         int W) {
  return tent(affine_pos(w.a11, (float)r, w.ty, w.a10, (W - 1) * 0.5f), H);
}
__device__ __forceinline__ Tent col_tent(const WarpP& w, int c, int H,
                                         int W) {
  return tent(affine_pos(w.a00, (float)c, w.tx, w.a01, (H - 1) * 0.5f), W);
}

// The separable tile's shapes for filter radius R and the staged window's
// budget: the tile plus the slack of |a00|, |a11| up to ~1.02 (more slack
// costs residency), each row in whole 16-byte lines with room for its
// line offset.
template <typename T, int R>
struct SepLayout {
  static constexpr int ROWS = WF_TY + 2 * R + 2;
  static constexpr int COLS = WF_TX + 2 * R + 2;
  static constexpr int SRC_ROWS = ROWS + 2;
  static constexpr int SRC_COLS = COLS + 4;
  static constexpr int V = 16 / sizeof(T);
  static constexpr int SRC_P = (SRC_COLS + 2 * (V - 1)) / V * V;
  static constexpr int SRC_BYTES = SRC_ROWS * SRC_P * (int)sizeof(T);
};

struct Window {
  int y0, x0;  // the first source row and column
  int nr, nc;  // rows and columns
  bool smem;   // staged in shared memory
};

template <typename L>
__device__ __forceinline__ Window sep_window(const WarpP& w, int H, int W,
                                             int sr0, int nys, int sc0,
                                             int nxs) {
  const Tent r0 = row_tent(w, sr0, H, W);
  const Tent r1 = row_tent(w, sr0 + nys - 1, H, W);
  const Tent c0 = col_tent(w, sc0, H, W);
  const Tent c1 = col_tent(w, sc0 + nxs - 1, H, W);
  Window win;
  win.y0 = min(r0.i0, r1.i0);
  win.x0 = min(c0.i0, c1.i0);
  win.nr = max(r0.i1, r1.i1) - win.y0 + 1;
  win.nc = max(c0.i1, c1.i1) - win.x0 + 1;
  win.smem = win.nr <= L::SRC_ROWS && win.nc <= L::SRC_COLS;
  return win;
}

// The window's rows into `src` (pitch L::SRC_P), one warp a row, each as
// stage_row lays it out: the 16-byte body as cp.async copies, one group per
// thread; the unaligned head and tail element by element: f32 elements as
// 4-byte cp.async copies too, so nothing waits for global memory here;
// bf16 elements (2 bytes, below cp.async's least size) loaded, every
// row's loads issued before any of them is stored, so a warp waits for
// global memory once and not once a row.
template <typename L, typename T>
__device__ __forceinline__ void stage_window(T* src, const T* img, int W,
                                             const Window& win, int wid,
                                             int lane) {
  constexpr int V = 16 / sizeof(T);
  constexpr int ROWS = (L::SRC_ROWS + WF_WARPS - 1) / WF_WARPS;  // a warp's
  T edge[ROWS];  // this lane's head or tail element of each of its rows
  int at[ROWS];  // its index in the row, -1 for none
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    const int i = wid + m * WF_WARPS;
    at[m] = -1;
    if (i >= win.nr) continue;
    const T* s = img + (size_t)(win.y0 + i) * W + win.x0;
    T* d = src + i * L::SRC_P + line_offset(s);
    const int head = min((V - line_offset(s)) % V, win.nc);
    const int nvec = (win.nc - head) / V;
    const int tail = win.nc - head - nvec * V;
    for (int v = lane; v < nvec; v += 32) {
      cp_async16(d + head + v * V, s + head + v * V);
    }
    if (lane < head + tail) {
      const int e = lane < head ? lane : nvec * V + lane;
      if constexpr (sizeof(T) == 4) {
        cp_async4(d + e, s + e);
      } else {
        at[m] = e;
        edge[m] = s[e];
      }
    }
  }
  cp_async_commit();
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    if (at[m] < 0) continue;
    const T* s = img + (size_t)(win.y0 + wid + m * WF_WARPS) * W + win.x0;
    src[(wid + m * WF_WARPS) * L::SRC_P + line_offset(s) + at[m]] = edge[m];
  }
}

// One warp: the tent taps of n separable rows (or columns) from s0 on, as
// offsets into the staged window -- a row's includes its line offset --
// or, off the window, into the image.  Clamping into the window changes
// nothing for finite warps (the window spans every tap).
template <typename L, typename T>
__device__ __forceinline__ void tent_table(Tent* table, bool rows, int s0,
                                           int n, const WarpP& w, int H,
                                           int W, const T* img,
                                           const Window& win, int lane) {
  for (int i = lane; i < n; i += 32) {
    Tent t = rows ? row_tent(w, s0 + i, H, W) : col_tent(w, s0 + i, H, W);
    if (win.smem && rows) {
      auto off = [&](int r) {
        r = min(max(r, win.y0), win.y0 + win.nr - 1);
        return (r - win.y0) * L::SRC_P +
               line_offset(img + (size_t)r * W + win.x0);
      };
      t.i0 = off(t.i0);
      t.i1 = off(t.i1);
    } else if (win.smem) {
      t.i0 = min(max(t.i0, win.x0), win.x0 + win.nc - 1) - win.x0;
      t.i1 = min(max(t.i1, win.x0), win.x0 + win.nc - 1) - win.x0;
    } else if (rows) {
      t.i0 *= W;
      t.i1 *= W;
    }
    table[i] = t;
  }
}

// The separable image of rows [0, nys) and columns [0, nxs) of the tables
// into S (row i, column j at S[i * SP + j]): lane l of every warp takes the
// columns l, l + 32, ..., each column's taps read once, and the warps split
// the rows (a row's taps are the same for the whole warp, one broadcast).
template <typename Tap>
__device__ __forceinline__ void sep_tile(float* S, int SP, const Tent* srow,
                                         const Tent* scol, int nys, int nxs,
                                         int lane, int wid, Tap tap) {
  for (int j = lane; j < nxs; j += 32) {
    const Tent rx = scol[j];
    for (int i = wid; i < nys; i += WF_WARPS) {
      const Tent ry = srow[i];
      const float t0 = __fadd_rn(__fmul_rn(ry.w0, tap(ry.i0 + rx.i0)),
                                 __fmul_rn(ry.w1, tap(ry.i1 + rx.i0)));
      const float t1 = __fadd_rn(__fmul_rn(ry.w0, tap(ry.i0 + rx.i1)),
                                 __fmul_rn(ry.w1, tap(ry.i1 + rx.i1)));
      S[i * SP + j] = __fadd_rn(__fmul_rn(rx.w0, t0), __fmul_rn(rx.w1, t1));
    }
  }
}

// the separable tile from the staged window or, off it, from the image
template <typename T>
__device__ __forceinline__ void sep_tile_from(float* S, int SP,
                                              const Tent* srow,
                                              const Tent* scol, int nys,
                                              int nxs, int lane, int wid,
                                              const Window& win, const T* src,
                                              const T* img) {
  if (win.smem) {
    sep_tile(S, SP, srow, scol, nys, nxs, lane, wid,
             [&](int k) { return to_f(src[k]); });
  } else {
    sep_tile(S, SP, srow, scol, nys, nxs, lane, wid,
             [&](int k) { return ldf(img + k); });
  }
}

// ---------------------------------------------------------------------------
// K2: out(y, x) = img(W @ [x, y, 1]), separable tent resample + order-2
// shear Taylor correction, zero outside the image; derivatives are zero on
// the image's outer ring (taylor_px's).
// Replaces _warp_kernel (pallas_ecc.py:253, via _warp_banded_batched :285).
// Bound: 8 B/pixel in f32, 4 in bf16, 36 flops.  Design: K4's stages 1-2
// at R = 0 -- the window's span from the tile's ends, its cp.async copies
// in flight while the tent tables are built, the separable tile plus a
// 1-pixel ring in shared memory -- then the warped value of each output
// pixel in registers and straight to HBM: lane l of a group of G lanes
// owns the tile's columns [V l, V l + V) (4 f32 or 8 bf16 pixels, one
// 16-byte store), reads three 16-byte runs of the separable tile and takes
// the columns beside them from its neighbours by shuffle; the row's
// displacement once per row, the column's from its index (no division, no
// position).  Shared memory reads, not bytes or flops, set the pace of this
// stage, hence the shuffles.  No warped tile, no third barrier; rows that
// are not 16-byte aligned and a partial last tile go one pixel a lane.
// Shared memory: 41.3 KB in f32, 31.5 KB in bf16.

template <typename T>
struct WarpLayout {
  using S = SepLayout<T, 0>;
  // separable column j at SEP_OFF + j: output pixel x's column (j = x + 1)
  // is then 16-byte aligned where x is a multiple of 4
  static constexpr int SEP_OFF = 3;
  static constexpr int SEP_P = (SEP_OFF + S::COLS + 3) / 4 * 4;
  static constexpr int SRC_FLOATS = (S::SRC_BYTES + 15) / 16 * 4;
  static constexpr size_t BYTES =
      sizeof(float) * (SRC_FLOATS + S::ROWS * SEP_P) +
      sizeof(Tent) * (S::ROWS + S::COLS);
};

template <typename T>
__global__ void __launch_bounds__(32 * WF_WARPS, WF_BLOCKS_PER_SM)
warp_kernel(const T* __restrict__ in, const float* __restrict__ warps,
            T* __restrict__ out, int H, int W) {
  using L = WarpLayout<T>;
  using S = typename L::S;
  constexpr int V = 16 / sizeof(T);
  constexpr int G = WF_TX / V;  // lanes per output row
  constexpr int RPW = 32 / G;   // output rows per warp and pass
  extern __shared__ __align__(16) float w_smem[];
  T* src = reinterpret_cast<T*>(w_smem);
  float* sep = w_smem + L::SRC_FLOATS;
  Tent* srow = reinterpret_cast<Tent*>(sep + S::ROWS * L::SEP_P);
  Tent* scol = srow + S::ROWS;

  const int lane = threadIdx.x;
  const int wid = threadIdx.y;
  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * WF_TY;
  const int tx0 = blockIdx.x * WF_TX;
  const int ty_n = min(WF_TY, H - ty0);
  const int tx_n = min(WF_TX, W - tx0);
  const int nys = ty_n + 2;  // separable rows [ty0-1, ty0+ty_n+1)
  const int nxs = tx_n + 2;
  const T* img = in + (size_t)b * H * W;
  const WarpP w = load_warp(warps, b);
  const float cy = (H - 1) * 0.5f;
  const float cx = (W - 1) * 0.5f;

  // 1. the window's copies, then the tables while they fly
  const Window win = sep_window<S>(w, H, W, ty0 - 1, nys, tx0 - 1, nxs);
  if (win.smem) stage_window<S>(src, img, W, win, wid, lane);
  if (wid < 2) {
    tent_table<S>(wid == 0 ? srow : scol, wid == 0, wid == 0 ? ty0 - 1 : tx0 - 1,
                  wid == 0 ? nys : nxs, w, H, W, img, win, lane);
  }
  cp_async_wait<0>();
  __syncthreads();

  // 2. the separable tile
  float* s0 = sep + L::SEP_OFF;
  sep_tile_from(s0, L::SEP_P, srow, scol, nys, nxs, lane, wid, win, src, img);
  __syncthreads();

  // 3. the warped rows, straight to the output
  const float inv_ax = 1.f / w.a00;
  const float inv_ay = 1.f / w.a11;
  const int l = lane % G;
  const unsigned group = (0xffffffffu >> (32 - G)) << (lane - l);
  auto px = [&](int j, float ul, float uc, float ur, float ml, float mc,
                float mr, float dl, float dc, float dr, const WarpedAt& rf) {
    const int x = tx0 + j;
    const float dy = w.a10 * ((float)x - cx);
    return taylor_px(ul, uc, ur, ml, mc, mr, dl, dc, dr, rf.d, rf.dd, rf.edge,
                     dy, half_sq(dy), (x > 0) && (x < W - 1), inv_ax, inv_ay);
  };
  T* o = out + (size_t)b * H * W;
  for (int ly = wid * RPW + lane / G; ly < ty_n; ly += WF_WARPS * RPW) {
    const int y = ty0 + ly;
    const WarpedAt rf =
        warped_at(0, w.a01 * ((float)y - cy), (y > 0) && (y < H - 1));
    const float* m = s0 + (ly + 1) * L::SEP_P + 1;  // output column 0
    const float* u = m - L::SEP_P;
    const float* d = m + L::SEP_P;
    T* dst = o + (size_t)y * W + tx0;
    if (tx_n == WF_TX && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      // columns j - 1 .. j + V of the three rows; the two outer ones from
      // the neighbouring lanes, or, at the group's ends, shared memory
      const int j = l * V;
      float U[V + 2], M[V + 2], D[V + 2];
      ld_run<V>(u + j, U + 1);
      ld_run<V>(m + j, M + 1);
      ld_run<V>(d + j, D + 1);
      U[0] = __shfl_up_sync(group, U[V], 1, G);
      M[0] = __shfl_up_sync(group, M[V], 1, G);
      D[0] = __shfl_up_sync(group, D[V], 1, G);
      U[V + 1] = __shfl_down_sync(group, U[1], 1, G);
      M[V + 1] = __shfl_down_sync(group, M[1], 1, G);
      D[V + 1] = __shfl_down_sync(group, D[1], 1, G);
      if (l == 0) {
        U[0] = u[-1];
        M[0] = m[-1];
        D[0] = d[-1];
      } else if (l == G - 1) {
        U[V + 1] = u[WF_TX];
        M[V + 1] = m[WF_TX];
        D[V + 1] = d[WF_TX];
      }
      float v[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        v[e] = px(j + e, U[e], U[e + 1], U[e + 2], M[e], M[e + 1], M[e + 2],
                  D[e], D[e + 1], D[e + 2], rf);
      }
      st_vec(dst + j, v);
    } else {
      for (int j = l; j < tx_n; j += G) {
        stf(dst + j, px(j, u[j - 1], u[j], u[j + 1], m[j - 1], m[j], m[j + 1],
                        d[j - 1], d[j], d[j + 1], rf));
      }
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
//   1. the separable image's window (sep_window), its cp.async copies
//      (stage_window) and, while they fly, the tables: the tent taps
//      (tent_table) and per warped row and column the reflected sample's
//      separable offset, its displacement (WarpedAt) and its edge flag;
//   2. the separable image over the tile plus an R+1 ring (sep_tile);
//   3. the warped image over the tile plus an R ring (taylor_px, from the
//      tables' displacements; the ring beyond the image reflects the warped
//      image, pallas_ecc.py:406-437);
//   4. the horizontal filter pass (the plain twin's order), then the
//      vertical pass straight to the output, 16-byte stores where a row is
//      16-byte aligned (4 f32 or 8 bf16 pixels a lane), else one pixel a
//      lane; the warped output leaves stage 3 the same way.
// The stages share two regions: A holds the source window, then the warped
// tile; B the separable tile, then the horizontal pass.  Templated on the
// filter radius R, so every tap loop unrolls.

template <typename T, int R>
struct WfLayout {
  using S = SepLayout<T, R>;
  static constexpr int SEP_P = S::COLS;
  static constexpr int WRP_ROWS = WF_TY + 2 * R;
  static constexpr int WRP_COLS = WF_TX + 2 * R;
  // warped column j sits at WRP_OFF + j, so the tile's first column (j = R)
  // is 16-byte aligned for the vector reads of the warped output
  static constexpr int WRP_OFF = (4 - R % 4) % 4;
  static constexpr int WRP_P = (WRP_COLS + WRP_OFF + 3) / 4 * 4;
  static constexpr int HB_P = WF_TX + 4;
  static constexpr int SRC_FLOATS = (S::SRC_BYTES + 3) / 4;
  static constexpr int A_FLOATS =
      ((SRC_FLOATS > WRP_ROWS * WRP_P ? SRC_FLOATS : WRP_ROWS * WRP_P) + 3) /
      4 * 4;  // B starts 16-byte aligned
  static constexpr int B_RAW = (S::ROWS * SEP_P > WRP_ROWS * HB_P)
                                   ? S::ROWS * SEP_P
                                   : WRP_ROWS * HB_P;
  static constexpr int B_FLOATS = (B_RAW + 3) / 4 * 4;
  static constexpr size_t BYTES =
      sizeof(float) * (A_FLOATS + B_FLOATS) +
      sizeof(Tent) * (S::ROWS + S::COLS) +
      sizeof(WarpedAt) * (WRP_ROWS + WRP_COLS);
};

template <typename T, int R>
__global__ void __launch_bounds__(32 * WF_WARPS, WF_BLOCKS_PER_SM)
warp_filter_kernel(const T* __restrict__ in, const float* __restrict__ warps,
                   T* __restrict__ out, T* __restrict__ warped_out, int H,
                   int W, Taps taps) {
  using L = WfLayout<T, R>;
  using S = typename L::S;
  constexpr int K = 2 * R + 1;
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) float wf_smem[];
  float* A = wf_smem;
  float* Bs = A + L::A_FLOATS;
  Tent* srow = reinterpret_cast<Tent*>(Bs + L::B_FLOATS);
  Tent* scol = srow + S::ROWS;
  WarpedAt* wrow = reinterpret_cast<WarpedAt*>(scol + S::COLS);
  WarpedAt* wcol = wrow + L::WRP_ROWS;

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

  // 1. the window's copies into A, then the tables while they fly
  T* src = reinterpret_cast<T*>(A);
  const Window win = sep_window<S>(w, H, W, sr0, nys, sc0, nxs);
  if (win.smem) stage_window<S>(src, img, W, win, wid, lane);
  if (wid < 2) {
    tent_table<S>(wid == 0 ? srow : scol, wid == 0, wid == 0 ? sr0 : sc0,
                  wid == 0 ? nys : nxs, w, H, W, img, win, lane);
  } else if (wid == 2) {
    for (int i = lane; i < nyw; i += 32) {
      const int gy = reflect101(ty0 - R + i, H);
      wrow[i] = warped_at((gy - sr0) * L::SEP_P, w.a01 * ((float)gy - cy),
                          (gy > 0) && (gy < H - 1));
    }
  } else if (wid == 3) {
    for (int j = lane; j < nxw; j += 32) {
      const int gx = reflect101(tx0 - R + j, W);
      wcol[j] = warped_at(gx - sc0, w.a10 * ((float)gx - cx),
                          (gx > 0) && (gx < W - 1));
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 2. separable image into B
  sep_tile_from(Bs, L::SEP_P, srow, scol, nys, nxs, lane, wid, win, src, img);
  __syncthreads();

  // 3. warped image over the tile plus its R ring into A
  const float inv_ax = 1.f / w.a00;
  const float inv_ay = 1.f / w.a11;
  for (int k = tid; k < L::WRP_ROWS * L::WRP_COLS; k += 32 * WF_WARPS) {
    const int i = k / L::WRP_COLS;
    const int j = k - i * L::WRP_COLS;
    if (i >= nyw || j >= nxw) continue;
    const WarpedAt ry = wrow[i];
    const WarpedAt rx = wcol[j];
    const float* c = Bs + ry.off + rx.off;
    constexpr int P = L::SEP_P;
    A[i * L::WRP_P + L::WRP_OFF + j] =
        taylor_px(c[-P - 1], c[-P], c[-P + 1], c[-1], c[0], c[1], c[P - 1],
                  c[P], c[P + 1], ry.d, ry.dd, ry.edge, rx.d, rx.dd,
                  rx.edge, inv_ax, inv_ay);
  }
  __syncthreads();

  // 4a. the warped output; the horizontal pass into B
  if (warped_out) {
    T* wo = warped_out + (size_t)b * H * W;
    for (int ly = wid; ly < ty_n; ly += WF_WARPS) {
      const float* s = A + (ly + R) * L::WRP_P + L::WRP_OFF + R;
      write_row(wo + (size_t)(ty0 + ly) * W + tx0, tx_n, lane,
                    [&](int j) { return s[j]; },
                    [&](int j, float* v) { ld_run<V>(s + j, v); });
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

  // 4b. the vertical pass, straight to the output
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
                      float q[V];
                      ld_run<V>(s + k * L::HB_P + j, q);
#pragma unroll
                      for (int e = 0; e < V; ++e) v[e] += taps.t[k] * q[e];
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// The 42 statistics, factored per row (K3 and K9).  A thread sums the
// x-only terms of each row it owns -- sum f x^2, f x, f for the three
// Hessian products f = gx gx, gx gy, gy gy; g x, g for the six products g =
// gx t, gy t, gx i, gy i, gx, gy; the masked sums -- and mom_fold_row folds
// the row's f x, f and g sums with y and y^2 at the row's end, so no y term
// is formed per pixel.  The products share ax = gx x and ay = gy x (f x^2 =
// ax ax, ..., g x = ax t, ...).
struct MomSums {  // a thread's sums over its rows
  float fxx[3], fxy[3], fyy[3], fx[3], fy[3], f1[3];
  float gxs[6], gys[6], g1[6];
  float ms[6];
};
struct MomRow {  // one row's sums that mom_fold_row folds with y
  float rfx[3], rf[3], rg[6];
};

// the warped gradient from the undivided differences dh = i(x+1) - i(x-1)
// and dv = i(y+1) - i(y-1): gx = p dh + q dv, gy = r dh + s dv
struct GradCoef {
  float p, q, r, s;
};
__device__ __forceinline__ GradCoef grad_coef(const WarpP& w, float inv_det) {
  return {0.5f * w.a11 * inv_det, -0.5f * w.a10 * inv_det,
          -0.5f * w.a01 * inv_det, 0.5f * w.a00 * inv_det};
}

// one valid pixel at column xf: its differences, its warped value `mid`
// and its template value `tmv` (pallas_ecc.py:536-543)
__device__ __forceinline__ void mom_pixel(MomSums& a, MomRow& row, float dh,
                                          float dv, float mid, float tmv,
                                          float xf, float kshift,
                                          const GradCoef& c) {
  const float gx = c.p * dh + c.q * dv;
  const float gy = c.r * dh + c.s * dv;
  const float iv = mid - kshift;
  const float tv = tmv - kshift;
  const float ax = gx * xf;
  const float ay = gy * xf;
  a.fxx[0] += ax * ax;
  a.fxx[1] += ax * ay;
  a.fxx[2] += ay * ay;
  row.rfx[0] += ax * gx;
  row.rfx[1] += ax * gy;
  row.rfx[2] += ay * gy;
  row.rf[0] += gx * gx;
  row.rf[1] += gx * gy;
  row.rf[2] += gy * gy;
  a.gxs[0] += ax * tv;
  a.gxs[1] += ay * tv;
  a.gxs[2] += ax * iv;
  a.gxs[3] += ay * iv;
  a.gxs[4] += ax;
  a.gxs[5] += ay;
  row.rg[0] += gx * tv;
  row.rg[1] += gy * tv;
  row.rg[2] += gx * iv;
  row.rg[3] += gy * iv;
  row.rg[4] += gx;
  row.rg[5] += gy;
  a.ms[1] += tv;
  a.ms[2] += iv;
  a.ms[3] += tv * tv;
  a.ms[4] += iv * iv;
  a.ms[5] += tv * iv;
}

// the end of a valid row y with ncols valid columns of this thread
__device__ __forceinline__ void mom_fold_row(MomSums& a, const MomRow& row,
                                             float ncols, int y) {
  a.ms[0] += ncols;
  const float yf = (float)y;
  const float yy = yf * yf;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    a.fx[j] += row.rfx[j];
    a.f1[j] += row.rf[j];
    a.fxy[j] += yf * row.rfx[j];
    a.fy[j] += yf * row.rf[j];
    a.fyy[j] += yy * row.rf[j];
  }
#pragma unroll
  for (int n = 0; n < 6; ++n) {
    a.g1[n] += row.rg[n];
    a.gys[n] += yf * row.rg[n];
  }
}

// the (42,) layout of ecc_gn_moments
__device__ __forceinline__ void mom_stats(const MomSums& a, float* acc) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    acc[6 * q + 0] = a.fxx[q];
    acc[6 * q + 1] = a.fxy[q];
    acc[6 * q + 2] = a.fyy[q];
    acc[6 * q + 3] = a.fx[q];
    acc[6 * q + 4] = a.fy[q];
    acc[6 * q + 5] = a.f1[q];
  }
#pragma unroll
  for (int z = 0; z < 3; ++z) {  // [gx x, gy x, gx y, gy y, gx, gy] . z
    acc[18 + 6 * z + 0] = a.gxs[2 * z];
    acc[18 + 6 * z + 1] = a.gxs[2 * z + 1];
    acc[18 + 6 * z + 2] = a.gys[2 * z];
    acc[18 + 6 * z + 3] = a.gys[2 * z + 1];
    acc[18 + 6 * z + 4] = a.g1[2 * z];
    acc[18 + 6 * z + 5] = a.g1[2 * z + 1];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) acc[36 + k] = a.ms[k];
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

// sum of a block's per-thread accumulators (K3, K9): warp shuffles in f32,
// a thread's sums being short, then the warps in order in f64; thread
// 0..41 writes statistic k of the block's partial
template <int THREADS>
__device__ __forceinline__ void block_partial(const float* acc, int tid,
                                              double (*red)[NSTAT],
                                              double* __restrict__ out) {
  const int lane = tid & 31;
  const int wid = tid >> 5;
#pragma unroll
  for (int k = 0; k < NSTAT; ++k) {
    const double v = warp_sum(acc[k]);
    if (lane == 0) red[wid][k] = v;
  }
  __syncthreads();
  if (tid < NSTAT) {
    double s = 0.0;
    for (int i = 0; i < THREADS / 32; ++i) s += red[i][tid];
    out[tid] = s;
  }
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
               const float* __restrict__ mask_shift,
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
  WarpP m = load_warp(mask_warps, b);
  if (mask_shift != nullptr) {  // the integer pre-shift, composed as
    m.tx = __fadd_rn(m.tx, mask_shift[2 * b]);  // registration._mask_warp
    m.ty = __fadd_rn(m.ty, mask_shift[2 * b + 1]);
  }
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
  const GradCoef gc = grad_coef(w, inv_det);
  MomSums a = {};

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
    MomRow rs = {};
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (!(cols & (1u << k))) continue;
      const int e = e0 + k * MOM_THREADS;
      const float dh =
          (inner & (1u << k)) ? to_f(mid[e + 1]) - to_f(mid[e - 1]) : 0.f;
      mom_pixel(a, rs, dh, to_f(dn[e]) - to_f(up[e]), to_f(mid[e]),
                to_f(tr[e]), (float)(c0 + tid + k * MOM_THREADS), kshift, gc);
    }
    mom_fold_row(a, rs, ncols, y);
  }

  float acc[NSTAT];
  mom_stats(a, acc);
  const size_t blk = (size_t)blockIdx.y * gridDim.z + blockIdx.z;
  block_partial<MOM_THREADS>(
      acc, tid, red,
      partials + ((size_t)b * gridDim.y * gridDim.z + blk) * NSTAT);
}

// K3's update epilogue: the closed-form Gauss-Newton update of one lane
// from its 42 f32 statistics, in one thread.  Its twin is
// ecc_kernels.ecc_statistics_from_moments then registration._solve_update
// (torch ops on (B,) tensors, ~420 host launches a step).  Every product,
// sum, quotient and square root is rounded on its own in the twin's order
// (_sum6 left to right, chol_*_unrolled's loops), never contracted into an
// FMA, so the new warp, rho and |drho| equal the twin's on the card to the
// bit.  As torch's CUDA kernels do, `x / 6.0` is x times the f32
// reciprocal of 6 (torch on the CPU divides), and clamp_min passes NaN
// through.
struct GnUpdate {  // (B, 2, 3) warps and (B,) rho in; new warps, rho, drho out
  const float* warps;
  const float* rho_prev;
  float* new_warps;
  float* rho;
  float* drho;
};

__device__ __forceinline__ float clamp_min_f(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float sum6(const float* v) {
  float s = __fadd_rn(v[0], v[1]);
#pragma unroll
  for (int k = 2; k < 6; ++k) s = __fadd_rn(s, v[k]);
  return s;
}

__device__ __forceinline__ float dot6(const float* a, const float* b) {
  float p[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) p[k] = __fmul_rn(a[k], b[k]);
  return sum6(p);
}

// (L L^T) x = rhs by registration.chol_solve_unrolled's loops
__device__ __forceinline__ void chol_solve6(const float (*L)[6],
                                            const float* rhs, float* x) {
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = __fsub_rn(s, __fmul_rn(L[i][k], y[k]));
    y[i] = __fdiv_rn(s, L[i][i]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = __fsub_rn(s, __fmul_rn(L[k][i], x[k]));
    x[i] = __fdiv_rn(s, L[i][i]);
  }
}

__device__ __noinline__ void gn_update_lane(const float* st, int b,
                                            const GnUpdate& u) {
  // ecc_statistics_from_moments: the Hessian from the 18 moments of
  // a = gx gx, b = gx gy, c = gy gy, each [xx, xy, yy, x, y, 1]
  const float* a = st;
  const float* bb = st + 6;
  const float* c = st + 12;
  const float h[6][6] = {
      {a[0], bb[0], a[1], bb[1], a[3], bb[3]},
      {bb[0], c[0], bb[1], c[1], bb[3], c[3]},
      {a[1], bb[1], a[2], bb[2], a[4], bb[4]},
      {bb[1], c[1], bb[2], c[2], bb[4], c[4]},
      {a[3], bb[3], a[4], bb[4], a[5], bb[5]},
      {bb[3], c[3], bb[4], c[4], bb[5], c[5]}};
  const float area = clamp_min_f(st[36], 1.f);
  const float s_t = st[37], s_i = st[38], s_tt = st[39], s_ii = st[40],
              s_ti = st[41];
  const float t_mean = __fdiv_rn(s_t, area);
  const float i_mean = __fdiv_rn(s_i, area);
  float t_proj[6], i_proj[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    t_proj[k] = __fsub_rn(st[18 + k], __fmul_rn(t_mean, st[30 + k]));
    i_proj[k] = __fsub_rn(st[24 + k], __fmul_rn(i_mean, st[30 + k]));
  }
  const float iw_norm2 = __fsub_rn(s_ii, __fdiv_rn(__fmul_rn(s_i, s_i), area));
  const float corr = __fsub_rn(s_ti, __fdiv_rn(__fmul_rn(s_t, s_i), area));
  const float tmpl_norm = clamp_min_f(
      __fsqrt_rn(clamp_min_f(
          __fsub_rn(s_tt, __fdiv_rn(__fmul_rn(s_t, s_t), area)), 0.f)),
      (float)1e-12);

  // _solve_update: the regularised Cholesky, pivots clamped at 1e-30
  float diag[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) diag[i] = h[i][i];
  const float reg =
      __fadd_rn(__fmul_rn(__fmul_rn(sum6(diag), (float)1e-9),
                          __fdiv_rn(1.f, 6.f)),
                (float)1e-12);
  float L[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = __fadd_rn(h[i][j], __fmul_rn(reg, i == j ? 1.f : 0.f));
#pragma unroll
      for (int k = 0; k < j; ++k) s = __fsub_rn(s, __fmul_rn(L[i][k], L[j][k]));
      L[i][j] = i == j ? __fsqrt_rn(clamp_min_f(s, (float)1e-30))
                       : __fdiv_rn(s, L[j][j]);
    }
  }
  float hinv_i[6], hinv_t[6];
  chol_solve6(L, i_proj, hinv_i);
  chol_solve6(L, t_proj, hinv_t);
  const float num = __fsub_rn(iw_norm2, dot6(i_proj, hinv_i));
  float den = __fsub_rn(corr, dot6(t_proj, hinv_i));
  den = fabsf(den) > (float)1e-12 ? den : (float)1e-12;  // NaN too
  const float lam = __fdiv_rn(num, den);

  // dp = [a00 a10 a01 a11 tx ty] increments; a non-finite entry keeps its
  // warp's value
  const float* w = u.warps + 6 * b;
  float* nw = u.new_warps + 6 * b;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int e = (k & 1) * 3 + (k >> 1);  // dp[k]'s warp entry
    const float dp = __fsub_rn(__fmul_rn(lam, hinv_t[k]), hinv_i[k]);
    const float v = __fadd_rn(w[e], dp);
    nw[e] = isfinite(v) ? v : w[e];
  }
  float rho = __fdiv_rn(
      corr, clamp_min_f(__fmul_rn(tmpl_norm,
                                  __fsqrt_rn(clamp_min_f(iw_norm2, 0.f))),
                        (float)1e-12));
  rho = isfinite(rho) ? rho : -1.f;
  u.rho[b] = rho;
  u.drho[b] = fabsf(__fsub_rn(rho, u.rho_prev[b]));
}

// fixed-order f64 sum of the per-block partials -> (B, 128) f32; with
// UPDATE, then the lane's Gauss-Newton update from those f32 statistics
template <bool UPDATE>
__global__ void moments_reduce_kernel(const double* __restrict__ partials,
                                      float* __restrict__ out, int nblk,
                                      GnUpdate u) {
  __shared__ float st[NSTAT];
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  float v = 0.f;
  if (k < NSTAT) {
    double s = 0.0;
    const double* p = partials + (size_t)b * nblk * NSTAT + k;
    for (int i = 0; i < nblk; ++i) s += p[(size_t)i * NSTAT];
    v = (float)s;
    if (UPDATE) st[k] = v;
  }
  out[(size_t)b * 128 + k] = v;
  if (UPDATE) {
    __syncthreads();
    if (k == 0) gn_update_lane(st, b, u);
  }
}

// ---------------------------------------------------------------------------
// K9: one Gauss-Newton step's statistics straight from the UNWARPED image:
// K3's 42 statistics of K2's warped image, without the warped image.
// Replaces _gn_fused_kernel (pallas_ecc.py:968, via _gn_fused_batched
// :1044).  Bound: 97 flops a pixel (K2's 36 and K3's 61) against 67
// TFLOP/s of f32, above its bytes (8 B/pixel in f32: the image and the
// template; K2 then K3 move 16): instruction work bounds it, so the design
// does K2's and K3's work once a pixel and nothing more per pixel.
// Design:
//   - a block owns a strip of at most GN_TX columns (the frame's width cut
//     into equal strips, as K3's column chunks) and a band of whole GN_TY-
//     row chunks of one frame, and walks the band chunk by chunk; the
//     frame is the fastest grid index, so the blocks of one strip and band
//     in all B frames read the template's rows from L2.  gn_grid sizes the
//     bands from H and W alone (so a frame's statistics do not depend on
//     its batch) to about GN_FRAME_BLOCKS blocks a frame: 8 frames are one
//     wave of GN_BLOCKS_PER_SM blocks on 132 SMs (8 x 15 strips x 2 bands
//     of 608 rows at 1200x1800, 8 x 8 x 4 of 256 at 1024x1024);
//   - the separable image comes from K2's code: the chunk's source window
//     (sep_window) staged by stage_window's cp.async copies -- the next
//     chunk's in flight while the block computes this chunk's warped rows
//     and statistics -- the column tent table (tent_table) built once per
//     strip, the row table once per chunk, and sep_tile_from over the
//     chunk's new separable rows.  The route (staged window or global
//     memory) is chosen once per strip, since the column table's offsets
//     depend on it;
//   - the warped image: taylor_px from the 3x3 separable neighbourhood with
//     K2's displacements (the row's once per row, the column's from its
//     index), four columns a lane with 16-byte shared loads and stores,
//     into a shared tile;
//   - the halo: a chunk's statistics read warped rows y-1..y+1, which read
//     separable rows y-2..y+2.  The last four separable and two warped rows
//     of a chunk are the first of the next: they are moved to the top of
//     their tiles, not recomputed; only the band's first chunk computes its
//     upper ring;
//   - the statistics: K3's mom_pixel and mom_fold_row, half a warp a row,
//     a thread's 8 columns x = c0 + l + 16 q summed in K3's order (q
//     ascending) and folded once per row, the row's 8 template values
//     loaded at once; mask_col once per column and strip, mask_row once
//     per row;
//   - one block reduction per band (block_partial: f32 within a warp, f64
//     across warps); moments_reduce_kernel sums the partials in a fixed
//     order in f64 (no atomics: the same statistics from run to run).
// Two blocks an SM, at most 128 registers a thread (-Xptxas -v: 124 in
// f32, 120 in bf16, no spills): three (80 registers, 28 bytes of spill
// stores in f32) measured 2% slower at 1200x1800 and 12% at 1024x1024
// (PERF.md).  Instruction issue, not HBM, holds it: it takes about K2's
// plus K3's time, the HBM round trip it saves being no part of theirs.
// The warped values are K2's to the bit: the same tables, the same
// separable sums (sep_tile rounds each product and sum on its own) and the
// same taylor_px with the same displacements, none of it contracted into
// FMAs.  They stay f32 for bf16 images (the JAX kernel's _sep_rows_block
// widens too): they are the f32 values that bf16 K2 rounds at its store,
// so K9 in bf16 does not round where K2 then K3 rounds the warped image.

constexpr int GN_TX = 128;  // the widest strip
constexpr int GN_TY = 32;   // rows a chunk
// at most 128 registers a thread and 113 KB of shared memory a block
constexpr int GN_BLOCKS_PER_SM = 2;
// blocks a frame: 8 frames of GN_FRAME_BLOCKS blocks are one wave of
// GN_BLOCKS_PER_SM blocks on 132 SMs (gn_grid)
constexpr int GN_FRAME_BLOCKS = GN_BLOCKS_PER_SM * 132 / 8;
constexpr int GN_KMAX = GN_TX / 16;  // a thread's columns

// Shared memory: the staged source window, the separable tile (GN_TY + 4
// rows, the strip plus a 2-pixel ring), the warped tile (GN_TY + 2 rows,
// the strip plus a 1-pixel ring) and the tent tables.  A window's budget
// is |a00|, |a11| up to ~1.1 over the band's first chunk (GN_TY + 4
// separable rows).
template <typename T>
struct GnLayout {
  static constexpr int SEP_ROWS = GN_TY + 4;
  static constexpr int SEP_COLS = GN_TX + 4;
  static constexpr int SEP_P = SEP_COLS;
  static constexpr int WRP_ROWS = GN_TY + 2;
  // 16 mod 32 floats: the two half-warps of a warp read banks 16 apart
  static constexpr int WRP_P = (GN_TX + 2 + 15) / 32 * 32 + 16;
  static constexpr int SRC_ROWS = SEP_ROWS + 4;
  static constexpr int SRC_COLS = SEP_COLS + 6;
  static constexpr int V = 16 / sizeof(T);
  static constexpr int SRC_P = (SRC_COLS + 2 * (V - 1)) / V * V;
  static constexpr int SRC_FLOATS =
      (SRC_ROWS * SRC_P * (int)sizeof(T) + 15) / 16 * 4;
  static constexpr size_t BYTES =
      sizeof(float) * (SRC_FLOATS + SEP_ROWS * SEP_P + WRP_ROWS * WRP_P) +
      sizeof(Tent) * (SEP_ROWS + SEP_COLS);
};

template <typename T>
__global__ void __launch_bounds__(32 * WF_WARPS, GN_BLOCKS_PER_SM)
gn_fused_kernel(const T* __restrict__ imgs, const T* __restrict__ tmpl,
                const float* __restrict__ warps,
                const float* __restrict__ mask_warps,
                const float* __restrict__ kshift_p,
                double* __restrict__ partials, int H, int W, int band,
                int cw) {
  using L = GnLayout<T>;
  constexpr int SP = L::SEP_P;
  constexpr int WP = L::WRP_P;
  constexpr int NT = 32 * WF_WARPS;
  extern __shared__ __align__(16) float gn_smem[];
  __shared__ double red[WF_WARPS][NSTAT];
  T* src = reinterpret_cast<T*>(gn_smem);
  float* sep = gn_smem + L::SRC_FLOATS;
  float* wrp = sep + L::SEP_ROWS * SP;
  Tent* srow = reinterpret_cast<Tent*>(wrp + L::WRP_ROWS * WP);
  Tent* scol = srow + L::SEP_ROWS;

  const int lane = threadIdx.x;
  const int wid = threadIdx.y;
  const int tid = wid * 32 + lane;
  const int b = blockIdx.x;
  const int by0 = blockIdx.y * band;  // the band's rows [by0, by1)
  const int by1 = min(by0 + band, H);
  const int nchunks = (by1 - by0 + GN_TY - 1) / GN_TY;
  const int c0 = blockIdx.z * cw;  // the strip's columns [c0, c1)
  const int c1 = min(W, c0 + cw);
  const int nxs = c1 - c0 + 4;  // separable columns [c0 - 2, c1 + 2)
  const int nxw = c1 - c0 + 2;  // warped columns [c0 - 1, c1 + 1)
  const T* img = imgs + (size_t)b * H * W;
  const WarpP w = load_warp(warps, b);
  const WarpP m = load_warp(mask_warps, b);
  const float cy = (H - 1) * 0.5f;
  const float cx = (W - 1) * 0.5f;

  // chunk k: output rows [r0, r0 + n); its new separable rows [s0, s0 +
  // ns): the band's first chunk's include its upper ring, the others' start
  // below the four rows they carry
  struct Chunk {
    int r0, n, s0, ns;
  };
  auto chunk = [&](int k) {
    Chunk c;
    c.r0 = by0 + k * GN_TY;
    c.n = min(GN_TY, by1 - c.r0);
    c.s0 = k == 0 ? c.r0 - 2 : c.r0 + 2;
    c.ns = k == 0 ? c.n + 4 : c.n;
    return c;
  };
  auto window = [&](int k) {
    const Chunk c = chunk(k);
    return sep_window<L>(w, H, W, c.s0, c.ns, c0 - 2, nxs);
  };
  // the strip's route: the staged windows only if every chunk's fits
  bool fits = true;
  for (int k = tid; k < nchunks; k += NT) fits = fits && window(k).smem;
  const bool smem = __syncthreads_and(fits);
  Window win = window(0);
  win.smem = smem;
  if (smem) stage_window<L>(src, img, W, win, wid, lane);
  if (wid == 0) tent_table<L>(scol, false, c0 - 2, nxs, w, H, W, img, win, lane);

  // this thread's columns x = c0 + l + 16 q: bit q of `cols` if the mask
  // warp keeps x, of `inner` if x has both neighbours
  const int half = lane >> 4;
  const int l = lane & 15;
  unsigned cols = 0, inner = 0;
#pragma unroll
  for (int q = 0; q < GN_KMAX; ++q) {
    const int x = c0 + l + 16 * q;
    if (x < c1 && mask_col(m, x, W, cy)) cols |= 1u << q;
    if (x > 0 && x < W - 1) inner |= 1u << q;
  }
  const float ncols = (float)__popc(cols);
  const float kshift = *kshift_p;
  const float inv_det = 1.f / (w.a00 * w.a11 - w.a01 * w.a10);
  const GradCoef gc = grad_coef(w, inv_det);
  const float inv_ax = 1.f / w.a00;
  const float inv_ay = 1.f / w.a11;
  MomSums a = {};

  for (int k = 0; k < nchunks; ++k) {
    const Chunk c = chunk(k);
    cp_async_wait<0>();
    __syncthreads();  // this chunk's window staged; the last chunk done
    // 1. the carried rows to the top of their tiles, this chunk's row
    //    table
    if (k > 0) {
      for (int i = tid; i < 4 * nxs; i += NT) {
        const int r = i / nxs;
        const int j = i - r * nxs;
        sep[r * SP + j] = sep[(GN_TY + r) * SP + j];
      }
      for (int i = tid; i < 2 * nxw; i += NT) {
        const int r = i / nxw;
        const int j = i - r * nxw;
        wrp[r * WP + j] = wrp[(GN_TY + r) * WP + j];
      }
    }
    if (wid == 0) {
      Window cur = window(k);
      cur.smem = smem;
      tent_table<L>(srow, true, c.s0, c.ns, w, H, W, img, cur, lane);
    }
    __syncthreads();

    // 2. the new separable rows: separable row r0 - 2 + i at tile row i
    sep_tile_from(sep + (c.s0 - (c.r0 - 2)) * SP, SP, srow, scol, c.ns, nxs,
                  lane, wid, win, src, img);
    __syncthreads();
    // the next chunk's window in flight from here to the next chunk
    if (smem && k + 1 < nchunks) {
      stage_window<L>(src, img, W, window(k + 1), wid, lane);
    }

    // 3. the new warped rows: warped row r0 - 1 + i at tile row i, column
    //    c0 - 1 + j at j, its separable centre at (i + 1, j + 1); zero
    //    outside the image (never read: the outer ring has no central
    //    difference).  A warp takes a row, lane l its columns [4 l, 4 l +
    //    4): it reads the six separable columns they need from each of
    //    three rows as 16- and 8-byte loads and stores the four warped
    //    values as one; the row's displacement once per row, the column's
    //    from its index, as K2 (warp_kernel)
    for (int i = (k == 0 ? 0 : 2) + wid; i < c.n + 2; i += WF_WARPS) {
      const int y = c.r0 - 1 + i;
      const WarpedAt rf =
          warped_at(0, w.a01 * ((float)y - cy), (y > 0) && (y < H - 1));
      const bool yin = y >= 0 && y < H;
      auto px = [&](int j, const float* u, const float* m, const float* d) {
        const int x = c0 - 1 + j;
        if (!yin || x < 0 || x >= W) return 0.f;
        const float dy = w.a10 * ((float)x - cx);
        return taylor_px(u[0], u[1], u[2], m[0], m[1], m[2], d[0], d[1], d[2],
                         rf.d, rf.dd, rf.edge, dy, half_sq(dy),
                         (x > 0) && (x < W - 1), inv_ax, inv_ay);
      };
      const float* s = sep + i * SP;  // separable row i, the row above
      float* o = wrp + i * WP;
      const int j0 = 4 * lane;
      if (j0 < nxw) {
        float q[3][6];
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          ld_run<4>(s + u * SP + j0, q[u]);
          const float2 t = *reinterpret_cast<const float2*>(s + u * SP + j0 + 4);
          q[u][4] = t.x;
          q[u][5] = t.y;
        }
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = px(j0 + e, q[0] + e, q[1] + e, q[2] + e);
        if (j0 + 4 <= nxw) {
          st_vec(o + j0, v);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j0 + e < nxw) o[j0 + e] = v[e];
          }
        }
      }
      // the columns past 128 (a 128-column strip's ring), one a lane
      for (int j = 4 * 32 + lane; j < nxw; j += 32) {
        o[j] = px(j, s + j, s + SP + j, s + 2 * SP + j);
      }
    }
    __syncthreads();

    // 4. the statistics of rows [r0, r0 + n), half a warp a row; on the
    //    outer rows up = dn = mid, so dv = 0 there
    for (int ly = 2 * wid + half; ly < c.n; ly += 2 * WF_WARPS) {
      const int y = c.r0 + ly;
      if (!mask_row(m, y, H, cx)) continue;
      const bool gmask = (y > 0) && (y < H - 1);
      const float* mid = wrp + (ly + 1) * WP + 1;  // column c0 at mid[0]
      const float* up = gmask ? mid - WP : mid;
      const float* dn = gmask ? mid + WP : mid;
      // the row's template values, every load in flight at once
      const T* tr = tmpl + (size_t)y * W + c0;
      float tv[GN_KMAX];
#pragma unroll
      for (int q = 0; q < GN_KMAX; ++q) tv[q] = ldf(tr + min(l + 16 * q, c1 - c0 - 1));
      MomRow rs = {};
#pragma unroll
      for (int q = 0; q < GN_KMAX; ++q) {
        if (!(cols & (1u << q))) continue;
        const int e = l + 16 * q;
        const float dh = (inner & (1u << q)) ? mid[e + 1] - mid[e - 1] : 0.f;
        mom_pixel(a, rs, dh, dn[e] - up[e], mid[e], tv[q], (float)(c0 + e),
                  kshift, gc);
      }
      mom_fold_row(a, rs, ncols, y);
    }
  }

  float acc[NSTAT];
  mom_stats(a, acc);
  const size_t blk = (size_t)blockIdx.y * gridDim.z + blockIdx.z;
  block_partial<NT>(
      acc, tid, red,
      partials + ((size_t)b * gridDim.y * gridDim.z + blk) * NSTAT);
}

// ---------------------------------------------------------------------------
// K6: hot-pixel repair.  A pixel >= thresh whose value exceeds the median
// of its 4-neighbours (the 2nd smallest of the 3 or 2 that exist at edges
// and corners) by more than min_change takes that median; a frame with
// more than max_hot pixels >= thresh is left as it is.
// Replaces _hot_kernel (pallas_ecc.py:659, via _hot_batched :739).
// Bound: 8 B/pixel (one read, one write), no arithmetic to speak of.  The
// TPU kernel holds a whole frame in VMEM and counts it before it repairs
// it; here a frame spans many blocks, so the count is known only once every
// block has seen its part.  The work is split so that each frame is read
// and written once:
//   - hot_scan_kernel streams the frame with 16-byte loads and stores
//     (HOT_UNROLL vectors a thread in flight), copying it to `out`
//     unchanged, and counts the pixels >= thresh.  Each block keeps the
//     first max_hot candidates it meets in a shared list (one shared
//     atomic a warp, only in a warp that met one); at its end it adds its
//     count to the frame's with ONE global atomic, which returns the
//     block's base slot, and copies its list into the frame's max_hot
//     slots from there.  Integer sums do not depend on order, so the count
//     is exact; an all-saturated frame costs one global atomic a block, as
//     a clean one does.  When the frame's count is <= max_hot, every block
//     had all its candidates in its list and every one got a slot.
//   - hot_repair_kernel, one warp a frame: if the count is <= max_hot, each
//     listed candidate takes the median of its neighbours read from `in`
//     (never a repaired `out`, so adjacent hot pixels and the list's order
//     do not matter: the twin repairs against the original frame too).
// Blocks stride over the frame's tiles, sized so the grid is one wave.

constexpr int HOT_THREADS = 256;
constexpr int HOT_UNROLL = 4;  // 16-byte vectors a thread per tile
constexpr int HOT_TILE = HOT_THREADS * HOT_UNROLL * 4;  // pixels a tile
constexpr int HOT_MAX_LIST = 32;  // the most max_hot the lists hold

template <bool VEC>
__global__ void __launch_bounds__(HOT_THREADS)
hot_scan_kernel(const float* __restrict__ in, float* __restrict__ out,
                int* __restrict__ counts, int* __restrict__ cands,
                long long hw, float thresh, int max_hot) {
  __shared__ int s_n;
  __shared__ int s_list[HOT_MAX_LIST];
  const int b = blockIdx.y;
  const float* img = in + (size_t)b * hw;
  float* o = out + (size_t)b * hw;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  for (long long t0 = (long long)blockIdx.x * HOT_TILE; t0 < hw;
       t0 += (long long)gridDim.x * HOT_TILE) {
    // pixel u * 4 + e of this thread's tile part: VEC, vector u of the
    // thread (16 bytes at t0 + (u * HOT_THREADS + tid) * 4); else element
    // t0 + (u * 4 + e) * HOT_THREADS + tid
    float v[HOT_UNROLL * 4];
    long long base[HOT_UNROLL];
#pragma unroll
    for (int u = 0; u < HOT_UNROLL; ++u) {
      base[u] = t0 + ((long long)u * HOT_THREADS + threadIdx.x) * 4;
      if (VEC) {
        if (base[u] < hw) {  // hw % 4 == 0: the vector is whole
          const float4 q = __ldg(reinterpret_cast<const float4*>(img + base[u]));
          v[4 * u] = q.x;
          v[4 * u + 1] = q.y;
          v[4 * u + 2] = q.z;
          v[4 * u + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long i = t0 + (long long)(u * 4 + e) * HOT_THREADS + threadIdx.x;
          if (i < hw) v[4 * u + e] = __ldg(img + i);
        }
      }
    }
    unsigned mask = 0;
#pragma unroll
    for (int u = 0; u < HOT_UNROLL; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long i =
            VEC ? base[u] + e
                : t0 + (long long)(u * 4 + e) * HOT_THREADS + threadIdx.x;
        if (i < hw && v[4 * u + e] >= thresh) mask |= 1u << (4 * u + e);
      }
      if (VEC) {
        if (base[u] < hw) {
          *reinterpret_cast<float4*>(o + base[u]) =
              make_float4(v[4 * u], v[4 * u + 1], v[4 * u + 2], v[4 * u + 3]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long i = t0 + (long long)(u * 4 + e) * HOT_THREADS + threadIdx.x;
          if (i < hw) o[i] = v[4 * u + e];
        }
      }
    }
    if (__any_sync(0xffffffffu, mask)) {  // rare: a warp met a candidate
      const int n = __popc(mask);
      int incl = n;  // inclusive prefix over the warp's lanes
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      int wbase = 0;
      if (lane == 31) wbase = atomicAdd(&s_n, incl);
      int slot = __shfl_sync(0xffffffffu, wbase, 31) + incl - n;
      while (mask) {
        const int k = __ffs(mask) - 1;
        mask &= mask - 1;
        if (slot < max_hot) {
          const int u = k >> 2, e = k & 3;
          s_list[slot] = (int)(VEC ? base[u] + e
                                   : t0 + (long long)k * HOT_THREADS + threadIdx.x);
        }
        ++slot;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int n = s_n;
    const int first = atomicAdd(counts + b, n);
    for (int j = 0; j < n && first + j < max_hot; ++j) {
      cands[(size_t)b * max_hot + first + j] = s_list[j];
    }
  }
}

// torch.minimum / torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// one warp a frame (blockIdx.x); lane j repairs the frame's j-th candidate
__global__ void hot_repair_kernel(const float* __restrict__ in,
                                  const int* __restrict__ counts,
                                  const int* __restrict__ cands,
                                  float* __restrict__ out, int H, int W,
                                  float min_change, int max_hot) {
  const int b = blockIdx.x;
  const int n = counts[b];
  if (n > max_hot || (int)threadIdx.x >= n) return;
  const long long hw = (long long)H * W;
  const float* img = in + (size_t)b * hw;
  const long long i = cands[(size_t)b * max_hot + threadIdx.x];
  const float x = img[i];
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
  if (x - median > min_change) out[(size_t)b * hw + i] = median;
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

// launchers of the image-type templates (T = float or bf16)

// K1's grid: (column groups of BLUR_THREADS x V columns, strips of `strip`
// rows, frames).  The strip height makes the grid one wave of the resident
// blocks of every SM (an output pixel does not depend on it).
template <typename T, int R>
int launch_blur_r(const T* in, T* out, int B, int H, int W, Taps taps,
                  void* stream) {
  static int occ = 0;  // resident blocks an SM
  static int sms = 0;
  constexpr int V = 16 / sizeof(T);
  if (sms == 0) {
    int dev, n;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, blur_kernel<T, R>, BLUR_THREADS, 0);
    }
    if (err != cudaSuccess) return (int)err;
    sms = n;
  }
  const int ncol = (W + BLUR_THREADS * V - 1) / (BLUR_THREADS * V);
  const long long per_frame = (long long)max(occ, 1) * sms / ((long long)B * ncol);
  const int strips = (int)max(1LL, min(per_frame, (long long)H));
  const int strip = (H + strips - 1) / strips;
  const dim3 grid(ncol, (H + strip - 1) / strip, B);
  blur_kernel<T, R><<<grid, BLUR_THREADS, 0, (cudaStream_t)stream>>>(
      in, out, H, W, strip, taps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_blur(const T* in, T* out, int B, int H, int W, Taps taps,
                void* stream) {
  switch (taps.k) {
    case 1:
      return launch_blur_r<T, 0>(in, out, B, H, W, taps, stream);
    case 3:
      return launch_blur_r<T, 1>(in, out, B, H, W, taps, stream);
    case 5:
      return launch_blur_r<T, 2>(in, out, B, H, W, taps, stream);
    case 7:
      return launch_blur_r<T, 3>(in, out, B, H, W, taps, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

dim3 wf_grid(int B, int H, int W) {
  return dim3((W + WF_TX - 1) / WF_TX, (H + WF_TY - 1) / WF_TY, B);
}

template <typename T>
int launch_warp(const T* in, const float* warps, T* out, int B, int H, int W,
                void* stream) {
  static size_t allowed = 0;
  const size_t smem = WarpLayout<T>::BYTES;
  const cudaError_t err = allow_smem(warp_kernel<T>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  warp_kernel<T><<<wf_grid(B, H, W), dim3(32, WF_WARPS), smem,
                   (cudaStream_t)stream>>>(in, warps, out, H, W);
  return (int)cudaGetLastError();
}

template <typename T, int R>
int launch_wf(const T* in, const float* warps, T* out, T* warped, int B,
              int H, int W, Taps taps, void* stream) {
  static size_t allowed = 0;
  const size_t smem = WfLayout<T, R>::BYTES;
  const cudaError_t err = allow_smem(warp_filter_kernel<T, R>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  warp_filter_kernel<T, R><<<wf_grid(B, H, W), dim3(32, WF_WARPS), smem,
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

// K3; with u.warps set (upsp_ecc_moments_update), the reduce stage's
// update epilogue too, the statistics masked by `warps` with `mask_shift`
// (nullable) composed into its translation
template <typename T>
int launch_moments(const T* iws, const T* tmpl, const float* warps,
                   const float* mask_warps, const float* mask_shift,
                   const float* kshift, double* partials, float* out,
                   const GnUpdate& u, int B, int H, int W, void* stream) {
  static size_t allowed = 0;
  int cw;
  const dim3 grid = mom_grid(B, H, W, &cw);
  const size_t smem =
      sizeof(T) * (MOM_IMG_SLOTS + MOM_TMPL_SLOTS) * mom_pitch<T>(cw);
  cudaError_t err = allow_smem(moments_kernel<T>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  moments_kernel<T><<<grid, MOM_THREADS, smem, (cudaStream_t)stream>>>(
      iws, tmpl, warps, mask_warps, kshift, mask_shift, partials, H, W, cw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (u.warps != nullptr) {
    moments_reduce_kernel<true><<<B, 128, 0, (cudaStream_t)stream>>>(
        partials, out, grid.y * grid.z, u);
  } else {
    moments_reduce_kernel<false><<<B, 128, 0, (cudaStream_t)stream>>>(
        partials, out, grid.y * grid.z, u);
  }
  return (int)cudaGetLastError();
}

// K9's grid: (frames, bands of `band` rows, strips of `cw` <= GN_TX
// columns): about GN_FRAME_BLOCKS blocks a frame, each band a whole
// number of chunks, from H and W alone
dim3 gn_grid(int B, int H, int W, int* band, int* cw) {
  const int ncol = (W + GN_TX - 1) / GN_TX;
  *cw = (W + ncol - 1) / ncol;
  const int bands = max(1, GN_FRAME_BLOCKS / ncol);
  const int chunks = ((H + bands - 1) / bands + GN_TY - 1) / GN_TY;
  *band = max(1, chunks) * GN_TY;
  return dim3(B, (H + *band - 1) / *band, ncol);
}

template <typename T>
int launch_gn_fused(const T* imgs, const T* tmpl, const float* warps,
                    const float* mask_warps, const float* kshift,
                    double* partials, float* out, int B, int H, int W,
                    void* stream) {
  static size_t allowed = 0;
  int band, cw;
  const dim3 grid = gn_grid(B, H, W, &band, &cw);
  const size_t smem = GnLayout<T>::BYTES;
  cudaError_t err = allow_smem(gn_fused_kernel<T>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  gn_fused_kernel<T><<<grid, dim3(32, WF_WARPS), smem, (cudaStream_t)stream>>>(
      imgs, tmpl, warps, mask_warps, kshift, partials, H, W, band, cw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moments_reduce_kernel<false><<<B, 128, 0, (cudaStream_t)stream>>>(
      partials, out, grid.y * grid.z, GnUpdate{});
  return (int)cudaGetLastError();
}

// K6's grid: (blocks a frame, frames), one wave of resident blocks in all;
// the vector route when every frame starts 16-byte aligned
int launch_hot(const float* in, int* lists, float* out, int B, int H, int W,
               float thresh, float min_change, int max_hot, void* stream) {
  static int occ = 0;  // resident blocks an SM (the same for both routes)
  static int sms = 0;
  if (max_hot < 0 || max_hot > HOT_MAX_LIST) return (int)cudaErrorInvalidValue;
  if (sms == 0) {
    int dev, n;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, hot_scan_kernel<true>, HOT_THREADS, 0);
    }
    if (err != cudaSuccess) return (int)err;
    sms = n;
  }
  const long long hw = (long long)H * W;
  const long long tiles = (hw + HOT_TILE - 1) / HOT_TILE;
  const long long per_frame = (long long)max(occ, 1) * sms / B;
  const dim3 grid((unsigned)max(1LL, min(per_frame, tiles)), B);
  int* counts = lists;
  int* cands = lists + B;
  const bool vec = hw % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(in) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) {
    hot_scan_kernel<true><<<grid, HOT_THREADS, 0, (cudaStream_t)stream>>>(
        in, out, counts, cands, hw, thresh, max_hot);
  } else {
    hot_scan_kernel<false><<<grid, HOT_THREADS, 0, (cudaStream_t)stream>>>(
        in, out, counts, cands, hw, thresh, max_hot);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hot_repair_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      in, counts, cands, out, H, W, min_change, max_hot);
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
  int band, cw;
  const dim3 g = gn_grid(1, H, W, &band, &cw);
  return (int)(g.y * g.z);
}

// K9's registers a thread and local (spilled) bytes, as the compiler
// built it; bf16_images selects the bfloat16 instantiation
int upsp_ecc_gn_fused_attrs(int bf16_images, int* regs, int* local_bytes) {
  cudaFuncAttributes at;
  const cudaError_t err =
      bf16_images ? cudaFuncGetAttributes(&at, gn_fused_kernel<bf16>)
                  : cudaFuncGetAttributes(&at, gn_fused_kernel<float>);
  if (err != cudaSuccess) return (int)err;
  *regs = at.numRegs;
  *local_bytes = (int)at.localSizeBytes;
  return 0;
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
  return launch_moments(iws, tmpl, warps, mask_warps, nullptr, kshift,
                        partials, out, GnUpdate{}, B, H, W, stream);
}
int upsp_ecc_moments_bf16(const bf16* iws, const bf16* tmpl,
                          const float* warps, const float* mask_warps,
                          const float* kshift, double* partials, float* out,
                          int B, int H, int W, void* stream) {
  return launch_moments(iws, tmpl, warps, mask_warps, nullptr, kshift,
                        partials, out, GnUpdate{}, B, H, W, stream);
}

// One Gauss-Newton step after K2: K3's statistics of the warped images
// (masked by `warps` with the (B, 2) pre-shift `valid_shift` composed in;
// nullable) into `out`, and the update from them: the (B, 2, 3) new
// warps, (B,) rho and |rho - rho_prev|
int upsp_ecc_moments_update(const float* iws, const float* tmpl,
                            const float* warps, const float* valid_shift,
                            const float* kshift, const float* rho_prev,
                            double* partials, float* out, float* new_warps,
                            float* rho, float* drho, int B, int H, int W,
                            void* stream) {
  return launch_moments(iws, tmpl, warps, warps, valid_shift, kshift,
                        partials, out,
                        GnUpdate{warps, rho_prev, new_warps, rho, drho}, B, H,
                        W, stream);
}
int upsp_ecc_moments_update_bf16(const bf16* iws, const bf16* tmpl,
                                 const float* warps, const float* valid_shift,
                                 const float* kshift, const float* rho_prev,
                                 double* partials, float* out,
                                 float* new_warps, float* rho, float* drho,
                                 int B, int H, int W, void* stream) {
  return launch_moments(iws, tmpl, warps, warps, valid_shift, kshift,
                        partials, out,
                        GnUpdate{warps, rho_prev, new_warps, rho, drho}, B, H,
                        W, stream);
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

// `lists` is (B * (1 + max_hot),) int32: the B counts, which must hold
// zeros on entry, then B lists of max_hot candidate slots
int upsp_ecc_hot(const float* in, int* lists, float* out, int B, int H,
                 int W, float thresh, float min_change, int max_hot,
                 void* stream) {
  return launch_hot(in, lists, out, B, H, W, thresh, min_change, max_hot,
                    stream);
}

}  // extern "C"
