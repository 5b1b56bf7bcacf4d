// Hopper kernel for the combined best-view projection gather of phase 1.
//
//   K5 gather  <- _slab_gather_apply (upsp_tpu/ops/pallas_gather.py:251)
//
// Per frame b and model node n, with p = superseded_by[n] (the node that
// n's overlap supersession copies):
//
//   out[b, n] = NaN                                          if skipped[p]
//             = frames[b, combined_index[p]] * combined_weight[p]  else
//
// which is the port's plain tail (gather, NaN for skipped nodes, overlap
// supersession; upsp_tpu_torch/ops/gather_kernels.py gather_plain) in one
// pass.  The patch overlays go on afterwards, as a small torch index step.
// The frames are float32 or bfloat16 (the compute_dtype=bfloat16 path); a
// bf16 pixel widens exactly to f32 before the multiply, as the TPU kernel's
// astype(float32) does (pallas_gather.py:328), and the output is float32.
//
// The TPU kernel exists because a TPU gathers 1M scattered indices slowly:
// it re-sorts nodes by 8-row image slab, streams each slab through VMEM
// and writes SLOT order, which the host un-permutes.  The port keeps the
// contract and not the slot order: this kernel writes model order
// directly, and nothing is un-permuted on the host.
//
// What bounds it on the H100: sectors, not bytes.  Per node and frame it
// reads one float of a frame batch far larger than L2 and writes one
// float; a scattered read moves a whole 32-byte sector.  The design:
//   - Tiles in model order.  The plan (built once, ops/gather_kernels.py)
//     cuts the nodes into tiles of GATHER_TILE consecutive model-order
//     nodes and sorts each tile's entries by source pixel.  A block owns
//     one tile: it reads the tile's plan entries once (coalesced, kept in
//     registers for all B frames), gathers each frame's values into shared
//     memory at node - tile start, and writes the tile's contiguous range
//     of out[b] with 16-byte stores.  The stores are coalesced whatever the
//     plan's geometry; within a tile the reads go in address order, so
//     nodes that share a sector are read together.
//   - The frames are read where they are.  The C cameras' images come as
//     up to MAX_CAMS base pointers passed by value in the kernel's
//     arguments: C (B, H, W) tensors, or one (B, C*H*W) stack as a single
//     "camera"; a camera's frames lie hw = H*W (C*H*W) pixels apart.  The plan's flat source index
//     into C*H*W splits into camera and pixel once per entry, not per
//     frame.  Nothing is stacked and nothing is copied to the device.
//   - Frame b+1's loads are issued before frame b's tile is stored, and
//     the two shared buffers alternate, so one barrier a frame suffices.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libupsp_gather.so gather.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include "image_io.cuh"

namespace {

// 4096 nodes a tile, 4 a thread: on the full configuration's plan this ran
// faster in f32 than tiles of 1024 or 2048 nodes and than 512 threads a
// tile (PERF.md)
constexpr int THREADS = 1024;
constexpr int TILE = 4096;  // model-order nodes a block (GATHER_TILE)
constexpr int PER_THREAD = TILE / THREADS;
constexpr int MAX_CAMS = 8;  // GATHER_MAX_CAMS

template <typename T>
struct Cams {
  const T* p[MAX_CAMS];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_kernel(Cams<T> cams, int n_cams, int hw,
              const int* __restrict__ src, const float* __restrict__ weight,
              const int* __restrict__ node, float* __restrict__ out, int n,
              int B) {
  __shared__ float buf[2][TILE];
  const int t0 = blockIdx.x * TILE;
  const int len = min(TILE, n - t0);
  const float nan = __int_as_float(0x7fc00000);
  // entry t0 + k * THREADS + tid of the plan: its pixel (nullptr for a
  // skipped node), weight and place in the tile (-1 past the tile's end)
  const T* px[PER_THREAD];
  float w[PER_THREAD];
  int dst[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int j = k * THREADS + threadIdx.x;
    dst[k] = -1;
    px[k] = nullptr;
    w[k] = 0.f;
    if (j < len) {
      const int s = src[t0 + j];
      w[k] = weight[t0 + j];
      dst[k] = node[t0 + j] - t0;
      if (s >= 0) {
        const int c = s / hw;
        const T* base = cams.p[0];
#pragma unroll
        for (int q = 1; q < MAX_CAMS; ++q) {
          if (q < n_cams && c == q) base = cams.p[q];
        }
        px[k] = base + (s - c * hw);
      }
    }
  }
  float v[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    v[k] = (dst[k] >= 0 && px[k] != nullptr) ? ldf(px[k]) : 0.f;
  }
  for (int b = 0; b < B; ++b) {
    float* sb = buf[b & 1];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      if (dst[k] >= 0) sb[dst[k]] = px[k] != nullptr ? __fmul_rn(v[k], w[k]) : nan;
    }
    if (b + 1 < B) {  // the next frame's loads fly while this tile stores
      const long long off = (long long)(b + 1) * hw;
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        v[k] = (dst[k] >= 0 && px[k] != nullptr) ? ldf(px[k] + off) : 0.f;
      }
    }
    __syncthreads();
    float* o = out + (size_t)b * n + t0;
    // floats before the first 16-byte boundary, then whole vectors, then
    // the tail
    const int head =
        min(len, (int)((4 - ((reinterpret_cast<uintptr_t>(o) >> 2) & 3)) & 3));
    const int nvec = (len - head) >> 2;
    if ((int)threadIdx.x < head) o[threadIdx.x] = sb[threadIdx.x];
    for (int q = threadIdx.x; q < nvec; q += THREADS) {
      const float* s4 = sb + head + 4 * q;
      *reinterpret_cast<float4*>(o + head + 4 * q) =
          make_float4(s4[0], s4[1], s4[2], s4[3]);
    }
    for (int i = head + 4 * nvec + threadIdx.x; i < len; i += THREADS) {
      o[i] = sb[i];
    }
    // the next frame writes the other buffer; the one after it writes this
    // one only after the next barrier, when every thread has stored it
  }
}

template <typename T>
int launch_gather(const void* const* cams, int n_cams, int hw, const int* src,
                  const float* weight, const int* node, float* out, int n,
                  int B, int tile, void* stream) {
  if (tile != TILE || n_cams < 1 || n_cams > MAX_CAMS || hw < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Cams<T> c;
  for (int q = 0; q < MAX_CAMS; ++q) {
    c.p[q] = static_cast<const T*>(cams[q < n_cams ? q : 0]);
  }
  const unsigned int blocks = (unsigned int)((n + TILE - 1) / TILE);
  gather_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      c, n_cams, hw, src, weight, node, out, n, B);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface: enqueues on `stream`, does not synchronise, allocates
// nothing, returns cudaGetLastError().  `cams` is a host array of n_cams
// (<= 8) device pointers, float32 (upsp_gather) or bfloat16
// (upsp_gather_bf16): camera c's frame b starts at cams[c] + b * hw, and
// the plan's source s reads pixel s % hw of camera s / hw.  `out` is (B, n) float32; src/weight/node are the plan's (n,)
// arrays, cut into tiles of `tile` nodes (the kernel's GATHER_TILE).

extern "C" {

int upsp_gather(const void* const* cams, int n_cams, int hw, const int* src,
                const float* weight, const int* node, float* out, int n, int B,
                int tile, void* stream) {
  return launch_gather<float>(cams, n_cams, hw, src, weight, node, out, n, B,
                              tile, stream);
}

int upsp_gather_bf16(const void* const* cams, int n_cams, int hw,
                     const int* src, const float* weight, const int* node,
                     float* out, int n, int B, int tile, void* stream) {
  return launch_gather<bf16>(cams, n_cams, hw, src, weight, node, out, n, B,
                             tile, stream);
}

}  // extern "C"
