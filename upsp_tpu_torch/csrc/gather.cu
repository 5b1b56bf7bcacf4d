// Hopper kernel for the combined best-view projection gather of phase 1.
//
//   K5 gather  <- _slab_gather_apply (upsp_tpu/ops/pallas_gather.py:251)
//
// Per frame b and model node n, with p = superseded_by[n] (the node that
// n's overlap supersession copies):
//
//   out[b, n] = NaN                                          if skipped[p]
//             = stacked[b, combined_index[p]] * combined_weight[p]  else
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
// contract and not the slot order: a GPU thread can write anywhere, so this
// kernel writes model order directly, and nothing is un-permuted on the
// host.
//
// What bounds it on the H100: memory latency and sectors, not bytes.  Per
// node and frame it reads one float of a ~70 MB frame batch and writes one
// float.  The plan (built once in phase 0, ops/gather_kernels.py) lists
// the nodes sorted by source pixel, so the 32 threads of a warp read
// neighbouring pixels (few sectors per warp load) and the frame stack is
// read in address order; each thread keeps its node's source, weight and
// destination in registers and loops over the B frames of the batch, so
// the plan is read once per batch, not once per frame.  The stores scatter
// by node.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libupsp_gather.so gather.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include "image_io.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const T* __restrict__ stacked, const int* __restrict__ src,
              const float* __restrict__ weight, const int* __restrict__ node,
              float* __restrict__ out, int n, long long pixels, int B) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int s = src[i];
  const float w = weight[i];
  const long long o = node[i];
  const float nan = __int_as_float(0x7fc00000);
  for (int b = 0; b < B; ++b) {
    out[(long long)b * n + o] =
        s < 0 ? nan : __fmul_rn(ldf(stacked + (long long)b * pixels + s), w);
  }
}

template <typename T>
int launch_gather(const T* stacked, const int* src, const float* weight,
                  const int* node, float* out, int n, long long pixels, int B,
                  void* stream) {
  const unsigned int blocks = (unsigned int)((n + THREADS - 1) / THREADS);
  gather_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      stacked, src, weight, node, out, n, pixels, B);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface: enqueues on `stream`, does not synchronise, allocates
// nothing, returns cudaGetLastError().  `stacked` is (B, pixels) float32
// (upsp_gather) or bfloat16 (upsp_gather_bf16), `out` (B, n) float32;
// src/weight/node are the plan's (n,) arrays.

extern "C" {

int upsp_gather(const float* stacked, const int* src, const float* weight,
                const int* node, float* out, int n, long long pixels, int B,
                void* stream) {
  return launch_gather(stacked, src, weight, node, out, n, pixels, B, stream);
}

int upsp_gather_bf16(const bf16* stacked, const int* src, const float* weight,
                     const int* node, float* out, int n, long long pixels,
                     int B, void* stream) {
  return launch_gather(stacked, src, weight, node, out, n, pixels, B, stream);
}

}  // extern "C"
