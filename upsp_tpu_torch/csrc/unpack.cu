// Hopper kernels for packed-video ingest: the raw 12-bit and 10-bit camera
// bytes go to the card as they are on disk and are unpacked there.
//
//   K7 unpack12  <- _unpack12_kernel via unpack_12bpp_device
//                   (upsp_tpu/ops/pallas_unpack.py:23, :37)
//   K8 unpack10  <- _unpack10_kernel via unpack_10bpp_device (:62, :76),
//                   with the cine 10->12-bit LUT that the JAX path applies
//                   after it (upsp_tpu/pipeline/phase1.py:557-558) fused in
//
// Pixels are packed MSBit-first: 3 bytes hold 2 12-bit pixels, 5 bytes
// hold 4 10-bit pixels.  One thread unpacks one such group.
//
// Output is float32, written straight into the (F, C, H, W) frame buffer:
// the frame program's first step converts the frames to float32 anyway
// (upsp_tpu_torch/pipeline/phase1.py), every value is an integer below
// 4096 and so exact in float32, and torch has little uint16 support.
//
// What bounds them on the H100: memory.  Per pixel K7 reads 1.5 bytes and
// writes 4, K8 reads 1.25 and writes 4; the bit operations are a few
// integer instructions.  A warp's groups are one contiguous run of 96
// (K7) or 160 (K8) bytes, so the byte loads coalesce through L1, and the
// stores are one float2 / float4 per thread, contiguous across the warp.
// K8 stages the 1024-entry LUT in shared memory (4 KB), where threads of a
// warp that look up different entries do not serialise as they would in
// constant memory.
//
// The plain PyTorch twins live beside the wrappers in
// upsp_tpu_torch/ops/unpack_kernels.py and define the semantics.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libupsp_unpack.so unpack.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int LUT10 = 1024;

__global__ void __launch_bounds__(THREADS)
unpack12_kernel(const uint8_t* __restrict__ in, float2* __restrict__ out,
                long long groups) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= groups) return;
  const uint8_t* p = in + 3 * g;
  const int b0 = __ldg(p);
  const int b1 = __ldg(p + 1);
  const int b2 = __ldg(p + 2);
  out[g] = make_float2((float)((b0 << 4) | (b1 >> 4)),
                       (float)(((b1 & 0x0F) << 8) | b2));
}

__global__ void __launch_bounds__(THREADS)
unpack10_kernel(const uint8_t* __restrict__ in,
                const float* __restrict__ lut, float4* __restrict__ out,
                long long groups) {
  __shared__ float s_lut[LUT10];
  if (lut != nullptr) {
    for (int k = threadIdx.x; k < LUT10; k += THREADS) s_lut[k] = lut[k];
  }
  __syncthreads();
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= groups) return;
  const uint8_t* p = in + 5 * g;
  const int b0 = __ldg(p);
  const int b1 = __ldg(p + 1);
  const int b2 = __ldg(p + 2);
  const int b3 = __ldg(p + 3);
  const int b4 = __ldg(p + 4);
  const int p0 = (b0 << 2) | (b1 >> 6);
  const int p1 = ((b1 & 0x3F) << 4) | (b2 >> 4);
  const int p2 = ((b2 & 0x0F) << 6) | (b3 >> 2);
  const int p3 = ((b3 & 0x03) << 8) | b4;
  out[g] = lut != nullptr
               ? make_float4(s_lut[p0], s_lut[p1], s_lut[p2], s_lut[p3])
               : make_float4((float)p0, (float)p1, (float)p2, (float)p3);
}

unsigned int blocks(long long groups) {
  return (unsigned int)((groups + THREADS - 1) / THREADS);
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface.  Every function enqueues on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError().  `out` is
// (2 * groups,) / (4 * groups,) float32, 8- / 16-byte aligned; `lut` is
// (1024,) float32 or null.

extern "C" {

int upsp_unpack12(const uint8_t* in, float* out, long long groups,
                  void* stream) {
  unpack12_kernel<<<blocks(groups), THREADS, 0, (cudaStream_t)stream>>>(
      in, reinterpret_cast<float2*>(out), groups);
  return (int)cudaGetLastError();
}

int upsp_unpack10(const uint8_t* in, const float* lut, float* out,
                  long long groups, void* stream) {
  unpack10_kernel<<<blocks(groups), THREADS, 0, (cudaStream_t)stream>>>(
      in, lut, reinterpret_cast<float4*>(out), groups);
  return (int)cudaGetLastError();
}

}  // extern "C"
