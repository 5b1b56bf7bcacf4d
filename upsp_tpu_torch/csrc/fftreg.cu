// Hopper kernel for the phase correlation's decimation (the ECC start).
//
//   K10 pool  <- no Pallas kernel: it replaces the XLA dot of
//                upsp_tpu/ops/fftreg.py:74 (decimate_image as
//                P_h @ img @ P_w^T with dense (H/k, H) and (W, W/k)
//                pooling matrices)
//
// A k x k block mean of each frame, cropped to a multiple of k, summed in
// the order in which the JAX package's two products sum on the CPU: for
// each source column of the block, its k rows in order, each times 1/k;
// then the k column sums in order, each times 1/k.  Every product and sum
// is rounded on its own (__fmul_rn / __fadd_rn, no contraction into FMAs),
// so a pooled pixel is one fixed sequence of f32 operations: it equals the
// plain twin (upsp_tpu_torch/ops/fftreg.py:decimate_plain) bit for bit and
// does not depend on the batch, as a GEMM whose algorithm is picked by the
// batch size does.  The products of the dense form by its zeros add
// nothing, so the work is k*k multiplies and adds a pooled pixel, not the
// GEMMs' H + W a pixel.
//
// One thread computes one pooled pixel.  A block covers POOL_THREADS
// consecutive pooled pixels of one pooled row (blockIdx.y) of one frame
// (blockIdx.z, striding when the batch exceeds the grid's z limit), so a
// warp's stores are one contiguous run, and for each (row, column) of the
// block its loads are k elements apart: over the k columns the warp reads
// whole 32-byte sectors, which L1 keeps between the columns.  With k = 2,
// 4 or 8 the loops unroll and every load of the block is issued before the
// sums that need it.
//
// What bounds it on the H100: memory.  A call reads each frame once (4 or
// 2 bytes a pixel) and writes 4 / k^2 bytes a pixel; it does 2 operations a
// pixel plus 2 a pooled pixel.  Frames are float32 or bfloat16 (widened
// exactly on load: no separate cast pass), the output float32.  Rows may be
// strided (a camera's slice of a (B, C, H, W) chunk, or a crop): the
// wrapper passes the frame and row strides in elements; a row's pixels are
// contiguous.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libupsp_fftreg.so fftreg.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include "image_io.cuh"

namespace {

constexpr int POOL_THREADS = 128;
constexpr int MAX_GRID_Z = 65535;

// K > 0: the block side at compile time (loops unrolled); K == 0: ``k``.
template <typename T, int K>
__global__ void __launch_bounds__(POOL_THREADS)
pool_kernel(const T* __restrict__ in, float* __restrict__ out, int nb, int ho,
            int wo, long long fstride, long long rstride, int k, float inv) {
  const int kk = K > 0 ? K : k;
  const int j = blockIdx.x * POOL_THREADS + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= wo) return;
  for (int b = blockIdx.z; b < nb; b += gridDim.z) {
    const T* p = in + b * fstride + (long long)i * kk * rstride + (long long)j * kk;
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < kk; ++c) {
      float s = __fmul_rn(ldf(p + c), inv);
#pragma unroll
      for (int r = 1; r < kk; ++r) {
        s = __fadd_rn(s, __fmul_rn(ldf(p + r * rstride + c), inv));
      }
      const float v = __fmul_rn(s, inv);
      acc = c == 0 ? v : __fadd_rn(acc, v);
    }
    out[((long long)b * ho + i) * wo + j] = acc;
  }
}

template <typename T>
int launch_pool(const T* in, float* out, int nb, int ho, int wo,
                long long fstride, long long rstride, int k, float inv,
                void* stream) {
  if (nb <= 0 || ho <= 0 || wo <= 0) return 0;
  const dim3 grid((wo + POOL_THREADS - 1) / POOL_THREADS, ho,
                  nb < MAX_GRID_Z ? nb : MAX_GRID_Z);
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 2:
      pool_kernel<T, 2><<<grid, POOL_THREADS, 0, s>>>(in, out, nb, ho, wo,
                                                      fstride, rstride, k, inv);
      break;
    case 4:
      pool_kernel<T, 4><<<grid, POOL_THREADS, 0, s>>>(in, out, nb, ho, wo,
                                                      fstride, rstride, k, inv);
      break;
    case 8:
      pool_kernel<T, 8><<<grid, POOL_THREADS, 0, s>>>(in, out, nb, ho, wo,
                                                      fstride, rstride, k, inv);
      break;
    default:
      pool_kernel<T, 0><<<grid, POOL_THREADS, 0, s>>>(in, out, nb, ho, wo,
                                                      fstride, rstride, k, inv);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface.  Every function enqueues on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError().  `in`
// holds nb frames, frame b's row y starting at in + b * fstride + y *
// rstride (elements), its pixels contiguous; `out` is (nb, ho, wo) float32
// with ho = H / k and wo = W / k (ho <= 65535); k >= 2; `inv` is 1/k rounded
// to float32, as the JAX package's pooling matrices hold it.

extern "C" {

int upsp_fftreg_pool(const float* in, float* out, int nb, int ho, int wo,
                     long long fstride, long long rstride, int k, float inv,
                     void* stream) {
  return launch_pool(in, out, nb, ho, wo, fstride, rstride, k, inv, stream);
}

int upsp_fftreg_pool_bf16(const bf16* in, float* out, int nb, int ho, int wo,
                          long long fstride, long long rstride, int k,
                          float inv, void* stream) {
  return launch_pool(in, out, nb, ho, wo, fstride, rstride, k, inv, stream);
}

}  // extern "C"
