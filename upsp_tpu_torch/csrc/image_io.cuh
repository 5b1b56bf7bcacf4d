// Image loads and stores shared by the port's kernels (ecc.cu, gather.cu).
//
// Images are float32 or bfloat16.  A bf16 load widens exactly to f32 (its
// bits are the top half of the f32's); a store rounds to nearest even
// (__float2bfloat16_rn, as astype(bfloat16) does).  Every kernel computes
// in f32 between the two, so a bf16 result is rounded once.

#pragma once

#include <cuda_bf16.h>

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const bf16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

}  // namespace
