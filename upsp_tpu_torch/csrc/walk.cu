// Hopper kernel for phase 0's visibility walk.
//
//   K11 walk  <- ops/projection.py build_node_projection_host's native rays
//                (numpy set-up, retries and tests around cpp/upsp_native.cpp
//                upsp_bvh_intersect)
//
// One thread per grid node, for one camera centre c (f32, widened to f64):
//
//   d = f64(vertex) - c,  dist = |d|,  dir = f32(d / max(dist, 1e-30))
//   forward = sum(normal * dir) < thresh          (the oblique test)
//   primary ray c -> dir: closest hit (t, prim) over the flat BVH
//   own     = hit and triangle prim has the node as a vertex
//   settled = hit and |f64(t) - dist| > settled_rel * dist
//   while not own, up to n_jitter retries k in the host's offset order
//   (-x, +x, -y, +y, -z, +z) * jitter:
//     dk = (f64(vertex) + offset_k) - c, |dk|, dir = f32(dk / |dk|)
//     own = the retry's test; settled |= the retry's test
//
// and writes one byte a node: own | settled << 1 | forward << 2 |
// retries << 4, and, when asked, the last ray's t and prim.
//
// Bit for bit with the host.  The host's f64 set-up is numpy's: products,
// sums in index order ((x + y) + z), a correctly rounded square root and
// quotient, then a cast to f32; here every f64 operation is an explicitly
// rounded intrinsic, so nvcc contracts nothing.  The walk is
// cpp/upsp_native.cpp intersect_one: the stackless escape-link order, its
// f32 box test, eps, the first-found tie rule.  Its Moller-Trumbore test is
// what the host compiler makes of it: the library builds with -O3
// -march=native, and GCC contracts every a*b - c*d to fma(a, b, -(c*d)) and
// every a0*b0 + a1*b1 + a2*b2 to fma(a2, b2, fma(a0, b0, a1*b1)) (read from
// the library's disassembly); the box test has no product to fuse.  This
// kernel writes those fused operations with __fmaf_rn and rounds every other
// one on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn).  The oblique
// test is numpy's f32 products and sums; the caller passes the threshold
// as numpy compares it.
//
// What bounds it on the H100: latency of dependent loads.  A ray visits
// tens to a few hundred nodes, each a box of 24 bytes and its links, in an
// order that depends on the last box; the whole tree (121 MB at 1M nodes)
// is far larger than L2, but neighbouring nodes' rays (a warp is 32
// consecutive nodes of a grid row) walk nearly the same path, so most
// boxes come from L1/L2.  One thread a node, nothing shared.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libupsp_walk.so walk.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float EPS = 1e-9f;   // intersect_one's eps
constexpr float FAR = 3e38f;   // its "no hit" distance
constexpr int MAX_JITTER = 6;  // offsets the host defines

struct Scene {
  const float* bbox_min;    // (M, 3)
  const float* bbox_max;    // (M, 3)
  const int32_t* escape;    // (M,)
  const int32_t* leaf_start;  // (M,) -1 for internal nodes
  const int32_t* leaf_count;  // (M,)
  const float* tri_v0;      // (T, 3) slot order
  const float* tri_e1;
  const float* tri_e2;
  const int32_t* tri_id;    // (T,) original triangle of a slot
  const int32_t* triangles;  // (T, 3) nodes of an original triangle
  int n_nodes;              // M
};

// std::min / std::max as the host's intersect_one calls them
__device__ __forceinline__ float min_(float a, float b) { return b < a ? b : a; }
__device__ __forceinline__ float max_(float a, float b) { return a < b ? b : a; }

// a*b - c*d as the host build computes it
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -__fmul_rn(c, d));
}

// a0*b0 + a1*b1 + a2*b2 as the host build computes it
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a0, b0, __fmul_rn(a1, b1)));
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

// intersect_one: the closest hit of the ray o + t d; *prim = -1 and
// *t = FAR when it hits nothing
__device__ void intersect(const Scene& s, const float o[3], const float d[3],
                          float* t_out, int32_t* prim_out) {
  float inv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    inv[k] = fabsf(d[k]) > 1e-30f ? __fdiv_rn(1.0f, d[k])
                                  : (d[k] >= 0.0f ? 1e30f : -1e30f);
  }
  float best_t = FAR;
  int32_t best_prim = -1;
  int node = 0;
  while (node < s.n_nodes) {
    float tnear = -FAR, tfar = FAR;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float t0 = __fmul_rn(__fsub_rn(ld(s.bbox_min + node * 3 + k), o[k]), inv[k]);
      const float t1 = __fmul_rn(__fsub_rn(ld(s.bbox_max + node * 3 + k), o[k]), inv[k]);
      tnear = max_(tnear, min_(t0, t1));
      tfar = min_(tfar, max_(t0, t1));
    }
    const bool box_hit = tfar >= max_(tnear, 0.0f) && tnear < best_t;
    const int32_t start = __ldg(s.leaf_start + node);
    if (box_hit && start >= 0) {
      const int32_t count = __ldg(s.leaf_count + node);
      for (int32_t j = 0; j < count; ++j) {
        const float* v0 = s.tri_v0 + (size_t)(start + j) * 3;
        const float* e1 = s.tri_e1 + (size_t)(start + j) * 3;
        const float* e2 = s.tri_e2 + (size_t)(start + j) * 3;
        const float a0 = ld(e1), a1 = ld(e1 + 1), a2 = ld(e1 + 2);
        const float b0 = ld(e2), b1 = ld(e2 + 1), b2 = ld(e2 + 2);
        const float p0 = cross_term(d[1], b2, d[2], b1);
        const float p1 = cross_term(d[2], b0, d[0], b2);
        const float p2 = cross_term(d[0], b1, d[1], b0);
        const float det = dot3(a0, p0, a1, p1, a2, p2);
        if (fabsf(det) <= EPS) continue;
        const float idet = __fdiv_rn(1.0f, det);
        const float s0 = __fsub_rn(o[0], ld(v0));
        const float s1 = __fsub_rn(o[1], ld(v0 + 1));
        const float s2 = __fsub_rn(o[2], ld(v0 + 2));
        const float u = __fmul_rn(dot3(s0, p0, s1, p1, s2, p2), idet);
        if (u < 0.0f || u > 1.0f) continue;
        const float q0 = cross_term(s1, a2, s2, a1);
        const float q1 = cross_term(s2, a0, s0, a2);
        const float q2 = cross_term(s0, a1, s1, a0);
        const float v = __fmul_rn(dot3(d[0], q0, d[1], q1, d[2], q2), idet);
        if (v < 0.0f || __fadd_rn(u, v) > 1.0f) continue;
        const float t = __fmul_rn(dot3(b0, q0, b1, q1, b2, q2), idet);
        if (t > EPS && t < best_t) {
          best_t = t;
          best_prim = __ldg(s.tri_id + start + j);
        }
      }
    }
    node = (box_hit && start < 0) ? node + 1 : __ldg(s.escape + node);
  }
  *t_out = best_prim >= 0 ? best_t : FAR;
  *prim_out = best_prim;
}

__device__ __forceinline__ double norm3(const double a[3]) {
  return __dsqrt_rn(__dadd_rn(__dadd_rn(__dmul_rn(a[0], a[0]), __dmul_rn(a[1], a[1])),
                              __dmul_rn(a[2], a[2])));
}

__device__ __forceinline__ bool owns(const Scene& s, int32_t prim, int32_t node) {
  if (prim < 0) return false;
  const int32_t* tri = s.triangles + (size_t)prim * 3;
  return __ldg(tri) == node || __ldg(tri + 1) == node || __ldg(tri + 2) == node;
}

__device__ __forceinline__ bool far_off(float t, double dist, double rel) {
  return fabs(__dsub_rn((double)t, dist)) > __dmul_rn(rel, dist);
}

// the oblique test's sum(normal * dir), numpy's f32 products and sums
__device__ __forceinline__ float facing(const float* nrm, const float dir[3]) {
  const float p0 = __fmul_rn(__ldg(nrm), dir[0]);
  const float p1 = __fmul_rn(__ldg(nrm + 1), dir[1]);
  const float p2 = __fmul_rn(__ldg(nrm + 2), dir[2]);
  return __fadd_rn(__fadd_rn(p0, p1), p2);
}

__global__ void __launch_bounds__(THREADS)
walk_kernel(Scene s, const float* __restrict__ vertices, const float* __restrict__ normals,
            int n, float cx, float cy, float cz, double jitter, int n_jitter,
            double settled_rel, double thresh, uint8_t* __restrict__ flags,
            float* __restrict__ out_t, int32_t* __restrict__ out_prim) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float o[3] = {cx, cy, cz};
  const double c[3] = {(double)cx, (double)cy, (double)cz};
  const double v[3] = {(double)__ldg(vertices + (size_t)i * 3),
                       (double)__ldg(vertices + (size_t)i * 3 + 1),
                       (double)__ldg(vertices + (size_t)i * 3 + 2)};
  double dd[3];
  float dir[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) dd[k] = __dsub_rn(v[k], c[k]);
  const double dist = norm3(dd);
  const double den = dist < 1e-30 ? 1e-30 : dist;
#pragma unroll
  for (int k = 0; k < 3; ++k) dir[k] = __double2float_rn(__ddiv_rn(dd[k], den));
  const bool forward = (double)facing(normals + (size_t)i * 3, dir) < thresh;

  float t;
  int32_t prim;
  intersect(s, o, dir, &t, &prim);
  bool own = owns(s, prim, i);
  bool settled = prim >= 0 && far_off(t, dist, settled_rel);
  int retries = 0;
  for (int k = 0; k < n_jitter && !own; ++k) {
    // row k of the host's offsets: -x, +x, -y, +y, -z, +z
    const int axis = k >> 1;
    const double off = (k & 1) ? jitter : -jitter;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      dd[a] = __dsub_rn(__dadd_rn(v[a], a == axis ? off : 0.0), c[a]);
    }
    const double norm = norm3(dd);
#pragma unroll
    for (int a = 0; a < 3; ++a) dir[a] = __double2float_rn(__ddiv_rn(dd[a], norm));
    intersect(s, o, dir, &t, &prim);
    own = owns(s, prim, i);
    settled = settled || (prim >= 0 && far_off(t, norm, settled_rel));
    ++retries;
  }
  flags[i] = (uint8_t)((own ? 1 : 0) | (settled ? 2 : 0) | (forward ? 4 : 0) |
                       (retries << 4));
  if (out_t != nullptr) {
    out_t[i] = t;
    out_prim[i] = prim;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface: enqueues on `stream`, does not synchronise, allocates
// nothing, returns cudaGetLastError().  The BVH arrays are FlatBVH's
// (geometry/bvh.py) as the native library takes them, `triangles` (T, 3)
// int32, `vertices` and `normals` (n, 3) float32, `thresh` the oblique
// threshold as numpy compares an f32 sum with it, widened to f64.  `flags`
// is (n,) uint8; `out_t`/`out_prim` are (n,) or both null.

extern "C" {

int upsp_walk(const float* bbox_min, const float* bbox_max, const int32_t* escape,
              const int32_t* leaf_start, const int32_t* leaf_count,
              const float* tri_v0, const float* tri_e1, const float* tri_e2,
              const int32_t* tri_id, int n_bvh_nodes, const int32_t* triangles,
              const float* vertices, const float* normals, int n,
              float cx, float cy, float cz, double jitter, int n_jitter,
              double settled_rel, double thresh, uint8_t* flags, float* out_t,
              int32_t* out_prim, void* stream) {
  if (n < 0 || n_jitter < 0 || n_jitter > MAX_JITTER ||
      (out_t == nullptr) != (out_prim == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const Scene s{bbox_min, bbox_max, escape, leaf_start, leaf_count, tri_v0,
                tri_e1, tri_e2, tri_id, triangles, n_bvh_nodes};
  const unsigned int blocks = (unsigned int)((n + THREADS - 1) / THREADS);
  walk_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      s, vertices, normals, n, cx, cy, cz, jitter, n_jitter, settled_rel, thresh,
      flags, out_t, out_prim);
  return (int)cudaGetLastError();
}

}  // extern "C"
