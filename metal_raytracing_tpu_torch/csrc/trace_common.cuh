// Device helpers shared by the traversal kernels (trace_flat.cu,
// trace_hier.cu, trace_rank.cu) and the broad-phase kernel (broadphase.cu).
//
// Numerics match the plain PyTorch versions op for op (every source is
// built with -fmad=false and IEEE division): the slab test of
// trace_pallas._slab_cols and the Baldwin-Weber plane test of
// trace_pallas._mt_block, t = (n.v0 - n.o) * rcp with rcp = 1/den refined by
// one Newton step, barycentrics u = U.p + uw, v = V.p + vw at p = o + t d,
// hit when u >= 0, v >= 0, u + v <= 1 and t > 1e-6.  A degenerate padding
// triangle has den = 0, so t is NaN and every comparison is false.
//
// The baked-origin forms (template flag kBaked; trace_pallas._slab_cols and
// _mt_block with no origin, for rays that all leave the origin that
// trace_cuda.bake_origin moved into the tables) drop every origin term: the
// slab entry is lo * inv, t = n.v0' * rcp, and u = t * (U.d) + uw',
// v = t * (V.d) + vw', in that association.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mrt {

constexpr int kIdxMask = 0x1FF;  // in-cluster index bits of a packed key
constexpr float kBigT = 1e30f;

__device__ __forceinline__ int miss_key() {
  return __float_as_int(kBigT) & ~kIdxMask;
}

__device__ __forceinline__ int init_key() { return miss_key() | kIdxMask; }

// Chopped hit distance of a packed key (a <= 512-ulp underestimate).
__device__ __forceinline__ float key_to_t(int key) {
  return __int_as_float(key & ~kIdxMask);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float safe_inv(float v) {
  const float eps = 1e-12f;
  float s = fabsf(v) < eps ? (v < 0.0f ? -eps : eps) : v;
  return 1.0f / s;
}

// Ray r of the (N, 3) tables; kBaked: the origin is 0 and `o` is not read.
template <bool kBaked = false>
__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int r) {
  Ray ray;
  ray.ox = kBaked ? 0.0f : o[3 * r + 0];
  ray.oy = kBaked ? 0.0f : o[3 * r + 1];
  ray.oz = kBaked ? 0.0f : o[3 * r + 2];
  ray.dx = d[3 * r + 0];
  ray.dy = d[3 * r + 1];
  ray.dz = d[3 * r + 2];
  ray.ix = safe_inv(ray.dx);
  ray.iy = safe_inv(ray.dy);
  ray.iz = safe_inv(ray.dz);
  return ray;
}

// Slab test of one box [lo(3), hi(3)] (trace_pallas._slab_cols); an
// inverted padding box fails the hi >= lo term.  Writes max(t_entry, 0).
// kBaked: the box is shifted by -origin and the ray starts at 0.
template <bool kBaked = false>
__device__ __forceinline__ bool slab(const float* box, const Ray& ray,
                                     float t_max, float* tn_out) {
  float lox = box[0], loy = box[1], loz = box[2];
  float hix = box[3], hiy = box[4], hiz = box[5];
  float t0x = (kBaked ? lox : lox - ray.ox) * ray.ix;
  float t1x = (kBaked ? hix : hix - ray.ox) * ray.ix;
  float t0y = (kBaked ? loy : loy - ray.oy) * ray.iy;
  float t1y = (kBaked ? hiy : hiy - ray.oy) * ray.iy;
  float t0z = (kBaked ? loz : loz - ray.oz) * ray.iz;
  float t1z = (kBaked ? hiz : hiz - ray.oz) * ray.iz;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  *tn_out = fmaxf(tn, 0.0f);
  return (tn <= tf) && (tf >= 0.0f) && (tn <= t_max) && (hix >= lox);
}

// Baldwin-Weber test of one triangle's twelve plane values p = [n(3), n.v0,
// U(3), uw, V(3), vw] against a ray (trace_pallas._mt_block).  Returns the
// hit distance in *t_out.
__device__ __forceinline__ bool plane_hit(const float (&p)[12], float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float* t_out) {
  float den = p[0] * dx + p[1] * dy + p[2] * dz;
  float rcp = 1.0f / den;
  rcp = rcp * (2.0f - den * rcp);
  float t = (p[3] - (p[0] * ox + p[1] * oy + p[2] * oz)) * rcp;
  float px = ox + t * dx;
  float py = oy + t * dy;
  float pz = oz + t * dz;
  float u = p[4] * px + p[5] * py + p[6] * pz + p[7];
  float v = p[8] * px + p[9] * py + p[10] * pz + p[11];
  *t_out = t;
  return (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > 1e-6f);
}

// plane_hit in the baked-origin form: the plane values of bake_origin
// (n.v0 - n.o, uw + U.o, vw + V.o) against a ray from 0 along d.
__device__ __forceinline__ bool plane_hit_baked(const float (&p)[12],
                                                float dx, float dy, float dz,
                                                float* t_out) {
  float den = p[0] * dx + p[1] * dy + p[2] * dz;
  float rcp = 1.0f / den;
  rcp = rcp * (2.0f - den * rcp);
  float t = p[3] * rcp;
  float u = t * (p[4] * dx + p[5] * dy + p[6] * dz) + p[7];
  float v = t * (p[8] * dx + p[9] * dy + p[10] * dz) + p[11];
  *t_out = t;
  return (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > 1e-6f);
}

// The plane values of triangle slot j of the (12, T) plane rows, or zeros
// when !valid: a zero triangle has den = 0, so it is never hit.
__device__ __forceinline__ void load_planes(const float* __restrict__ tri,
                                            int T, int j, bool valid,
                                            float (&p)[12]) {
#pragma unroll
  for (int k = 0; k < 12; ++k) p[k] = valid ? __ldg(tri + k * T + j) : 0.0f;
}

// Baldwin-Weber test of triangle slot j against the (12, T) plane rows.
__device__ __forceinline__ bool tri_hit(const float* __restrict__ tri, int T,
                                        int j, const Ray& ray, float* t_out) {
  float p[12];
  load_planes(tri, T, j, true, p);
  return plane_hit(p, ray.ox, ray.oy, ray.oz, ray.dx, ray.dy, ray.dz, t_out);
}

// Block-wide copy of n floats into shared memory, then a barrier.
__device__ __forceinline__ void load_shared(const float* __restrict__ src,
                                            int n, float* dst) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

// Nearest box of boxes[0, count) (count <= 32 * W) that is not marked in
// `visited`, is slab-hit within t_max, and has its entry strictly below
// `bound`; -1 when there is none.  Ties go to the lower index, as the TPU
// kernels' argmin.
template <bool kBaked = false, int W>
__device__ __forceinline__ int pick_box(const float* boxes, int count,
                                        const Ray& ray, float t_max,
                                        float bound,
                                        const unsigned (&visited)[W]) {
  int best = -1;
  float best_tn = bound;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    unsigned vw = visited[w];
    for (int b = 0; b < 32; ++b) {
      int k = w * 32 + b;
      if (k >= count) break;
      if ((vw >> b) & 1u) continue;
      float tn;
      if (slab<kBaked>(boxes + 6 * k, ray, t_max, &tn) && tn < best_tn) {
        best_tn = tn;
        best = k;
      }
    }
  }
  return best;
}

template <int W>
__device__ __forceinline__ void mark(unsigned (&visited)[W], int k) {
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (w == (k >> 5)) visited[w] |= 1u << (k & 31);
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace mrt
