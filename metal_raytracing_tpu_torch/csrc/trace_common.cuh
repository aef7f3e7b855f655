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

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int r) {
  Ray ray;
  ray.ox = o[3 * r + 0];
  ray.oy = o[3 * r + 1];
  ray.oz = o[3 * r + 2];
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
__device__ __forceinline__ bool slab(const float* box, const Ray& ray,
                                     float t_max, float* tn_out) {
  float lox = box[0], loy = box[1], loz = box[2];
  float hix = box[3], hiy = box[4], hiz = box[5];
  float t0x = (lox - ray.ox) * ray.ix;
  float t1x = (hix - ray.ox) * ray.ix;
  float t0y = (loy - ray.oy) * ray.iy;
  float t1y = (hiy - ray.oy) * ray.iy;
  float t0z = (loz - ray.oz) * ray.iz;
  float t1z = (hiz - ray.oz) * ray.iz;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  *tn_out = fmaxf(tn, 0.0f);
  return (tn <= tf) && (tf >= 0.0f) && (tn <= t_max) && (hix >= lox);
}

// Baldwin-Weber test of triangle slot j against the (12, T) plane rows
// (trace_pallas._mt_block).  Returns the hit distance in *t_out.
__device__ __forceinline__ bool tri_hit(const float* __restrict__ tri, int T,
                                        int j, const Ray& ray, float* t_out) {
  float nx = __ldg(tri + 0 * T + j), ny = __ldg(tri + 1 * T + j);
  float nz = __ldg(tri + 2 * T + j), dc = __ldg(tri + 3 * T + j);
  float ux = __ldg(tri + 4 * T + j), uy = __ldg(tri + 5 * T + j);
  float uz = __ldg(tri + 6 * T + j), uw = __ldg(tri + 7 * T + j);
  float vx = __ldg(tri + 8 * T + j), vy = __ldg(tri + 9 * T + j);
  float vz = __ldg(tri + 10 * T + j), vw = __ldg(tri + 11 * T + j);
  float den = nx * ray.dx + ny * ray.dy + nz * ray.dz;
  float rcp = 1.0f / den;
  rcp = rcp * (2.0f - den * rcp);
  float t = (dc - (nx * ray.ox + ny * ray.oy + nz * ray.oz)) * rcp;
  float px = ray.ox + t * ray.dx;
  float py = ray.oy + t * ray.dy;
  float pz = ray.oz + t * ray.dz;
  float u = ux * px + uy * py + uz * pz + uw;
  float v = vx * px + vy * py + vz * pz + vw;
  *t_out = t;
  return (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > 1e-6f);
}

// Minimum packed key (bits(t) & ~0x1FF) | j over slots [base, base + count)
// of one cluster, or init_key() when none is hit.
__device__ __forceinline__ int dense_closest(const float* __restrict__ tri,
                                             int T, int base, int count,
                                             const Ray& ray) {
  int vkey = init_key();
  for (int j = 0; j < count; ++j) {
    float t;
    if (tri_hit(tri, T, base + j, ray, &t))
      vkey = min(vkey, (__float_as_int(t) & ~kIdxMask) | j);
  }
  return vkey;
}

// Is any slot of [base, base + count) hit within (1e-6, t_max]?
__device__ __forceinline__ bool dense_any(const float* __restrict__ tri, int T,
                                          int base, int count, const Ray& ray,
                                          float t_max) {
  for (int j = 0; j < count; ++j) {
    float t;
    if (tri_hit(tri, T, base + j, ray, &t) && t <= t_max) return true;
  }
  return false;
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
template <int W>
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
      if (slab(boxes + 6 * k, ray, t_max, &tn) && tn < best_tn) {
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
