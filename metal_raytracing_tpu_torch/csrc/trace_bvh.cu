// The exact BVH tracers for Hopper (sm_90a): closest hit and any hit over
// the implicit B-ary tree of node boxes, with Moller-Trumbore on the
// triangle slots, one thread per ray.
//
// closest_bvh_kernel and any_bvh_kernel are the card's form of the JAX
// package's packet walk (metal_raytracing_tpu/ops/trace.py: _packet_closest
// and _packet_any, its tracer="bvh"), which has no Pallas kernel: on the
// TPU it is a lax.while_loop per block of rays that share one stack, and in
// eager PyTorch each step of that loop would wait for the host.  The plain
// PyTorch versions are closest_packet_ref / any_packet_ref (ops/trace.py).
//
// The tree is the heap-ordered node_lo / node_hi of accel.build_cluster_bvh:
// the children of node g are g*B+1 .. g*B+B, leaves start at first_leaf,
// leaf node first_leaf + c holds cluster c, slots c*C .. c*C+C-1 of the
// geometry tables v0 / e1 / e2 (T, 3).  Padding leaves and the nodes above
// only padding have inverted boxes, which the slab test rejects; padding
// slots are zero triangles (det = 0), which Moller-Trumbore rejects.
//
// What each thread does:
//   * the global set first: the num_global real slots from g_base (closest:
//     the first slot wins a tie; any: the first occluder ends the ray);
//   * then its own walk from the root (not tested, as in the JAX walk),
//     with its own stack of (node, entry t).  An internal node's children
//     are slab-tested with the best t so far (closest) or max_t (any) as
//     bound; the closest walk pushes the hit children far first by the
//     ray's entry t (a stable order: among equal entries the lower index
//     is pushed first, as the JAX walk's stable argsort), and skips a
//     popped node whose entry now lies beyond the best t.  A leaf runs
//     Moller-Trumbore over its cluster_size slots; the closest walk takes a
//     hit only when its t is strictly smaller than the best, so the first
//     slot wins a tie inside a leaf and the earlier leaf (or the global
//     set) across leaves;
//   * the any walk stops at its first occluder within max_t.
// Every loop that can end early carries its exit in its condition (one
// exit a loop).  The result per ray equals the plain versions' except
// where two triangles tie exactly (the packet orders a block's children by
// the block's least entry).
//
// Numerics: moller_trumbore and ray_aabb of ops/intersect.py op for op
// (every dot and cross product left to right, IEEE division, built with
// -fmad=false), so t, u, v agree with the plain versions bit for bit.
//
// What bounds it on an H100: instruction issue.  A leaf visit is C = 384
// Moller-Trumbore tests of about 55 instructions each (45 multiplies and
// adds that do not fuse, an IEEE reciprocal, 6 compares) on triangles read
// as nine scalars a slot; the geometry (dragon: 132k slots, 4.8 MB) stays in
// the 50 MB L2.  With one thread per ray a warp runs as long as its
// slowest lane, lanes whose walks differ diverge at every step, and lanes
// in different leaves read different cache lines.  This kernel is the
// simple, right form; the warp-shared leaf test of trace_warp.cuh (one
// cluster served to every lane that asks for it) is its later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

#include "trace_common.cuh"

namespace {

using namespace mrt;

constexpr int kThreads = 128;
constexpr int kMaxStack = 64;  // ops/trace.py MAX_STACK

struct BvhRay {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ BvhRay load_bvh_ray(const float* __restrict__ o,
                                               const float* __restrict__ d,
                                               int r) {
  BvhRay ray;
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

// ray_aabb of ops/intersect.py with t_min = 0: the raw entry t (not
// clamped) in *tn_out.
__device__ __forceinline__ bool bvh_slab(const float* __restrict__ lo,
                                         const float* __restrict__ hi,
                                         int node, const BvhRay& ray,
                                         float t_max, float* tn_out) {
  float lox = __ldg(lo + 3 * node + 0), loy = __ldg(lo + 3 * node + 1);
  float loz = __ldg(lo + 3 * node + 2);
  float hix = __ldg(hi + 3 * node + 0), hiy = __ldg(hi + 3 * node + 1);
  float hiz = __ldg(hi + 3 * node + 2);
  float t0x = (lox - ray.ox) * ray.ix;
  float t0y = (loy - ray.oy) * ray.iy;
  float t0z = (loz - ray.oz) * ray.iz;
  float t1x = (hix - ray.ox) * ray.ix;
  float t1y = (hiy - ray.oy) * ray.iy;
  float t1z = (hiz - ray.oz) * ray.iz;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  *tn_out = tn;
  return (tn <= tf) && (tf >= 0.0f) && (tn <= t_max) && (hix >= lox);
}

// moller_trumbore of ops/intersect.py (t_min = 1e-6) for slot j.
__device__ __forceinline__ bool mt_hit(const float* __restrict__ v0,
                                       const float* __restrict__ e1,
                                       const float* __restrict__ e2, int j,
                                       const BvhRay& ray, float t_max,
                                       float* t_out, float* u_out,
                                       float* v_out) {
  float ax = __ldg(e1 + 3 * j + 0), ay = __ldg(e1 + 3 * j + 1);
  float az = __ldg(e1 + 3 * j + 2);
  float bx = __ldg(e2 + 3 * j + 0), by = __ldg(e2 + 3 * j + 1);
  float bz = __ldg(e2 + 3 * j + 2);
  float px = ray.dy * bz - ray.dz * by;
  float py = ray.dz * bx - ray.dx * bz;
  float pz = ray.dx * by - ray.dy * bx;
  float det = ax * px + ay * py + az * pz;
  float inv_det = 1.0f / det;
  float tx = ray.ox - __ldg(v0 + 3 * j + 0);
  float ty = ray.oy - __ldg(v0 + 3 * j + 1);
  float tz = ray.oz - __ldg(v0 + 3 * j + 2);
  float u = (tx * px + ty * py + tz * pz) * inv_det;
  float qx = ty * az - tz * ay;
  float qy = tz * ax - tx * az;
  float qz = tx * ay - ty * ax;
  float v = (ray.dx * qx + ray.dy * qy + ray.dz * qz) * inv_det;
  float t = (bx * qx + by * qy + bz * qz) * inv_det;
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return (fabsf(det) > 1e-12f) && (u >= 0.0f) && (v >= 0.0f) &&
         (u + v <= 1.0f) && (t > 1e-6f) && (t <= t_max);
}

struct Best {
  float t, u, v;
  int tri;
};

// Slots [first, first + count): a hit replaces the best only when strictly
// nearer, so the first slot wins a tie.
__device__ __forceinline__ void closest_slots(const float* __restrict__ v0,
                                              const float* __restrict__ e1,
                                              const float* __restrict__ e2,
                                              int first, int count,
                                              const BvhRay& ray, Best& best) {
  for (int j = first; j < first + count; ++j) {
    float t, u, v;
    if (mt_hit(v0, e1, e2, j, ray, kBigT, &t, &u, &v) && t < best.t) {
      best.t = t;
      best.u = u;
      best.v = v;
      best.tri = j;
    }
  }
}

// True when a slot of [first, first + count) occludes within max_t; stops
// at the first.
__device__ __forceinline__ bool any_slots(const float* __restrict__ v0,
                                          const float* __restrict__ e1,
                                          const float* __restrict__ e2,
                                          int first, int count,
                                          const BvhRay& ray, float max_t) {
  bool occ = false;
  for (int j = first; j < first + count && !occ; ++j) {
    float t, u, v;
    occ = mt_hit(v0, e1, e2, j, ray, max_t, &t, &u, &v);
  }
  return occ;
}

__global__ void __launch_bounds__(kThreads)
    closest_bvh_kernel(const float* __restrict__ o,
                       const float* __restrict__ d,
                       const unsigned char* __restrict__ mask,
                       const float* __restrict__ v0,
                       const float* __restrict__ e1,
                       const float* __restrict__ e2,
                       const float* __restrict__ lo,
                       const float* __restrict__ hi, int n, int branching,
                       int levels, int first_leaf, int c_size, int g_base,
                       int n_global, float* __restrict__ t_out,
                       float* __restrict__ u_out, float* __restrict__ v_out,
                       int* __restrict__ tri_out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  Best best = {kBigT, 0.0f, 0.0f, -1};
  if (mask[r]) {
    BvhRay ray = load_bvh_ray(o, d, r);
    closest_slots(v0, e1, e2, g_base, n_global, ray, best);
    if (levels == 0) {  // the root is the only (leaf) node
      closest_slots(v0, e1, e2, 0, c_size, ray, best);
    } else {
      int stack[kMaxStack];
      float entry[kMaxStack];
      int sp = 1;
      stack[0] = 0;
      entry[0] = -kBigT;
      while (sp > 0) {
        --sp;
        int node = stack[sp];
        if (entry[sp] > best.t) continue;  // beyond the best: culled
        if (node >= first_leaf) {
          closest_slots(v0, e1, e2, (node - first_leaf) * c_size, c_size,
                        ray, best);
          continue;
        }
        int first = sp;
        int child0 = node * branching + 1;
        for (int k = 0; k < branching; ++k) {
          float tn;
          if (bvh_slab(lo, hi, child0 + k, ray, best.t, &tn)) {
            // insert, keeping entries non-increasing toward the top;
            // an equal entry stays below (pushed first)
            int i = sp++;
            for (; i > first && entry[i - 1] < tn; --i) {
              stack[i] = stack[i - 1];
              entry[i] = entry[i - 1];
            }
            stack[i] = child0 + k;
            entry[i] = tn;
          }
        }
      }
    }
  }
  t_out[r] = best.t;
  u_out[r] = best.u;
  v_out[r] = best.v;
  tri_out[r] = best.tri;
}

__global__ void __launch_bounds__(kThreads)
    any_bvh_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const unsigned char* __restrict__ mask,
                   const float* __restrict__ max_t,
                   const float* __restrict__ v0,
                   const float* __restrict__ e1,
                   const float* __restrict__ e2,
                   const float* __restrict__ lo,
                   const float* __restrict__ hi, int n, int branching,
                   int levels, int first_leaf, int c_size, int g_base,
                   int n_global, bool* __restrict__ occ_out) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  bool occ = false;
  if (mask[r]) {
    BvhRay ray = load_bvh_ray(o, d, r);
    float mt = max_t[r];
    occ = any_slots(v0, e1, e2, g_base, n_global, ray, mt);
    if (!occ && levels == 0) {
      occ = any_slots(v0, e1, e2, 0, c_size, ray, mt);
    } else if (!occ) {
      int stack[kMaxStack];
      int sp = 1;
      stack[0] = 0;
      while (sp > 0 && !occ) {
        int node = stack[--sp];
        if (node >= first_leaf) {
          occ = any_slots(v0, e1, e2, (node - first_leaf) * c_size, c_size,
                          ray, mt);
        } else {
          int child0 = node * branching + 1;
          for (int k = 0; k < branching; ++k) {
            float tn;
            if (bvh_slab(lo, hi, child0 + k, ray, mt, &tn))
              stack[sp++] = child0 + k;
          }
        }
      }
    }
  }
  occ_out[r] = occ;
}

}  // namespace

extern "C" {

// Plain C entry points for ctypes.  o, d (n, 3) float32; mask (n,) bool;
// max_t (n,) float32; v0, e1, e2 (T, 3) float32 slot tables; lo, hi
// (num_nodes, 3) float32 node boxes.  The tree needs a stack of
// (B - 1) * max(levels, 1) + 2 <= kMaxStack entries (the wrapper checks).
// Each launches on the given stream, allocates nothing, and returns
// cudaGetLastError() of its launch.

int launch_closest_bvh(const void* o, const void* d, const void* mask,
                       const void* v0, const void* e1, const void* e2,
                       const void* lo, const void* hi, int n, int branching,
                       int levels, int first_leaf, int c_size, int g_base,
                       int n_global, void* t_out, void* u_out, void* v_out,
                       void* tri_out, void* stream) {
  if (branching < 2 || (branching - 1) * (levels > 1 ? levels : 1) + 2 >
                           kMaxStack)
    return (int)cudaErrorInvalidValue;
  int blocks = (n + kThreads - 1) / kThreads;
  closest_bvh_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const unsigned char*)mask,
      (const float*)v0, (const float*)e1, (const float*)e2, (const float*)lo,
      (const float*)hi, n, branching, levels, first_leaf, c_size, g_base,
      n_global, (float*)t_out, (float*)u_out, (float*)v_out, (int*)tri_out);
  return (int)cudaGetLastError();
}

int launch_any_bvh(const void* o, const void* d, const void* mask,
                   const void* max_t, const void* v0, const void* e1,
                   const void* e2, const void* lo, const void* hi, int n,
                   int branching, int levels, int first_leaf, int c_size,
                   int g_base, int n_global, void* occ_out, void* stream) {
  if (branching < 2 || (branching - 1) * (levels > 1 ? levels : 1) + 2 >
                           kMaxStack)
    return (int)cudaErrorInvalidValue;
  int blocks = (n + kThreads - 1) / kThreads;
  any_bvh_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const unsigned char*)mask,
      (const float*)max_t, (const float*)v0, (const float*)e1,
      (const float*)e2, (const float*)lo, (const float*)hi, n, branching,
      levels, first_leaf, c_size, g_base, n_global, (bool*)occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
