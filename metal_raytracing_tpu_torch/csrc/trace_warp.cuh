// Warp-cooperative device code shared by the traversal kernels of
// trace_flat.cu (K1/K2, a one-level walk per lane), trace_hier.cu (K3/K4,
// a two-level walk per lane) and trace_rank.cu (K6, a walk over each lane's
// own candidate clusters): the block's rays in shared memory, the box
// pick the warp shares for one picking lane, and the leaf test the warp
// shares for every lane that asked for the same cluster.  Every function
// here is called by all 32 lanes of a warp; the design notes are in
// trace_hier.cu.

#pragma once

#include "trace_common.cuh"

namespace mrt {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kInfBits = 0x7f800000;  // float bits of +inf: no box

// A block's rays in shared memory, three float4 a thread: (ox, oy, oz, dx),
// (dy, dz, max_t, 0) and the slab test's (1/dx, 1/dy, 1/dz, 0).  A warp
// reads one ray as a broadcast.
__device__ __forceinline__ void store_ray(float4* s_ray, const Ray& ray,
                                          float t_max) {
  s_ray[3 * threadIdx.x] = make_float4(ray.ox, ray.oy, ray.oz, ray.dx);
  s_ray[3 * threadIdx.x + 1] = make_float4(ray.dy, ray.dz, t_max, 0.0f);
  s_ray[3 * threadIdx.x + 2] = make_float4(ray.ix, ray.iy, ray.iz, 0.0f);
  __syncwarp();
}

// pick_box shared by the warp, for the ray of lane m (read from shared
// memory): lane l slab-tests boxes l, l + 32, ... against `vis`, lane m's
// visited mask.  Entries are >= 0, so their float bits order like their
// values; + 0.0f turns a -0 into +0 so that equal entries have equal bits.
// Returns the same index to all lanes.  Called by all 32 lanes.  kBaked: the
// baked-origin slab test (trace_common.cuh).
template <bool kBaked = false>
__device__ __forceinline__ int coop_pick(const float* boxes, int count,
                                         const float4* rays, int m,
                                         float t_max, float bound,
                                         const unsigned (&vis)[4], int lane) {
  float4 a = rays[3 * m], b = rays[3 * m + 1], iv = rays[3 * m + 2];
  Ray ray = {a.x, a.y, a.z, a.w, b.x, b.y, iv.x, iv.y, iv.z};
  int best_bits = kInfBits, best_idx = 0x7fffffff;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    int k = 32 * w + lane;
    if (32 * w < count) {
      float tn = 0.0f;
      bool ok = k < count && !((vis[w] >> lane) & 1u) &&
                slab<kBaked>(boxes + 6 * k, ray, t_max, &tn) && tn < bound;
      int bits = ok ? __float_as_int(tn + 0.0f) : kInfBits;
      if (bits < best_bits) {
        best_bits = bits;
        best_idx = k;
      }
    }
  }
  int mn = __reduce_min_sync(kFull, best_bits);
  int idx = __reduce_min_sync(kFull, best_bits == mn ? best_idx : 0x7fffffff);
  return mn == kInfBits ? -1 : idx;
}

// coop_pick for a box list of any length, with the order state of a wide
// super (trace_hier.cu) in place of a visited mask: only a box whose
// (entry bits, index) comes strictly after (a_bits, a_idx) may be picked.
// Lane l tests boxes l, l + 32, ...  Returns the same index to all lanes,
// and the picked entry's bits in *bits_out.  Called by all 32 lanes.
template <bool kBaked = false>
__device__ __forceinline__ int coop_pick_after(const float* boxes, int count,
                                               const float4* rays, int m,
                                               float t_max, float bound,
                                               int a_bits, int a_idx,
                                               int lane, int* bits_out) {
  float4 a = rays[3 * m], b = rays[3 * m + 1], iv = rays[3 * m + 2];
  Ray ray = {a.x, a.y, a.z, a.w, b.x, b.y, iv.x, iv.y, iv.z};
  int best_bits = kInfBits, best_idx = 0x7fffffff;
  for (int k = lane; k < count; k += 32) {
    float tn = 0.0f;
    bool ok = slab<kBaked>(boxes + 6 * k, ray, t_max, &tn) && tn < bound;
    int bits = __float_as_int(tn + 0.0f);
    ok = ok && (bits > a_bits || (bits == a_bits && k > a_idx));
    if (ok && bits < best_bits) {
      best_bits = bits;
      best_idx = k;
    }
  }
  int mn = __reduce_min_sync(kFull, best_bits);
  int idx = __reduce_min_sync(kFull, best_bits == mn ? best_idx : 0x7fffffff);
  *bits_out = mn;
  return mn == kInfBits ? -1 : idx;
}

// The warp's shared leaf test for closest hits: slots [base, base + count)
// against the ray of every lane in `group`.  Returns, to each lane of the
// group, its ray's minimum packed key (bits(t) & ~0x1FF) | j over the
// slots, init_key() when none is hit.  A step is 64 slots, two a lane: the
// two plane tests of a ray are independent, which hides their latency in a
// warp that walks alone.  Called by all 32 lanes.  kBaked: the baked-origin
// plane test, which reads only each ray's direction.
template <bool kBaked = false>
__device__ __forceinline__ int serve_closest(const float* __restrict__ tri,
                                             int T, int base, int count,
                                             unsigned group,
                                             const float4* rays, int lane) {
  int vkey = init_key();
  for (int j0 = 0; j0 < count; j0 += 64) {
    float p[12], q[12];
    int ja = j0 + lane, jb = ja + 32;
    load_planes(tri, T, base + ja, ja < count, p);
    load_planes(tri, T, base + jb, jb < count, q);
    for (unsigned g = group; g; g &= g - 1) {
      int m = __ffs(g) - 1;
      float4 a = rays[3 * m], b = rays[3 * m + 1];
      float ta, tb;
      bool ha = kBaked ? plane_hit_baked(p, a.w, b.x, b.y, &ta)
                       : plane_hit(p, a.x, a.y, a.z, a.w, b.x, b.y, &ta);
      bool hb = kBaked ? plane_hit_baked(q, a.w, b.x, b.y, &tb)
                       : plane_hit(q, a.x, a.y, a.z, a.w, b.x, b.y, &tb);
      int ka = ha ? ((__float_as_int(ta) & ~kIdxMask) | ja) : init_key();
      int kb = hb ? ((__float_as_int(tb) & ~kIdxMask) | jb) : init_key();
      int k = __reduce_min_sync(kFull, min(ka, kb));
      if (lane == m) vkey = min(vkey, k);
    }
  }
  return vkey;
}

// The warp's shared leaf test for occlusion: the lanes of `group` whose ray
// hits a slot of [base, base + count) within (1e-6, max_t].  A ray leaves
// at the first step with an occluder.  Called by all 32 lanes.
__device__ __forceinline__ unsigned serve_any(const float* __restrict__ tri,
                                              int T, int base, int count,
                                              unsigned group,
                                              const float4* rays, int lane) {
  unsigned occluded = 0u;
  for (int j0 = 0; j0 < count && group; j0 += 64) {
    float p[12], q[12];
    int ja = j0 + lane, jb = ja + 32;
    load_planes(tri, T, base + ja, ja < count, p);
    load_planes(tri, T, base + jb, jb < count, q);
    for (unsigned g = group; g; g &= g - 1) {
      int m = __ffs(g) - 1;
      float4 a = rays[3 * m], b = rays[3 * m + 1];
      float ta, tb;
      bool ha = plane_hit(p, a.x, a.y, a.z, a.w, b.x, b.y, &ta) && ta <= b.z;
      bool hb = plane_hit(q, a.x, a.y, a.z, a.w, b.x, b.y, &tb) && tb <= b.z;
      if (__any_sync(kFull, ha || hb)) occluded |= 1u << m;
    }
    group &= ~occluded;
  }
  return occluded;
}

}  // namespace mrt
