// The exact BVH tracers for Hopper (sm_90a): closest hit and any hit over
// the implicit B-ary tree of node boxes, with Moller-Trumbore on the
// triangle slots, a walk per lane and a leaf test that the 32 lanes of a
// warp share.
//
// closest_bvh_kernel and any_bvh_kernel are the card's form of the JAX
// package's packet walk (metal_raytracing_tpu/ops/trace.py: _packet_closest
// and _packet_any, its tracer="bvh"), which has no Pallas kernel: on the
// TPU it is a lax.while_loop per block of rays that share one stack, and in
// eager PyTorch each step of that loop would wait for the host.  The plain
// PyTorch versions are closest_bvh_walk_ref / any_bvh_walk_ref (the same
// walk, ray by ray: equal bit for bit) and closest_packet_ref /
// any_packet_ref (the JAX walk's, the CPU path), in ops/trace.py.
//
// The tree is the heap-ordered node_lo / node_hi of accel.build_cluster_bvh:
// the children of node g are g*B+1 .. g*B+B, leaves start at first_leaf,
// leaf node first_leaf + c holds cluster c, slots c*C .. c*C+C-1 of the
// geometry tables v0 / e1 / e2 (T, 3).  Padding leaves and the nodes above
// only padding have inverted boxes, which the slab test rejects; padding
// slots are zero triangles (det = 0), which Moller-Trumbore rejects.  With
// levels == 0 the root is leaf 0 (first_leaf = 0) and is never slab-tested.
//
// What each ray gets, as from a walk of its own:
//   * the global set first: the num_global real slots from g_base (closest:
//     the first slot wins a tie; any: an occluder ends the ray);
//   * then its own walk from the root (not tested, as in the JAX walk),
//     with its own stack of (node, entry t).  An internal node's children
//     are slab-tested with the best t so far (closest) or max_t (any) as
//     bound; the closest walk pushes the hit children far first by the
//     ray's entry t (a stable order: among equal entries the lower index
//     is pushed first, as the JAX walk's stable argsort), and skips a
//     popped node whose entry now lies beyond the best t.  A leaf's
//     cluster_size slots are Moller-Trumbore tested; the closest walk takes
//     the leaf's nearest hit (the first slot among equal t) only when
//     strictly nearer than the best, so the earlier leaf (or the global
//     set) wins a tie across leaves;
//   * the any walk pushes the hit children in index order and stops at its
//     first occluder within max_t.
// The result per ray equals the plain packet versions' except where two
// triangles tie exactly (the packet orders a block's children by the
// block's least entry).
//
// Numerics: moller_trumbore and ray_aabb of ops/intersect.py op for op
// (every dot and cross product left to right, IEEE division, built with
// -fmad=false), so t, u, v agree with the plain versions bit for bit.
//
// What bounds it on an H100: instruction issue.  A leaf visit is C = 384
// Moller-Trumbore tests of about 55 instructions each (45 multiplies and
// adds that do not fuse, an IEEE reciprocal, 6 compares) on triangles read
// as nine floats a slot; the geometry (dragon: 132k slots, 4.8 MB) stays in
// the 50 MB L2.  With one thread per ray (this kernel's first form) a warp
// ran as long as its slowest lane, lanes in different leaves diverged at
// every step, and each lane read its own cache lines.
//
// What the design does about it (trace_hier.cu's, on this walk):
//   * Each lane keeps its own ray, its best (t bits, slot) and its stack in
//     local memory.  In each round every walking lane pops and expands
//     nodes until it pops a leaf that survives the cull (next_leaf_*, a
//     loop with one exit), and requests that leaf.
//   * The warp serves the requests group by group: the lanes that asked for
//     the same leaf (ballot on the lowest pending lane's request).  For one
//     group the warp walks the leaf in steps of 64 slots: lane l holds
//     slots 64s + l and 64s + 32 + l (nine coalesced loads each: a warp's
//     32 slots are 384 contiguous bytes of each table), and for each ray of
//     the group (read from shared memory as a broadcast) every lane runs
//     Moller-Trumbore on its two slots.  The closest leaf test takes the
//     minimum t bits by __reduce_min_sync (a hit has t > 1e-6, so its bits
//     order like its value), then the lowest slot among equal t by two
//     ballots; the owner keeps a step's minimum only when strictly below
//     its leaf minimum so far, and the leaf's only when strictly below its
//     best.  The any test ORs the lanes' hits by __any_sync, and a ray
//     leaves the group at the first step with an occluder.  The global set
//     is served the same way, as one group of every live lane.  So a warp's
//     time is the sum of its lanes' leaf visits over 32, not their maximum.
//   * The node expansions are shared too when few lanes still walk: with
//     at most kCoopMax walking lanes the warp serves them one after
//     another, lanes 0 .. B-1 slab-testing the B children of the serving
//     lane's node, which pushes the hits in the order its own loop would.
//     It shortens the rounds in which a few long walks hold the warp (the
//     bounce passes; PERF.md).
//   * u and v are not carried: the winner's Moller-Trumbore runs once more
//     at the end (the same arithmetic, so the same bits).
//   * All lanes stay to the end: out-of-range and masked lanes request
//     nothing but take part in every warp-wide step, the loops end on
//     warp-uniform conditions, every loop that diverges between lanes has
//     one exit, and a lane's walk state changes only between rounds.
//   * Every ray visits the leaves its own walk visits, in the same order,
//     with the same best before each visit, and the minimum over a leaf
//     does not depend on which lane tested which slot: the results are
//     those of the one-thread-per-ray walk and of the walking plain
//     versions, bit for bit.
//
// Tensor cores do not apply: Moller-Trumbore is float32 dot products of
// depth 3 with an IEEE division, and TF32 inputs would move t.  Sharing one
// stack between the lanes (the JAX packet walk) would visit the union of
// their nodes and lose the per-ray order of exact ties.  The stack is
// kMaxStack (64) pairs in local memory: a 32-pair stack (dragon needs 23)
// measured the same (PERF.md), so one size serves every tree.

#include "trace_warp.cuh"

namespace {

using namespace mrt;

constexpr int kThreads = 128;
constexpr int kMaxStack = 64;  // ops/trace.py MAX_STACK
constexpr int kNoHit = 0x7fffffff;  // above the bits of every hit t
// The warp shares the node expansions when at most this many lanes walk.
// Measured on dragon's and coatball's passes (PERF.md), 4 beat 0, 8, 16
// and 32 on the sum of the passes.
constexpr int kCoopMax = 4;

// ray_aabb of ops/intersect.py with t_min = 0: the raw entry t (not
// clamped) in *tn_out.
__device__ __forceinline__ bool bvh_slab(const float* __restrict__ lo,
                                         const float* __restrict__ hi,
                                         int node, const Ray& ray,
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

// One triangle slot: v0, e1 (a), e2 (b).
struct Tri {
  float px, py, pz, ax, ay, az, bx, by, bz;
};

// Slot j of the (T, 3) tables, or a zero triangle (never hit) when !valid.
__device__ __forceinline__ Tri load_tri(const float* __restrict__ v0,
                                        const float* __restrict__ e1,
                                        const float* __restrict__ e2, int j,
                                        bool valid) {
  Tri tr = {};
  if (valid) {
    tr.px = __ldg(v0 + 3 * j + 0);
    tr.py = __ldg(v0 + 3 * j + 1);
    tr.pz = __ldg(v0 + 3 * j + 2);
    tr.ax = __ldg(e1 + 3 * j + 0);
    tr.ay = __ldg(e1 + 3 * j + 1);
    tr.az = __ldg(e1 + 3 * j + 2);
    tr.bx = __ldg(e2 + 3 * j + 0);
    tr.by = __ldg(e2 + 3 * j + 1);
    tr.bz = __ldg(e2 + 3 * j + 2);
  }
  return tr;
}

// moller_trumbore of ops/intersect.py (t_min = 1e-6), op for op.
__device__ __forceinline__ bool mt_hit(const Tri& tr, float ox, float oy,
                                       float oz, float dx, float dy,
                                       float dz, float t_max, float* t_out,
                                       float* u_out, float* v_out) {
  float px = dy * tr.bz - dz * tr.by;
  float py = dz * tr.bx - dx * tr.bz;
  float pz = dx * tr.by - dy * tr.bx;
  float det = tr.ax * px + tr.ay * py + tr.az * pz;
  float inv_det = 1.0f / det;
  float tx = ox - tr.px;
  float ty = oy - tr.py;
  float tz = oz - tr.pz;
  float u = (tx * px + ty * py + tz * pz) * inv_det;
  float qx = ty * tr.az - tz * tr.ay;
  float qy = tz * tr.ax - tx * tr.az;
  float qz = tx * tr.ay - ty * tr.ax;
  float v = (dx * qx + dy * qy + dz * qz) * inv_det;
  float t = (tr.bx * qx + tr.by * qy + tr.bz * qz) * inv_det;
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return (fabsf(det) > 1e-12f) && (u >= 0.0f) && (v >= 0.0f) &&
         (u + v <= 1.0f) && (t > 1e-6f) && (t <= t_max);
}

// The warp's shared closest leaf test: slots [base, base + count) against
// the ray of every lane in `group`.  Returns, to each lane of the group,
// the bits of its ray's nearest hit t there (kNoHit when none) in *bits
// and that hit's slot (the first among equal t) in *slot.  Called by all
// 32 lanes.
__device__ __forceinline__ void serve_closest_mt(
    const float* __restrict__ v0, const float* __restrict__ e1,
    const float* __restrict__ e2, int base, int count, unsigned group,
    const float4* rays, int lane, int* bits, int* slot) {
  int vbits = kNoHit, vslot = -1;
  for (int j0 = 0; j0 < count; j0 += 64) {
    int ja = j0 + lane, jb = ja + 32;
    Tri a = load_tri(v0, e1, e2, base + ja, ja < count);
    Tri b = load_tri(v0, e1, e2, base + jb, jb < count);
    for (unsigned g = group; g; g &= g - 1) {
      int m = __ffs(g) - 1;
      float4 p = rays[3 * m], q = rays[3 * m + 1];
      float ta, tb, u, v;
      bool ha = mt_hit(a, p.x, p.y, p.z, p.w, q.x, q.y, kBigT, &ta, &u, &v);
      bool hb = mt_hit(b, p.x, p.y, p.z, p.w, q.x, q.y, kBigT, &tb, &u, &v);
      int ka = ha ? __float_as_int(ta) : kNoHit;
      int kb = hb ? __float_as_int(tb) : kNoHit;
      int mn = __reduce_min_sync(kFull, min(ka, kb));
      if (mn < kNoHit) {  // warp-uniform
        // the lowest slot with the minimum: slots ja come before slots jb
        unsigned ea = __ballot_sync(kFull, ka == mn);
        unsigned eb = __ballot_sync(kFull, kb == mn);
        int j = ea ? j0 + __ffs(ea) - 1 : j0 + 32 + __ffs(eb) - 1;
        if (lane == m && mn < vbits) {
          vbits = mn;
          vslot = base + j;
        }
      }
    }
  }
  *bits = vbits;
  *slot = vslot;
}

// The warp's shared any-hit leaf test: the lanes of `group` whose ray hits a
// slot of [base, base + count) within (1e-6, max_t] (max_t from the rays in
// shared memory).  A ray leaves at the first step with an occluder.  Called
// by all 32 lanes.
__device__ __forceinline__ unsigned serve_any_mt(
    const float* __restrict__ v0, const float* __restrict__ e1,
    const float* __restrict__ e2, int base, int count, unsigned group,
    const float4* rays, int lane) {
  unsigned occluded = 0u;
  for (int j0 = 0; j0 < count && group; j0 += 64) {
    int ja = j0 + lane, jb = ja + 32;
    Tri a = load_tri(v0, e1, e2, base + ja, ja < count);
    Tri b = load_tri(v0, e1, e2, base + jb, jb < count);
    for (unsigned g = group; g; g &= g - 1) {
      int m = __ffs(g) - 1;
      float4 p = rays[3 * m], q = rays[3 * m + 1];
      float t, u, v;
      bool ha = mt_hit(a, p.x, p.y, p.z, p.w, q.x, q.y, q.z, &t, &u, &v);
      bool hb = mt_hit(b, p.x, p.y, p.z, p.w, q.x, q.y, q.z, &t, &u, &v);
      if (__any_sync(kFull, ha || hb)) occluded |= 1u << m;
    }
    group &= ~occluded;
  }
  return occluded;
}

// Push child `node` with entry tn, keeping entries non-increasing toward
// the top of the stack above `first`; an equal entry stays below (pushed
// first).
__device__ __forceinline__ void push_sorted(int (&stack)[kMaxStack],
                                            float (&entry)[kMaxStack],
                                            int& sp, int first, int node,
                                            float tn) {
  int i = sp++;
  for (; i > first && entry[i - 1] < tn; --i) {
    stack[i] = stack[i - 1];
    entry[i] = entry[i - 1];
  }
  stack[i] = node;
  entry[i] = tn;
}

// Lane m's ray from the warp's rays in shared memory.
__device__ __forceinline__ Ray shared_ray(const float4* rays, int m) {
  float4 a = rays[3 * m], b = rays[3 * m + 1], iv = rays[3 * m + 2];
  return {a.x, a.y, a.z, a.w, b.x, b.y, iv.x, iv.y, iv.z};
}

// One round of a lane's closest walk: pop nodes, cull those whose entry
// lies beyond best_t, push the slab-hit children of internal nodes (far
// first, an equal entry below), until a leaf survives the cull (its
// cluster returned) or the stack is empty (`walking` cleared; -1).  The
// loop diverges between lanes and the warp votes right after it, so it
// has one exit (trace_hier.cu's next_cluster).
__device__ __forceinline__ int next_leaf_closest(
    const float* __restrict__ lo, const float* __restrict__ hi,
    const Ray& ray, float best_t, int branching, int first_leaf,
    int (&stack)[kMaxStack], float (&entry)[kMaxStack], int& sp,
    bool& walking) {
  int req = -1;
  while (walking && req < 0) {
    if (sp == 0) {
      walking = false;
    } else {
      --sp;
      int node = stack[sp];
      if (!(entry[sp] > best_t)) {  // else beyond the best: culled
        if (node >= first_leaf) {
          req = node - first_leaf;
        } else {
          int first = sp;
          int child0 = node * branching + 1;
          for (int k = 0; k < branching; ++k) {
            float tn;
            if (bvh_slab(lo, hi, child0 + k, ray, best_t, &tn))
              push_sorted(stack, entry, sp, first, child0 + k, tn);
          }
        }
      }
    }
  }
  __syncwarp();
  return req;
}

// next_leaf_closest for the whole warp, one walking lane after another
// (branching <= 32): lane m pops; the B children of an internal node are
// slab-tested by lanes 0 .. B-1 against lane m's ray and bound, and lane m
// pushes the hit ones in index order as next_leaf_closest does, so its
// stack is the same.  Ends when no walking lane is without a request.
// Called by all 32 lanes.
__device__ __forceinline__ int next_leaf_closest_coop(
    const float* __restrict__ lo, const float* __restrict__ hi,
    const float4* rays, float best_t, int branching, int first_leaf,
    int (&stack)[kMaxStack], float (&entry)[kMaxStack], int& sp,
    bool& walking, int lane) {
  int req = -1;
  while (true) {
    unsigned need = __ballot_sync(kFull, walking && req < 0);
    if (!need) break;
    int m = __ffs(need) - 1;
    int node = -1;  // lane m's internal node to expand, else -1
    if (lane == m) {
      if (sp == 0) {
        walking = false;
      } else {
        --sp;
        if (!(entry[sp] > best_t)) node = stack[sp];  // else culled
        if (node >= first_leaf) {
          req = node - first_leaf;
          node = -1;
        }
      }
    }
    node = __shfl_sync(kFull, node, m);
    if (node >= 0) {
      float bound = __shfl_sync(kFull, best_t, m);
      int child0 = node * branching + 1;
      float tn = 0.0f;
      bool hit = lane < branching && bvh_slab(lo, hi, child0 + lane,
                                              shared_ray(rays, m), bound,
                                              &tn);
      int first = sp;  // lane m's
      for (unsigned h = __ballot_sync(kFull, hit); h; h &= h - 1) {
        int k = __ffs(h) - 1;
        float tk = __shfl_sync(kFull, tn, k);
        if (lane == m) push_sorted(stack, entry, sp, first, child0 + k, tk);
      }
    }
  }
  return req;
}

// One round of a lane's any walk: depth first, the slab-hit children (bound
// max_t) pushed in index order, until it pops a leaf (its cluster) or the
// stack is empty (`walking` cleared; -1).  One exit, as next_leaf_closest.
__device__ __forceinline__ int next_leaf_any(
    const float* __restrict__ lo, const float* __restrict__ hi,
    const Ray& ray, float max_t, int branching, int first_leaf,
    int (&stack)[kMaxStack], int& sp, bool& walking) {
  int req = -1;
  while (walking && req < 0) {
    if (sp == 0) {
      walking = false;
    } else {
      int node = stack[--sp];
      if (node >= first_leaf) {
        req = node - first_leaf;
      } else {
        int child0 = node * branching + 1;
        for (int k = 0; k < branching; ++k) {
          float tn;
          if (bvh_slab(lo, hi, child0 + k, ray, max_t, &tn))
            stack[sp++] = child0 + k;
        }
      }
    }
  }
  __syncwarp();
  return req;
}

// next_leaf_any for the whole warp, one walking lane after another, as
// next_leaf_closest_coop (max_t from the rays in shared memory).  Called by
// all 32 lanes.
__device__ __forceinline__ int next_leaf_any_coop(
    const float* __restrict__ lo, const float* __restrict__ hi,
    const float4* rays, int branching, int first_leaf,
    int (&stack)[kMaxStack], int& sp, bool& walking, int lane) {
  int req = -1;
  while (true) {
    unsigned need = __ballot_sync(kFull, walking && req < 0);
    if (!need) break;
    int m = __ffs(need) - 1;
    int node = -1;
    if (lane == m) {
      if (sp == 0) {
        walking = false;
      } else {
        node = stack[--sp];
        if (node >= first_leaf) {
          req = node - first_leaf;
          node = -1;
        }
      }
    }
    node = __shfl_sync(kFull, node, m);
    if (node >= 0) {
      int child0 = node * branching + 1;
      float tn;
      bool hit = lane < branching && bvh_slab(lo, hi, child0 + lane,
                                              shared_ray(rays, m),
                                              rays[3 * m + 1].z, &tn);
      unsigned hits = __ballot_sync(kFull, hit);
      if (lane == m)
        for (unsigned h = hits; h; h &= h - 1)
          stack[sp++] = child0 + __ffs(h) - 1;
    }
  }
  return req;
}

// Whether the warp shares this round's node expansions.  Called by all 32
// lanes.
__device__ __forceinline__ bool coop_round(bool walking, int branching) {
  return branching <= 32 && __popc(__ballot_sync(kFull, walking)) <= kCoopMax;
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
                       int first_leaf, int c_size, int g_base, int n_global,
                       float* __restrict__ t_out,
                       float* __restrict__ u_out, float* __restrict__ v_out,
                       int* __restrict__ tri_out) {
  __shared__ float4 s_ray[3 * kThreads];
  const int lane = threadIdx.x & 31;
  const float4* rays = s_ray + 3 * (threadIdx.x - lane);  // this warp's
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool inside = r < n;
  const bool live = inside && mask[r];
  Ray ray = {};
  if (live) ray = load_ray(o, d, r);
  store_ray(s_ray, ray, kBigT);

  // the global set, one group of every live lane
  int best_bits, best_tri;
  serve_closest_mt(v0, e1, e2, g_base, n_global, __ballot_sync(kFull, live),
                   rays, lane, &best_bits, &best_tri);
  if (!(best_bits < __float_as_int(kBigT))) {  // no hit below kBigT
    best_bits = __float_as_int(kBigT);
    best_tri = -1;
  }
  int stack[kMaxStack];
  float entry[kMaxStack];
  stack[0] = 0;  // the root (leaf 0 when levels == 0)
  entry[0] = -kBigT;
  int sp = 1;
  bool walking = live;
  while (true) {
    float best_t = __int_as_float(best_bits);
    int req = coop_round(walking, branching)
                  ? next_leaf_closest_coop(lo, hi, rays, best_t, branching,
                                           first_leaf, stack, entry, sp,
                                           walking, lane)
                  : next_leaf_closest(lo, hi, ray, best_t, branching,
                                      first_leaf, stack, entry, sp, walking);
    unsigned pending = __ballot_sync(kFull, req >= 0);
    if (!pending) break;
    while (pending) {
      int c = __shfl_sync(kFull, req, __ffs(pending) - 1);
      unsigned group = __ballot_sync(kFull, req == c);
      pending &= ~group;
      int bits, slot;
      serve_closest_mt(v0, e1, e2, c * c_size, c_size, group, rays, lane,
                       &bits, &slot);
      if (req == c && bits < best_bits) {
        best_bits = bits;
        best_tri = slot;
      }
    }
  }
  if (inside) {
    float t = __int_as_float(best_bits), u = 0.0f, v = 0.0f;
    if (best_tri >= 0) {  // the winner's barycentrics, recomputed
      float tt;
      mt_hit(load_tri(v0, e1, e2, best_tri, true), ray.ox, ray.oy, ray.oz,
             ray.dx, ray.dy, ray.dz, kBigT, &tt, &u, &v);
    }
    t_out[r] = t;
    u_out[r] = u;
    v_out[r] = v;
    tri_out[r] = best_tri;
  }
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
                   int first_leaf, int c_size, int g_base, int n_global,
                   bool* __restrict__ occ_out) {
  __shared__ float4 s_ray[3 * kThreads];
  const int lane = threadIdx.x & 31;
  const float4* rays = s_ray + 3 * (threadIdx.x - lane);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool inside = r < n;
  const bool live = inside && mask[r];
  Ray ray = {};
  float tmax = 0.0f;
  if (live) {
    ray = load_ray(o, d, r);
    tmax = max_t[r];
  }
  store_ray(s_ray, ray, tmax);
  unsigned hit_by = serve_any_mt(v0, e1, e2, g_base, n_global,
                                 __ballot_sync(kFull, live), rays, lane);
  bool occ = (hit_by >> lane) & 1u;
  int stack[kMaxStack];
  stack[0] = 0;  // the root (leaf 0 when levels == 0)
  int sp = 1;
  bool walking = live && !occ;
  while (true) {
    int req = coop_round(walking, branching)
                  ? next_leaf_any_coop(lo, hi, rays, branching, first_leaf,
                                       stack, sp, walking, lane)
                  : next_leaf_any(lo, hi, ray, tmax, branching, first_leaf,
                                  stack, sp, walking);
    unsigned pending = __ballot_sync(kFull, req >= 0);
    if (!pending) break;
    while (pending) {
      int c = __shfl_sync(kFull, req, __ffs(pending) - 1);
      unsigned group = __ballot_sync(kFull, req == c);
      pending &= ~group;
      hit_by = serve_any_mt(v0, e1, e2, c * c_size, c_size, group, rays,
                            lane);
      occ = occ || ((hit_by >> lane) & 1u);
    }
    walking = walking && !occ;  // an occluded ray has left the walk
  }
  if (inside) occ_out[r] = occ;
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
      (const float*)hi, n, branching, first_leaf, c_size, g_base, n_global,
      (float*)t_out, (float*)u_out, (float*)v_out, (int*)tri_out);
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
      first_leaf, c_size, g_base, n_global, (bool*)occ_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
