// Flat cluster traversal for Hopper (sm_90a): closest hit and any hit over
// <= 128 clusters, a one-level walk per lane with a leaf test that the 32
// lanes of a warp share.
//
// closest_flat_kernel replaces the TPU kernel _closest_flat_kernel and
// any_flat_kernel replaces _any_flat_kernel
// (metal_raytracing_tpu/ops/trace_pallas.py, trace_closest / trace_any on
// scenes with <= 128 padded clusters).  The TPU kernels walk a block of
// 128-512 rays together: one (clusters x rays) slab test per block, then an
// extract-min over clusters whose dense test runs on every ray of the block.
//
// What bounds the walk on an H100: as for the hierarchical kernels
// (trace_hier.cu).  A visit is 384 slots of ~55 instructions (IEEE
// reciprocal, no fused multiply-add) over twelve plane rows; with one
// thread per ray a warp runs as long as its slowest lane and each lane
// reads its own 384 x 12 plane values.  The planes stay in the 50 MB L2
// (at most 128 x 384 x 12 floats, 2.4 MB; coatball 0.7 MB), so the limits
// are instructions, the loads a warp can start, and the spread of visits
// inside a warp, not HBM bytes.
//
// What the design does about it: trace_hier.cu's, on a walk of one level.
//
//   * Each lane keeps its ray, its best key and base (closest) or its flag
//     (any), and a 128-bit visited mask in registers.  A lane's step is
//     pick_box over all ncp cluster boxes (in shared memory, <= 3 KB):
//     the nearest unvisited box whose slab entry lies strictly below the
//     chopped best (closest) or that the ray enters within max_t (any).  So
//     every ray visits exactly the clusters the one-thread-per-ray walk
//     visited for it.
//   * With at most kCoopMax walking lanes the warp picks for one picking
//     lane at a time through coop_pick (lane l tests boxes l, l + 32, ...),
//     since a lane's own pick tests every box in a loop that the round
//     waits for.
//   * The warp serves the round's requests group by group (the lanes that
//     asked for the same cluster) through serve_closest / serve_any
//     (trace_warp.cuh): 64 slots a step, two a lane, the minimum key back
//     to the owner by __reduce_min_sync, an occluder by __any_sync.  A
//     warp's time is the sum of its lanes' visits over 32, not their
//     maximum.
//   * The any-hit kernel first tests the global set's real slots (not the
//     128-slot padding of the TPU kernel's lane layout, whose zero planes
//     are never hit), each lane against its own ray: a scene has a handful
//     (coatball 4), and the shared leaf test would spend a warp step of 64
//     slots on one ray for them (measured 4-15% slower a pass).  Then it
//     walks the unoccluded lanes, each leaving at its first occluder.
//   * All lanes stay to the end; every loop that diverges between lanes has
//     one exit and walk state changes only at the top of a round, so that
//     all lanes reach the same vote instruction (trace_hier.cu).
//   * Min of packed keys and OR of flags do not depend on the order of the
//     slots, and a key replaces the best only when strictly smaller, so the
//     results are those of the one-thread-per-ray walk and of the plain
//     versions, bit for bit.
//
// Static shared memory: the boxes (3 KB) and the block's rays (6 KB).
// Tensor cores do not apply (trace_hier.cu).  Numerics and the packed key:
// see trace_common.cuh.  The TPU kernels' `counts` and `count_visits`
// options are nullable pointers, as in trace_hier.cu: `counts` ends a
// cluster's leaf test at its last real slot, `visits` receives the clusters
// each ray dense-tested (the global test is not a visit).

#include "trace_warp.cuh"

namespace {

using namespace mrt;

constexpr int kThreads = 128;
constexpr int kMaxClusters = 128;
// The warp shares the box picks when at most this many lanes still walk.
constexpr int kCoopMax = 16;

// One step of a lane's walk: the next cluster to dense-test, or -1 when the
// walk has ended (`walking` cleared).
__device__ __forceinline__ int next_box(const float* s_box, int ncp,
                                        const Ray& ray, float t_max,
                                        float bound, unsigned (&vis)[4],
                                        bool& walking) {
  int req = -1;
  if (walking) {
    int k = pick_box(s_box, ncp, ray, t_max, bound, vis);
    if (k < 0) {
      walking = false;
    } else {
      mark(vis, k);
      req = k;
    }
  }
  __syncwarp();
  return req;
}

// next_box for the whole warp, one walking lane after another: lane m's
// bounds and visited mask come by shuffle, its pick by coop_pick, and only
// lane m updates its state.  Called by all 32 lanes.
__device__ __forceinline__ int next_box_coop(const float* s_box, int ncp,
                                             const float4* rays,
                                             float my_tmax, float my_bound,
                                             unsigned (&vis)[4],
                                             bool& walking, int lane) {
  int req = -1;
  while (true) {
    unsigned need = __ballot_sync(kFull, walking && req < 0);
    if (!need) break;
    int m = __ffs(need) - 1;
    float tm = __shfl_sync(kFull, my_tmax, m);
    float bd = __shfl_sync(kFull, my_bound, m);
    unsigned v[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) v[w] = __shfl_sync(kFull, vis[w], m);
    int pick = coop_pick(s_box, ncp, rays, m, tm, bd, v, lane);
    if (lane == m) {
      if (pick < 0) {
        walking = false;
      } else {
        mark(vis, pick);
        req = pick;
      }
    }
  }
  return req;
}

// Closest hit (replaces _closest_flat_kernel, trace_pallas.py:1848).
// Starts from the host seed key (the global set's best hit) with base
// g_base; each round every walking lane picks the nearest unvisited cluster
// whose entry lies below t(best key), and the warp serves the requests; a
// cluster's key replaces the best only when strictly smaller.  Writes the
// best key's chopped t and its slot (-1 on a miss).  `counts` and `visits`
// may be null.
__global__ void __launch_bounds__(kThreads)
closest_flat_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const unsigned char* __restrict__ mask,
                    const int* __restrict__ seed,
                    const float* __restrict__ clu,
                    const float* __restrict__ tri, int n, int ncp,
                    int c_size, int T, int g_base,
                    const int* __restrict__ counts, float* __restrict__ t_out,
                    int* __restrict__ tri_out, int* __restrict__ visits) {
  __shared__ float s_box[kMaxClusters * 6];
  __shared__ float4 s_ray[3 * kThreads];
  load_shared(clu, ncp * 6, s_box);
  const int lane = threadIdx.x & 31;
  const float4* rays = s_ray + 3 * (threadIdx.x - lane);  // this warp's
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool inside = r < n;

  int key = inside && seed ? seed[r] : init_key();
  int base = g_base;
  bool walking = inside && mask[r];
  Ray ray = {};
  if (walking) ray = load_ray(o, d, r);
  store_ray(s_ray, ray, kBigT);
  unsigned vis[4] = {0u, 0u, 0u, 0u};
  int nvis = 0;
  while (true) {
    int req = __popc(__ballot_sync(kFull, walking)) <= kCoopMax
                  ? next_box_coop(s_box, ncp, rays, kBigT, key_to_t(key), vis,
                                  walking, lane)
                  : next_box(s_box, ncp, ray, kBigT, key_to_t(key), vis,
                             walking);
    unsigned pending = __ballot_sync(kFull, req >= 0);
    if (!pending) break;
    nvis += req >= 0;
    while (pending) {
      int c = __shfl_sync(kFull, req, __ffs(pending) - 1);
      unsigned group = __ballot_sync(kFull, req == c);
      pending &= ~group;
      int cbase = c * c_size;
      int count = counts ? __ldg(counts + c) : c_size;
      int vkey = serve_closest(tri, T, cbase, count, group, rays, lane);
      if (req == c && vkey < key) {
        key = vkey;
        base = cbase;
      }
    }
  }
  if (inside) {
    t_out[r] = key_to_t(key);
    tri_out[r] = key < miss_key() ? base + (key & kIdxMask) : -1;
    if (visits) visits[r] = nvis;
  }
}

// Any hit (replaces _any_flat_kernel, trace_pallas.py:1957) over the ray
// segment (1e-6, max_t]: the g_slots real global slots first, each lane its
// own ray, in a loop with one exit; then the walk in entry order with the
// max_t slab bound, each ray leaving at its first occluder.  `counts` and
// `visits` as closest_flat_kernel.
__global__ void __launch_bounds__(kThreads)
any_flat_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ max_t,
                const unsigned char* __restrict__ mask,
                const float* __restrict__ clu,
                const float* __restrict__ tri, int n, int ncp, int c_size,
                int T, int g_base, int g_slots,
                const int* __restrict__ counts, bool* __restrict__ occ_out,
                int* __restrict__ visits) {
  __shared__ float s_box[kMaxClusters * 6];
  __shared__ float4 s_ray[3 * kThreads];
  load_shared(clu, ncp * 6, s_box);
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
  bool occ = false;
  if (live) {
    for (int j = 0; j < g_slots && !occ; ++j) {
      float t;
      occ = tri_hit(tri, T, g_base + j, ray, &t) && t <= tmax;
    }
  }
  __syncwarp();
  bool walking = live && !occ;
  unsigned vis[4] = {0u, 0u, 0u, 0u};
  int nvis = 0;
  while (true) {
    walking = walking && !occ;  // an occluded ray has left the walk
    int req = __popc(__ballot_sync(kFull, walking)) <= kCoopMax
                  ? next_box_coop(s_box, ncp, rays, tmax, kBigT, vis, walking,
                                  lane)
                  : next_box(s_box, ncp, ray, tmax, kBigT, vis, walking);
    unsigned pending = __ballot_sync(kFull, req >= 0);
    if (!pending) break;
    nvis += req >= 0;
    while (pending) {
      int c = __shfl_sync(kFull, req, __ffs(pending) - 1);
      unsigned group = __ballot_sync(kFull, req == c);
      pending &= ~group;
      int count = counts ? __ldg(counts + c) : c_size;
      unsigned hit_by = serve_any(tri, T, c * c_size, count, group, rays,
                                  lane);
      occ = occ || ((hit_by >> lane) & 1u);
    }
  }
  if (inside) {
    occ_out[r] = occ;
    if (visits) visits[r] = nvis;
  }
}

}  // namespace

extern "C" {

// Plain C entry points for ctypes.  `clu` holds the ncp cluster boxes
// (ncp, 6); `seed` may be null (no seed); `g_slots` is the number of real
// global slots from g_base on; `counts` (i32 per cluster slot) and `visits`
// (i32 per ray, written) may be null.  Each launches on the given stream,
// allocates nothing, and returns cudaGetLastError() of its launch.

int launch_closest_flat(const void* o, const void* d, const void* mask,
                        const void* seed, const void* clu, const void* tri,
                        int n, int ncp, int c_size, int T, int g_base,
                        const void* counts, void* t_out, void* tri_out,
                        void* visits, void* stream) {
  if (ncp > kMaxClusters) return (int)cudaErrorInvalidValue;
  int blocks = (n + kThreads - 1) / kThreads;
  closest_flat_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const unsigned char*)mask,
      (const int*)seed, (const float*)clu, (const float*)tri, n, ncp, c_size,
      T, g_base, (const int*)counts, (float*)t_out, (int*)tri_out,
      (int*)visits);
  return (int)cudaGetLastError();
}

int launch_any_flat(const void* o, const void* d, const void* max_t,
                    const void* mask, const void* clu, const void* tri, int n,
                    int ncp, int c_size, int T, int g_base, int g_slots,
                    const void* counts, void* occ_out, void* visits,
                    void* stream) {
  if (ncp > kMaxClusters) return (int)cudaErrorInvalidValue;
  int blocks = (n + kThreads - 1) / kThreads;
  any_flat_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const float*)max_t,
      (const unsigned char*)mask, (const float*)clu, (const float*)tri, n,
      ncp, c_size, T, g_base, g_slots, (const int*)counts, (bool*)occ_out,
      (int*)visits);
  return (int)cudaGetLastError();
}

const char* kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
