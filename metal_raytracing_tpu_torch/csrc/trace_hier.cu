// Hierarchical cluster traversal for Hopper (sm_90a): closest hit and any
// hit over a two-level tree of <= 128 supers of S clusters each, with a leaf
// test that the 32 lanes of a warp share.
//
// closest_hier_kernel replaces the TPU kernel _closest_kernel and
// any_hier_kernel replaces _any_kernel
// (metal_raytracing_tpu/ops/trace_pallas.py, trace_closest / trace_any on
// scenes with more than 128 padded clusters, launched through
// _pallas_trace).  The TPU kernels walk a block of 128-512 rays over the
// union of their supers, then of each super's clusters, by extract-min over
// (boxes x rays) score tiles, and dense-test every popped cluster against
// the whole block.
//
// What bounds the walk on an H100.  A ray dense-tests few clusters (dragon
// 1024x1024: under one a ray on average, up to 15 for a grazing ray), but
// a cluster is 384 slots of ~55 instructions each (IEEE reciprocal, no
// fused multiply-add) over twelve plane rows of stride T.  With one thread
// per ray a warp runs as long as its slowest lane, 31 lanes waiting, and
// each of a lane's 4,608 plane loads a visit touches its own 32-byte sector
// when the lanes stand in different clusters.  The planes stay in the 50 MB
// L2 (dragon: 6.3 MB), so the limits are the instructions and loads a warp
// can start a cycle and the spread of visits inside a warp, not HBM bytes.
//
// What the design does about it.
//
//   * Each lane keeps its own ray and its own two-level walk in registers:
//     the nearest unvisited super whose slab entry is strictly below the
//     chopped best, inside it the nearest unvisited cluster below the best,
//     until the super's clusters drain (a super is never re-entered); super
//     visits in a 128-bit mask.  Inside a super the bound only falls, so the
//     picks come in strictly increasing (entry, index) order, and the
//     unvisited slab-hit clusters below the bound are exactly those after
//     the last pick in that order: in place of a visited mask a lane keeps
//     the last pick's (entry bits, index), two registers for any S, and
//     picks the nearest cluster after it.  So every ray visits exactly the
//     clusters the one-thread-per-ray walk visits for it, in the same order.
//   * Wide supers (S > 32: builders that make many small clusters, dragon's
//     ploc build 232 a super) walk the same way; only their cluster boxes
//     (dragon ploc: 28,964 x 24 B) no longer fit shared memory and are read
//     from device memory (they stay in L2).  The super boxes stay in shared
//     memory.
//   * The warp serves the lanes' cluster requests together.  In each round
//     every walking lane advances to its next cluster; lanes that asked for
//     the same cluster form a group (ballot on the leader's request).  For
//     one group the warp walks the cluster in steps of 64 slots: lane l
//     holds slots 64c + l and 64c + 32 + l (twenty-four coalesced 128-byte
//     row reads), and for each ray of the group (read from shared memory as
//     a broadcast) every lane tests its two slots; the minimum key goes
//     back to the owner by __reduce_min_sync (hit keys are positive ints),
//     an occluder by __any_sync.  A visit costs the warp cluster_size / 64
//     steps for each ray of the group, whatever the other lanes do: a
//     warp's time is the sum of its lanes' visits over 32, not their
//     maximum, and the plane loads a visit fall from 4,608 scattered to 144
//     coalesced a lane, shared by the group.  (One slot a lane with the
//     next chunk prefetched was 10-18% slower, three or four slots a lane
//     cost registers: PERF.md.)
//   * The box picks are shared too when few lanes still walk.  A lane's own
//     pick slab-tests every super (dragon: 43) or its super's clusters (8)
//     in a divergent loop, and a round waits for the slowest lane's picks;
//     with at most kCoopMax walking lanes the warp serves them one after
//     another instead, lane l testing boxes l, l + 32, ... of the picking
//     ray and the nearest going back by two __reduce_min_sync (entry bits,
//     then the lowest index among equals: the same tie rule).  Measured on
//     dragon 1024x1024, 16 beat 2, 4, 8 and 32 on the sum of the main
//     path's passes (PERF.md).
//   * All lanes stay to the end: out-of-range and masked lanes request
//     nothing but take part in every warp-wide step, and the loops end on
//     warp-uniform conditions.  Every loop that diverges between lanes has
//     one exit, and a lane's walk state changes only at the top of a round,
//     so that all lanes reach the same vote instruction.
//   * The minimum of packed keys and the OR of occlusion do not depend on
//     the order of the slots, and a cluster's key still replaces the best
//     only when strictly smaller, so the results are those of the
//     one-thread-per-ray walk and of the plain versions, bit for bit.
//
// Tensor cores (wgmma) do not apply: the plane test is dot products of
// depth 3 in float32 whose 512-ulp packed key decides ties, and TF32 inputs
// would move those keys.  Staging a cluster's twelve rows in shared memory
// with cp.async.bulk and an mbarrier, two buffers a warp, was built and
// measured: bit-equal and 1.4-3.4x slower on every pass, since 36.9 KB a
// warp leaves four warps an SM where the register version keeps 32, whose
// loads the other warps' plane tests cover (PERF.md); it is not here.
//
// The super boxes and, for S <= 32, all cluster boxes sit in shared memory
// (dragon: 43 x 24 B plus 344 x 24 B, 9.3 KB; at most 128 x 24 B plus 4096
// x 24 B) beside the block's rays (48 B a thread).
//
// Options of the TPU kernels (their `counts` and `count_visits`), each a
// nullable pointer: `counts` (i32 per cluster slot) stops a cluster's leaf
// test at its last real slot, which skips the 64-slot steps of a partly
// full cluster that hold only padding (zero planes that never hit: the same
// result); `visits` (i32 per ray) receives the clusters each ray
// dense-tested, where the TPU kernel counts per 128-ray tile.  Pair visits
// are not here.
//
// The baked-origin closest walk (the TPU kernel's baked=True,
// trace_pallas.py:1139-1150, the primary pass of RenderConfig.bake_primary):
// every ray leaves the camera, whose position trace_cuda.bake_origin has
// moved into the tables (boxes shifted by -origin, the plane constants
// absorbing n.o, U.o and V.o).  The kernel reads only the directions, and
// every slab and plane test drops its origin terms (trace_common.cuh): of a
// plane test's 34 multiplies, adds and subtracts 9 fewer, of a slab test's
// 12 the 6 subtractions.  It is closest_hier_kernel's second template flag,
// so the walk, the seed, the options and the order state are the same code
// as the unbaked pass's, whose instantiation does not change.
//
// Numerics and the packed key: see trace_common.cuh.  The rays in shared
// memory, the shared picks (coop_pick, coop_pick_after) and the shared leaf
// test (serve_closest, serve_any) are in trace_warp.cuh, which the flat
// kernels of trace_flat.cu use too.

#include "trace_warp.cuh"

namespace {

using namespace mrt;

constexpr int kThreads = 128;
constexpr int kMaxSupers = 128;
constexpr int kMaxSharedPerSuper = 32;  // cluster boxes in shared memory
constexpr int kMaxPerSuper = 4096;
// The warp shares the box picks when at most this many lanes still walk.
constexpr int kCoopMax = 16;

// A lane's visited state among its current super's clusters: the (entry
// bits, index) of its last pick there (see the note at the top).
struct CVis {
  int bits, idx;
};

__device__ __forceinline__ void reset(CVis& v) {
  v.bits = -1;  // below every entry's bits
  v.idx = -1;
}

// The lane's own pick among the super's `count` cluster boxes: the nearest
// after its last pick whose entry lies below the bound; records it.
// kBaked (here and below): the baked-origin tests.
template <bool kBaked = false>
__device__ __forceinline__ int pick_cluster(const float* boxes, int count,
                                            const Ray& ray, float t_max,
                                            float bound, CVis& v) {
  int best = -1, best_bits = 0;
  float best_tn = bound;
  for (int k = 0; k < count; ++k) {
    float tn;
    if (slab<kBaked>(boxes + 6 * k, ray, t_max, &tn)) {
      int bits = __float_as_int(tn + 0.0f);
      if ((bits > v.bits || (bits == v.bits && k > v.idx)) && tn < best_tn) {
        best_tn = tn;
        best = k;
        best_bits = bits;
      }
    }
  }
  if (best >= 0) {
    v.bits = best_bits;
    v.idx = best;
  }
  return best;
}

// The warp's pick for lane m among its super's cluster boxes; lane m
// records it.  Called by all 32 lanes.
template <bool kBaked = false>
__device__ __forceinline__ int coop_pick_cluster(const float* boxes,
                                                 int count,
                                                 const float4* rays, int m,
                                                 float tm, float bd, CVis& v,
                                                 int lane) {
  int a_bits = __shfl_sync(kFull, v.bits, m);
  int a_idx = __shfl_sync(kFull, v.idx, m);
  int bits;
  int pick = coop_pick_after<kBaked>(boxes, count, rays, m, tm, bd, a_bits,
                                     a_idx, lane, &bits);
  if (lane == m && pick >= 0) {
    v.bits = bits;
    v.idx = pick;
  }
  return pick;
}

// One step of a lane's two-level walk: the next cluster to dense-test, or
// -1 when the walk has ended (`walking` cleared).  `s` is the lane's
// current super (-1: none), `svis` / `cvis` its visited state; `clu` the
// cluster boxes (shared memory, or device memory for wide supers).  The
// loop diverges between lanes and the warp votes right after it, so it has
// one exit and no return inside: every lane must reach the same vote
// instruction, and a loop with several exits let the compiler send lanes to
// different copies of it (seen on the card as missed occluders).
template <bool kBaked = false>
__device__ __forceinline__ int next_cluster(const float* s_sup,
                                            const float* clu, int n_sup,
                                            int s_per, const Ray& ray,
                                            float t_max, float bound, int& s,
                                            unsigned (&svis)[4],
                                            CVis& cvis, bool& walking) {
  int req = -1;
  while (walking && req < 0) {
    if (s < 0) {
      s = pick_box<kBaked>(s_sup, n_sup, ray, t_max, bound, svis);
      if (s < 0) {
        walking = false;
      } else {
        mark(svis, s);
        reset(cvis);
      }
    }
    if (s >= 0) {
      int k = pick_cluster<kBaked>(clu + 6 * s * s_per, s_per, ray, t_max,
                                   bound, cvis);
      if (k >= 0) {
        req = s * s_per + k;
      } else {
        s = -1;  // the super's clusters are drained
      }
    }
  }
  __syncwarp();
  return req;
}

// next_cluster for the whole warp, one picking lane after another: lane m's
// walk state comes by shuffle, its pick by coop_pick, and only lane m
// updates its state.  Ends when no walking lane is without a request.
// Called by all 32 lanes.
template <bool kBaked = false>
__device__ __forceinline__ int next_cluster_coop(
    const float* s_sup, const float* clu, int n_sup, int s_per,
    const float4* rays, float my_tmax, float my_bound, int& s,
    unsigned (&svis)[4], CVis& cvis, bool& walking, int lane) {
  int req = -1;
  while (true) {
    unsigned need = __ballot_sync(kFull, walking && req < 0);
    if (!need) break;
    int m = __ffs(need) - 1;
    int sm = __shfl_sync(kFull, s, m);
    float tm = __shfl_sync(kFull, my_tmax, m);
    float bd = __shfl_sync(kFull, my_bound, m);
    if (sm < 0) {
      unsigned v[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) v[w] = __shfl_sync(kFull, svis[w], m);
      int pick = coop_pick<kBaked>(s_sup, n_sup, rays, m, tm, bd, v, lane);
      if (lane == m) {
        if (pick < 0) {
          walking = false;
        } else {
          s = pick;
          mark(svis, pick);
          reset(cvis);
        }
      }
    } else {
      int pick = coop_pick_cluster<kBaked>(clu + 6 * sm * s_per, s_per, rays,
                                           m, tm, bd, cvis, lane);
      if (lane == m) {
        if (pick >= 0) {
          req = sm * s_per + pick;
        } else {
          s = -1;
        }
      }
    }
  }
  return req;
}

// The kernels' shared memory: the block's rays, the super boxes and, unless
// the supers are wide, every cluster box.  Returns the cluster boxes the
// walk reads.
template <bool kWide>
__device__ __forceinline__ const float* stage_boxes(float4* s_mem,
                                                    const float* sup,
                                                    const float* clu,
                                                    int n_sup, int s_per) {
  float* s_sup = (float*)(s_mem + 3 * kThreads);
  load_shared(sup, n_sup * 6, s_sup);
  if (kWide) return clu;
  float* s_clu = s_sup + n_sup * 6;
  load_shared(clu, n_sup * s_per * 6, s_clu);
  return s_clu;
}

// Closest hit (replaces _closest_kernel, trace_pallas.py:1139).  Starts
// from the host seed key (the global set's best hit) with base g_base, or
// with the ray's own seed_base (the TPU kernel's host_seed_base: the rank
// walk's best key and its cluster base), as the TPU kernel's host-seed path;
// a cluster's key replaces the best only when strictly smaller.  Writes the
// best key's chopped t and its slot (-1 on a miss).  `counts` and `visits`
// may be null; kWide: the cluster boxes are read from device memory.
// kBaked: the baked-origin walk over bake_origin's tables; `o` is not read
// (null).
template <bool kWide, bool kBaked>
__global__ void __launch_bounds__(kThreads)
closest_hier_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const unsigned char* __restrict__ mask,
                    const int* __restrict__ seed,
                    const int* __restrict__ seed_base,
                    const float* __restrict__ sup,
                    const float* __restrict__ clu,
                    const float* __restrict__ tri, int n, int n_sup,
                    int s_per, int c_size, int T, int g_base,
                    const int* __restrict__ counts,
                    float* __restrict__ t_out, int* __restrict__ tri_out,
                    int* __restrict__ visits) {
  extern __shared__ float4 s_mem[];
  float4* s_ray = s_mem;
  const float* s_sup = (const float*)(s_mem + 3 * kThreads);
  const float* cl = stage_boxes<kWide>(s_mem, sup, clu, n_sup, s_per);
  const int lane = threadIdx.x & 31;
  const float4* rays = s_ray + 3 * (threadIdx.x - lane);  // this warp's
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool inside = r < n;

  int key = inside && seed ? seed[r] : init_key();
  int base = inside && seed_base ? seed_base[r] : g_base;
  bool walking = inside && mask[r];
  Ray ray = {};
  if (walking) ray = load_ray<kBaked>(o, d, r);
  store_ray(s_ray, ray, kBigT);
  unsigned svis[4] = {0u, 0u, 0u, 0u};
  CVis cvis;
  reset(cvis);
  int s = -1;
  int nvis = 0;
  while (true) {
    // every walking lane advances to its next cluster, then the warp serves
    // the requests group by group, lowest requesting lane first
    int req = __popc(__ballot_sync(kFull, walking)) <= kCoopMax
                  ? next_cluster_coop<kBaked>(s_sup, cl, n_sup, s_per, rays,
                                              kBigT, key_to_t(key), s, svis,
                                              cvis, walking, lane)
                  : next_cluster<kBaked>(s_sup, cl, n_sup, s_per, ray, kBigT,
                                         key_to_t(key), s, svis, cvis,
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
      int vkey =
          serve_closest<kBaked>(tri, T, cbase, count, group, rays, lane);
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

// Any hit (replaces _any_kernel, trace_pallas.py:1653) over the ray segment
// (1e-6, max_t]: the global slots first, as the TPU kernel does under
// seed_global=False, through the shared leaf test as one group of every
// live lane (not a visit); then the two-level walk in entry order with the
// max_t slab bound, each ray leaving at its first occluder.  `counts`,
// `visits` and kWide as closest_hier_kernel.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
any_hier_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ max_t,
                const unsigned char* __restrict__ mask,
                const float* __restrict__ sup, const float* __restrict__ clu,
                const float* __restrict__ tri, int n, int n_sup, int s_per,
                int c_size, int T, int g_base, int g_slots,
                const int* __restrict__ counts, bool* __restrict__ occ_out,
                int* __restrict__ visits) {
  extern __shared__ float4 s_mem[];
  float4* s_ray = s_mem;
  const float* s_sup = (const float*)(s_mem + 3 * kThreads);
  const float* cl = stage_boxes<kWide>(s_mem, sup, clu, n_sup, s_per);
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
  unsigned hit_by = serve_any(tri, T, g_base, g_slots,
                              __ballot_sync(kFull, live), rays, lane);
  bool occ = (hit_by >> lane) & 1u;
  bool walking = live && !occ;
  unsigned svis[4] = {0u, 0u, 0u, 0u};
  CVis cvis;
  reset(cvis);
  int s = -1;
  int nvis = 0;
  while (true) {
    walking = walking && !occ;  // an occluded ray has left the walk
    int req = __popc(__ballot_sync(kFull, walking)) <= kCoopMax
                  ? next_cluster_coop(s_sup, cl, n_sup, s_per, rays, tmax,
                                      kBigT, s, svis, cvis, walking, lane)
                  : next_cluster(s_sup, cl, n_sup, s_per, ray, tmax, kBigT,
                                 s, svis, cvis, walking);
    unsigned pending = __ballot_sync(kFull, req >= 0);
    if (!pending) break;
    nvis += req >= 0;
    while (pending) {
      int c = __shfl_sync(kFull, req, __ffs(pending) - 1);
      unsigned group = __ballot_sync(kFull, req == c);
      pending &= ~group;
      int count = counts ? __ldg(counts + c) : c_size;
      hit_by = serve_any(tri, T, c * c_size, count, group, rays, lane);
      occ = occ || ((hit_by >> lane) & 1u);
    }
  }
  if (inside) {
    occ_out[r] = occ;
    if (visits) visits[r] = nvis;
  }
}

size_t shared_bytes(int n_sup, int s_per, bool wide) {
  return sizeof(float4) * 3 * kThreads +
         sizeof(float) * 6 * (size_t)n_sup * (1 + (wide ? 0 : s_per));
}

bool bad_layout(int n_sup, int s_per) {
  return n_sup < 1 || n_sup > kMaxSupers || s_per < 1 ||
         s_per > kMaxPerSuper;
}

template <bool kWide, bool kBaked>
int closest_hier(const void* o, const void* d, const void* mask,
                 const void* seed, const void* seed_base, const void* sup,
                 const void* clu, const void* tri, int n, int n_sup,
                 int s_per, int c_size, int T, int g_base,
                 const void* counts, void* t_out, void* tri_out,
                 void* visits, void* stream) {
  size_t smem = shared_bytes(n_sup, s_per, kWide);
  cudaError_t err = allow_shared(closest_hier_kernel<kWide, kBaked>, smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (n + kThreads - 1) / kThreads;
  closest_hier_kernel<kWide, kBaked>
      <<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
          (const float*)o, (const float*)d, (const unsigned char*)mask,
          (const int*)seed, (const int*)seed_base, (const float*)sup,
          (const float*)clu, (const float*)tri, n, n_sup, s_per, c_size, T,
          g_base, (const int*)counts, (float*)t_out, (int*)tri_out,
          (int*)visits);
  return (int)cudaGetLastError();
}

template <bool kWide>
int any_hier(const void* o, const void* d, const void* max_t,
             const void* mask, const void* sup, const void* clu,
             const void* tri, int n, int n_sup, int s_per, int c_size, int T,
             int g_base, int g_slots, const void* counts, void* occ_out,
             void* visits, void* stream) {
  size_t smem = shared_bytes(n_sup, s_per, kWide);
  cudaError_t err = allow_shared(any_hier_kernel<kWide>, smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (n + kThreads - 1) / kThreads;
  any_hier_kernel<kWide>
      <<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
          (const float*)o, (const float*)d, (const float*)max_t,
          (const unsigned char*)mask, (const float*)sup, (const float*)clu,
          (const float*)tri, n, n_sup, s_per, c_size, T, g_base, g_slots,
          (const int*)counts, (bool*)occ_out, (int*)visits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Plain C entry points for ctypes.  `sup` holds the n_sup real super boxes
// (n_sup, 6) and `clu` their clusters (n_sup, s_per, 6); `seed` and
// `seed_base` may be null (no seed; base g_base); `counts` (i32 per cluster
// slot) and `visits` (i32 per ray, written) may be null.  Supers of more
// than kMaxSharedPerSuper clusters take the walk with the cluster boxes in
// device memory.  Each launches on the given stream, allocates nothing, and
// returns the launch's cudaGetLastError().

int launch_closest_hier(const void* o, const void* d, const void* mask,
                        const void* seed, const void* seed_base,
                        const void* sup, const void* clu, const void* tri,
                        int n, int n_sup, int s_per, int c_size, int T,
                        int g_base, const void* counts, void* t_out,
                        void* tri_out, void* visits, void* stream) {
  if (bad_layout(n_sup, s_per)) return (int)cudaErrorInvalidValue;
  auto launch = s_per > kMaxSharedPerSuper ? closest_hier<true, false>
                                           : closest_hier<false, false>;
  return launch(o, d, mask, seed, seed_base, sup, clu, tri, n, n_sup, s_per,
                c_size, T, g_base, counts, t_out, tri_out, visits, stream);
}

// The baked-origin closest walk: `d`, and the tables of bake_origin for the
// rays' shared origin; the rest as launch_closest_hier.
int launch_closest_hier_baked(const void* d, const void* mask,
                              const void* seed, const void* seed_base,
                              const void* sup, const void* clu,
                              const void* tri, int n, int n_sup, int s_per,
                              int c_size, int T, int g_base,
                              const void* counts, void* t_out, void* tri_out,
                              void* visits, void* stream) {
  if (bad_layout(n_sup, s_per)) return (int)cudaErrorInvalidValue;
  auto launch = s_per > kMaxSharedPerSuper ? closest_hier<true, true>
                                           : closest_hier<false, true>;
  return launch(nullptr, d, mask, seed, seed_base, sup, clu, tri, n, n_sup,
                s_per, c_size, T, g_base, counts, t_out, tri_out, visits,
                stream);
}

int launch_any_hier(const void* o, const void* d, const void* max_t,
                    const void* mask, const void* sup, const void* clu,
                    const void* tri, int n, int n_sup, int s_per, int c_size,
                    int T, int g_base, int g_slots, const void* counts,
                    void* occ_out, void* visits, void* stream) {
  if (bad_layout(n_sup, s_per)) return (int)cudaErrorInvalidValue;
  auto launch = s_per > kMaxSharedPerSuper ? any_hier<true> : any_hier<false>;
  return launch(o, d, max_t, mask, sup, clu, tri, n, n_sup, s_per, c_size, T,
                g_base, g_slots, counts, occ_out, visits, stream);
}

}  // extern "C"
