// Rank-directed closest walk for Hopper (sm_90a), with a leaf test that the
// 32 lanes of a warp share.
//
// closest_rank_kernel replaces the TPU kernel _rank_closest_kernel
// (metal_raytracing_tpu/ops/trace_pallas.py, launched by
// trace_closest_rank).  Each ray arrives with its K nearest candidate
// clusters as packed (bits(t_entry) & ~0xFFF) | cluster id keys from the
// exact broad phase, rank 1 first, and with the host seed key (the global
// set's best hit).  The kernel tests only those clusters: no super level,
// no slab test.  Its caller certifies each ray against the rank-(K+1) entry
// and sends the rest to closest_hier_kernel, seeded with this kernel's key
// and base.
//
// The TPU kernel works on a tile of 128 rays: it takes the minimum pending
// key of the whole tile, dense-tests that cluster against every lane, and
// retires it, so a lane also sees clusters that only its neighbours asked
// for.  Here each ray walks only its own K candidates in rank order (they
// come sorted by entry), skipping one whose chopped entry is not below the
// chopped best so far.  On a ray that the certificate accepts both give the
// minimum packed key over every cluster that could hold it; on other rays
// the TPU lane's key can be smaller, and the fallback settles those.
//
// What bounds it on an H100: instruction issue for the 384 plane tests of
// a visit (~55 instructions each: IEEE reciprocal, no fused multiply-add)
// and the loads of twelve plane rows a slot; the plane table stays in the
// 50 MB L2 (dragon: 6.3 MB).  With one thread per ray a warp runs as long
// as its slowest lane, lanes whose candidate was culled sit idle, and
// lanes that stand in different clusters each read their own 32-byte
// sectors.
//
// What the design does about it: trace_hier.cu's leaf path without the
// picks.  Each lane keeps its ray (in shared memory, for the warp to read as
// a broadcast), its key and base, and the index of its next rank.  At the
// top of a round every lane exposes its next surviving candidate (not the
// sentinel, and entry below its chopped best); the warp groups the lanes by
// requested cluster and serves each group through serve_closest
// (trace_warp.cuh: 64 slots a step, two a lane, coalesced row reads, the
// minimum key back to its owner by __reduce_min_sync); a served lane takes
// the key only when strictly smaller.  A warp's time is the sum of its
// lanes' visits over 32, not their maximum; the compaction sort puts rays
// with the same rank-1 and rank-2 clusters next to each other, so most
// groups are large.  A lane sees its own candidates in its own rank order
// with the same culls, so key and base equal the one-thread-per-ray walk
// and the plain versions bit for bit.  As in trace_hier.cu, all lanes stay
// to the end, the divergent loop has one exit, and a lane's walk state
// changes only at the top of a round.
//
// Serving each popped cluster to every live lane, the TPU tile's rule on 32
// rays, was measured: 1.7-3.2x slower, and it certifies no more rays, since
// a hit from a cluster outside a ray's K candidates lies beyond its
// rank-(K+1) entry (PERF.md).
//
// The TPU kernel's `counts` and `count_visits` options are nullable
// pointers, as in trace_hier.cu: `counts` ends a cluster's leaf test at its
// last real slot, `visits` receives the clusters each ray dense-tested.
//
// Numerics and the packed key: see trace_common.cuh.

#include "trace_warp.cuh"

namespace {

using namespace mrt;

constexpr int kThreads = 128;
constexpr int kNcIdMask = 0xFFF;  // cluster-id bits of a broad-phase key

__device__ __forceinline__ int nc_sentinel() {
  return (__float_as_int(kBigT) & ~kNcIdMask) | kNcIdMask;
}

// keys: (ranks, n) packed candidate keys, rank 1 first.  seed may be null:
// then a ray starts from the init key with base 0, as the TPU kernel; with
// a seed its base is g_base.  A masked-off ray writes its start values.
// `counts` and `visits` may be null.
__global__ void __launch_bounds__(kThreads)
closest_rank_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const unsigned char* __restrict__ mask,
                    const int* __restrict__ seed,
                    const int* __restrict__ keys,
                    const float* __restrict__ tri, int n, int ranks,
                    int c_size, int T, int g_base,
                    const int* __restrict__ counts,
                    int* __restrict__ key_out, int* __restrict__ base_out,
                    int* __restrict__ visits) {
  __shared__ float4 s_ray[3 * kThreads];
  const int lane = threadIdx.x & 31;
  const float4* rays = s_ray + 3 * (threadIdx.x - lane);  // this warp's
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool inside = r < n;

  int key = inside && seed ? seed[r] : init_key();
  int base = seed ? g_base : 0;
  const bool live = inside && mask[r];
  Ray ray = {};
  if (live) ray = load_ray(o, d, r);
  store_ray(s_ray, ray, kBigT);
  int k = 0;  // the lane's next rank
  int nvis = 0;
  while (true) {
    // the lane's next candidate that can still give a smaller key: a hit
    // inside the box has t >= entry >= chopped entry, so a candidate whose
    // chopped entry is not below the chopped best cannot
    int req = -1;
    while (live && req < 0 && k < ranks) {
      int pk = keys[(size_t)k * n + r];
      ++k;
      if (pk != nc_sentinel() &&
          __int_as_float(pk & ~kNcIdMask) < key_to_t(key))
        req = pk & kNcIdMask;
    }
    __syncwarp();
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
    key_out[r] = key;
    base_out[r] = base;
    if (visits) visits[r] = nvis;
  }
}

}  // namespace

extern "C" {

// Plain C entry point for ctypes.  `keys` is (ranks, n) int32, `seed` (n,)
// int32 or null; `counts` (i32 per cluster slot) and `visits` (i32 per ray,
// written) may be null.  Launches on the given stream, allocates nothing,
// and returns the launch's cudaGetLastError().  Cluster ids are not checked
// against T here: the wrapper checks the tables.
int launch_closest_rank(const void* o, const void* d, const void* mask,
                        const void* seed, const void* keys, const void* tri,
                        int n, int ranks, int c_size, int T, int g_base,
                        const void* counts, void* key_out, void* base_out,
                        void* visits, void* stream) {
  if (ranks < 1 || c_size < 1) return (int)cudaErrorInvalidValue;
  int blocks = (n + kThreads - 1) / kThreads;
  closest_rank_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)o, (const float*)d, (const unsigned char*)mask,
      (const int*)seed, (const int*)keys, (const float*)tri, n, ranks,
      c_size, T, g_base, (const int*)counts, (int*)key_out, (int*)base_out,
      (int*)visits);
  return (int)cudaGetLastError();
}

}  // extern "C"
